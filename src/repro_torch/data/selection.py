"""Training-batch coreset selection through the ``select`` registry.

A port of ``repro/data/selection.py``.  Each candidate example is a
stimulus column (its pooled-embedding, hidden-state or last-layer
gradient features under the current model), and the batch that most
reduces the posterior variance over a linear probe of that feature space
is Bayesian A-optimal design (paper Cor. 9): ``CoresetObjective``.  Every
algorithm goes through ``core.algorithms.select``; ``algo=`` is a
one-string swap, and a ``(data, model)`` mesh (held by the selector or
passed per call; the trainer's wins) runs the algorithm's distributed
twin, the candidate columns padded to the model axis's multiple and
sharded over it.  On the card the objective's sweeps are kernels 4
(``aopt_gains``) and 5 (``aopt_filter_gains``), on each rank's columns
under a mesh.
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import get_algorithm, select
from repro_torch.core.objectives.coreset import (
    CoresetObjective,
    coreset_features,
)

_UNSET = object()


class BatchSelector:
    """Select ``k`` of a candidate pool with any registry algorithm.

    ``select(embeds, key)`` builds a :class:`CoresetObjective` from the
    (pool, feat) features, on their device, and runs
    ``select(self.algo, obj, k, key, mesh=...)``.  ``mesh`` (held here
    or passed per call, which wins; every rank of it calls with the same
    features and key) pads the candidate axis to the mesh's model-axis
    multiple and runs the distributed twin.  ``feature_mode`` ("embed" |
    "hidden" | "grad") is carried for the training loop, which computes
    the features.

    For ``algo="dash"`` without an explicit ``opt=``, OPT is one TOP-K
    sweep's value times ``opt_margin`` and ``n_samples`` defaults to 4,
    as in the reference.  Extra ``**algo_opts`` pass through to the
    algorithm.  The key follows ``core/random.py``'s protocol: ``select``
    splits it in two, the projection's key and the algorithm's.
    """

    def __init__(self, k: int, *, algo: str = "dash", mesh=None,
                 feature_mode: str = "grad", embed_dim_cap: int = 64,
                 beta2: float = 1.0, sigma2: float = 1.0,
                 opt_margin: float = 1.25, **algo_opts):
        get_algorithm(algo)            # fail fast on unknown names
        self.k = int(k)
        self.algo = algo
        self.mesh = mesh
        self.feature_mode = feature_mode
        self.embed_dim_cap = int(embed_dim_cap)
        self.beta2 = float(beta2)
        self.sigma2 = float(sigma2)
        self.opt_margin = float(opt_margin)
        self.algo_opts = dict(algo_opts)

    def objective(self, embeds, key, *, k: int | None = None,
                  mesh=_UNSET) -> CoresetObjective:
        """The CoresetObjective this selector runs on ``embeds`` (a
        (pool, feat) tensor; its device is the objective's), its
        candidates padded to ``mesh``'s model-axis multiple."""
        mesh = self.mesh if mesh is _UNSET else mesh
        embeds = torch.as_tensor(embeds)
        return CoresetObjective.from_features(
            embeds, kmax=self.k if k is None else int(k),
            dim_cap=self.embed_dim_cap, key=key, beta2=self.beta2,
            sigma2=self.sigma2, device=embeds.device,
            pad_multiple=mesh.shape["model"] if mesh is not None else 1)

    def select(self, embeds, key, *, k: int | None = None,
               mesh=_UNSET) -> torch.Tensor:
        """embeds: (pool, feat) candidate features → (k,) int64 pool
        indices, on the features' device: the selected rows in ascending
        order, then, where the algorithm selected fewer than k (DASH
        under a high OPT guess), unselected rows at the same positions of
        the ascending list of unselected rows (the reference's
        backfill)."""
        mesh = self.mesh if mesh is _UNSET else mesh
        embeds = torch.as_tensor(embeds)
        dev = embeds.device
        k = self.k if k is None else int(k)
        kp, kd = key.split(2)
        obj = self.objective(embeds, kp, k=k, mesh=mesh)
        opts = dict(self.algo_opts)
        if self.algo == "dash" and "opt" not in opts:
            ref = select("topk", obj, k, mesh=mesh, device=dev)
            opts["opt"] = float(ref.value) * self.opt_margin
            opts.setdefault("n_samples", 4)
        res = select(self.algo, obj, k, key=kd, mesh=mesh, device=dev,
                     **opts)
        mask = res.sel_mask.reshape(-1)[: obj.n_real]
        return backfill(mask, k)


def backfill(mask: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) indices: position i holds the i-th selected row of ``mask``,
    or, past the selected count, the i-th unselected row (0 past both),
    as ``jnp.nonzero(size=k)`` with the reference's fill values."""
    def first_k(m, fill):
        idx = torch.nonzero(m).flatten()[:k]
        pad = torch.full((k - idx.numel(),), fill, dtype=idx.dtype,
                         device=idx.device)
        return torch.cat([idx, pad])

    idx = first_k(mask, -1)
    filler = first_k(~mask, 0)
    return torch.where(idx < 0, filler, idx)


class DashBatchSelector(BatchSelector):
    """The pre-registry API: ``method=`` maps onto ``algo=``, and the old
    DASH knobs are forwarded only when DASH runs."""

    def __init__(self, k: int, *, method: str = "dash", alpha: float = 0.5,
                 eps: float = 0.25, n_samples: int = 6,
                 embed_dim_cap: int = 256, **kw):
        opts = ({"alpha": alpha, "eps": eps, "n_samples": n_samples}
                if method == "dash" else {})
        super().__init__(k, algo=method, feature_mode="embed",
                         embed_dim_cap=embed_dim_cap, **opts, **kw)
        self.method = method


def pool_embeddings(model, params, batch):
    """Mean-pooled embedding-table features, the cheap frozen-backbone
    proxy: ``coreset_features(mode="embed")``."""
    return coreset_features(model, params, batch, mode="embed")
