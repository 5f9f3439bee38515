"""Training-batch coreset selection as Bayesian A-optimal design.

Ports the single-device half of ``repro/core/objectives/coreset.py``.
Each candidate example is a stimulus column (its pooled embedding, final
hidden state or last-layer gradient under the current model), and the
batch that most reduces the posterior variance over a linear probe of
that feature space is Bayesian A-optimal design (paper Cor. 9).  So the
objective is ``AOptimalityObjective`` on a prepared feature matrix, with
its two kernels (``aopt_gains`` and the filter engine
``aopt_filter_gains``) on the card; this module owns the feature
preparation and the real-vs-padded bookkeeping.

``coreset_features`` runs the port's dense decoder: on the card the
backbone's attention goes through the flash-attention kernel, as in
``Model.prefill``.  The sharded runtime's ``dist_*`` contract is
``AOptimalityObjective``'s, inherited.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.objectives.a_optimal import AOptimalityObjective
from repro_torch.core.random import SeedKey

#: Feature extraction modes for :func:`coreset_features`:
#: "embed"  — mean-pooled embedding-table lookup (no forward pass),
#: "hidden" — mean-pooled final hidden states (one forward pass),
#: "grad"   — the last-layer cross-entropy gradient with respect to the
#:            pre-head hidden state, (softmax(logits) − onehot) @ headᵀ,
#:            pooled over the supervised positions (one forward pass and
#:            the analytic last-layer backward).
FEATURE_MODES = ("embed", "hidden", "grad")


def prepare_feature_columns(feats, *, dim_cap: int = 64, key=None):
    """(pool, feat_dim) per-example features → (d, pool) stimulus columns.

    Random-projects to ``dim_cap`` dims when wider (R ~ N(0, 1/feat_dim),
    drawn through ``key``; a missing key is ``SeedKey(0)``), then
    L2-normalizes each example so that the design objective scores
    directional coverage, not feature magnitude.
    """
    E = torch.as_tensor(feats, dtype=torch.float32)
    p, d = E.shape
    if d > dim_cap:
        if key is None:
            key = SeedKey(0)
        R = key.normal((d, dim_cap), E.device) / math.sqrt(d)
        E = E @ R
    E = E / torch.clamp(torch.linalg.norm(E, dim=1, keepdim=True), min=1e-9)
    return E.T


def coreset_features(model, params, batch, *, mode: str = "grad"):
    """Per-example feature vectors (B, feat) f32 for coreset selection.

    ``batch["tokens"]`` (B, S) int on the parameters' device.  Vision
    and encoder–decoder configs take ``mode="embed"`` only.
    """
    if mode not in FEATURE_MODES:
        raise ValueError(f"mode must be one of {FEATURE_MODES}, got {mode!r}")
    tokens = batch["tokens"]
    if mode == "embed":
        emb = params["embed"][tokens.long()]                 # (B, S, D)
        return torch.mean(emb.to(torch.float32), dim=1)
    cfg = model.cfg
    if cfg.vision is not None or cfg.is_encdec:
        raise NotImplementedError(
            "forward-pass coreset features support plain decoder LMs; "
            "use mode='embed' for vision/enc-dec batches")
    x = model._embed_tokens(params, tokens)
    # The attention path of Model.prefill: the kernel on the card, its
    # plain version on the CPU up to 1024 tokens, ``chunked`` above.
    impl = "chunked" if not x.is_cuda and x.shape[1] > 1024 else "kernel"
    h, _, _ = model._backbone(params, x, impl=impl)
    h = h.to(torch.float32)
    if mode == "hidden":
        return torch.mean(h, dim=1)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    head = head.to(torch.float32)                            # (D, V)
    err = torch.softmax(h @ head, dim=-1)                    # (B, S, V)
    # softmax − onehot of the next token; the last position has no label.
    labels = torch.roll(tokens.long(), -1, dims=1)
    err.scatter_add_(-1, labels[..., None],
                     torch.full_like(labels[..., None], -1.0,
                                     dtype=err.dtype))
    s = tokens.shape[1]
    # dCE/dh is linear in err: pool err over the supervised positions
    # first, then take one (B, V) @ (V, D) product.
    pooled = torch.sum(err[:, : s - 1], dim=1)               # (B, V)
    return (pooled @ head.T) / max(s - 1, 1)


class CoresetObjective(AOptimalityObjective):
    """A-optimal design over per-example feature columns.

    Every oracle comes from :class:`AOptimalityObjective`; ``n_real``
    is the pool size before ``from_features`` padded the candidate axis,
    so that a caller can map the selected mask back to pool rows.
    """

    def __init__(self, X, kmax: int, *, beta2: float = 1.0,
                 sigma2: float = 1.0, n_real: int | None = None, **kw):
        super().__init__(X, kmax, beta2=beta2, sigma2=sigma2, **kw)
        self.n_real = self.n if n_real is None else int(n_real)

    @classmethod
    def from_features(cls, feats, kmax: int, *, dim_cap: int = 64, key=None,
                      beta2: float = 1.0, sigma2: float = 1.0,
                      pad_multiple: int = 1, **kw) -> "CoresetObjective":
        """Build from raw (pool, feat_dim) features: project and
        normalize (:func:`prepare_feature_columns`), then zero-pad the
        candidate axis to a multiple of ``pad_multiple``."""
        X = prepare_feature_columns(feats, dim_cap=dim_cap, key=key)
        n_real = X.shape[1]
        if pad_multiple > 1:
            from repro_torch.core.distributed import pad_ground_set

            X, _ = pad_ground_set(X, pad_multiple)
        return cls(X, kmax, beta2=beta2, sigma2=sigma2, n_real=n_real, **kw)
