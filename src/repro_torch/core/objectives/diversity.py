"""Diversity-promoting submodular regularizers (paper Cor. 7–9, d(S) terms).

Ports ``repro/core/objectives/diversity.py`` with the port's lane axis
(see ``base.py``).  Cluster-coverage diversity

    d(S) = w · Σ_c √|S ∩ G_c|

(concave of modular, so monotone submodular) over a partition G_c of the
ground set, plus a wrapper that adds the diversity marginals to any base
objective's oracles.

The per-lane cluster counts are one ``scatter_add`` of the (G, n)
selection mask into (G, C).  They are integers held in f32, exact below
2²⁴, so the card's atomics give the same bits in any order.

``ClusterDiversity.set_gain`` scatters each new element into its
cluster, ``clusters[idx]``.  The reference scatters into ``idx`` itself
(``.at[idx]``), which drops every element whose index is ≥ C and files
the rest under the wrong cluster; the port computes d(S ∪ R) − d(S)
(ROADMAP §3, reference caveats).

``DiversifiedObjective`` has no filter engine, so DASH, FAST and
adaptive sequencing score its perturbed states one sample at a time
through ``gains(add_set(...))``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objectives.base import mark_selected
from repro_torch.kernels.common import resolve_device


class ClusterDiversity:
    """d(S) = weight · Σ_c sqrt(count_c(S)) over a ground-set partition.

    ``clusters`` (n,) holds each element's cluster id in [0, n_clusters).
    Every method takes a lane-batched (G, n) selection mask.
    """

    def __init__(self, clusters, n_clusters: int, weight: float = 1.0,
                 device=None):
        dev = (clusters.device if device is None
               and isinstance(clusters, torch.Tensor)
               else resolve_device(device))
        self.clusters = torch.as_tensor(clusters).to(
            device=dev, dtype=torch.int64)
        self.n_clusters = int(n_clusters)
        self.weight = float(weight)

    def counts(self, sel_mask):
        """(G, C) f32 cluster counts of the (G, n) mask."""
        g = sel_mask.shape[0]
        c = torch.zeros((g, self.n_clusters), dtype=torch.float32,
                        device=sel_mask.device)
        return c.scatter_add(1, self.clusters.expand(g, -1),
                             sel_mask.to(torch.float32))

    def value(self, sel_mask):
        """(G,) d(S)."""
        return self.weight * torch.sum(torch.sqrt(self.counts(sel_mask)),
                                       dim=-1)

    def gains(self, sel_mask):
        """(G, n) marginals d_S(a); 0 for already-selected."""
        c = self.counts(sel_mask)
        marg = torch.sqrt(c + 1.0) - torch.sqrt(c)             # (G, C)
        g = self.weight * marg[:, self.clusters]
        return torch.where(sel_mask, torch.zeros_like(g), g)

    def gains_at(self, sel_mask, idx):
        """(G, B) marginals for the candidates idx (G, B): one counts
        scatter, then per-candidate gathers."""
        c = torch.gather(self.counts(sel_mask), 1, self.clusters[idx])
        g = self.weight * (torch.sqrt(c + 1.0) - torch.sqrt(c))
        sel = torch.gather(sel_mask, 1, idx)
        return torch.where(sel, torch.zeros_like(g), g)

    def set_gain(self, sel_mask, idx, mask):
        """d(S ∪ R) − d(S) per lane for idx/mask (G, *B, m) → (G, *B)."""
        lanes, batch, m = idx.shape[0], idx.shape[1:-1], idx.shape[-1]
        idx3 = idx.reshape(lanes, -1, m)
        new = mask.reshape(lanes, -1, m) & ~torch.gather(
            sel_mask, 1, idx3.reshape(lanes, -1)).reshape(idx3.shape)
        c = self.counts(sel_mask)[:, None, :]                  # (G, 1, C)
        add = torch.zeros((lanes, idx3.shape[1], self.n_clusters),
                          dtype=torch.float32, device=idx.device)
        add = add.scatter_add(2, self.clusters[idx3], new.to(torch.float32))
        gain = self.weight * torch.sum(torch.sqrt(c + add) - torch.sqrt(c),
                                       dim=-1)
        return gain.reshape(lanes, *batch)


class DiversityState(NamedTuple):
    sel_mask: torch.Tensor   # (G, n) bool
    value: torch.Tensor      # (G,) f32


class DiversityObjective:
    """Pure cluster-coverage diversity as a standalone objective.

    d(S) alone is monotone submodular, so Minoux's invariant holds and
    ``lazy_greedy`` matches ``greedy`` pick for pick: the exactness
    reference for lazy greedy, and a coverage workload of its own (pick
    k maximally cluster-diverse items).  ``device=None`` means the card.
    """

    def __init__(self, clusters, n_clusters: int, *, weight: float = 1.0,
                 kmax: int | None = None, device=None):
        self.device = resolve_device(device)
        self.div = ClusterDiversity(clusters, n_clusters, weight,
                                    device=self.device)
        self.n = int(self.div.clusters.shape[0])
        self.kmax = int(kmax) if kmax is not None else self.n

    def init(self, lanes: int = 1) -> DiversityState:
        return DiversityState(
            sel_mask=torch.zeros((lanes, self.n), dtype=torch.bool,
                                 device=self.device),
            value=torch.zeros((lanes,), device=self.device),
        )

    def value(self, state: DiversityState):
        return state.value

    def gains(self, state: DiversityState):
        return self.div.gains(state.sel_mask)

    def gains_subset(self, state: DiversityState, idx):
        return self.div.gains_at(state.sel_mask, idx)

    def set_gain(self, state: DiversityState, idx, mask):
        return self.div.set_gain(state.sel_mask, idx, mask)

    def add_set(self, state: DiversityState, idx, mask) -> DiversityState:
        sel = mark_selected(state.sel_mask, idx, mask)
        return DiversityState(sel_mask=sel, value=self.div.value(sel))

    def add_one(self, state: DiversityState, a) -> DiversityState:
        """Add element a[g] to lane g; a: (G,) indices."""
        idx = torch.as_tensor(a, device=self.device).reshape(-1, 1).long()
        return self.add_set(state, idx, torch.ones_like(idx, dtype=torch.bool))


class DiversifiedObjective:
    """f_div(S) = f(S) + d(S): wraps any base objective with diversity.

    The state is the base objective's; d(S) is recomputed from its
    ``sel_mask``.  No ``filter_gains_batch``: the filter statistic goes
    through the per-sample path.
    """

    def __init__(self, base, diversity: ClusterDiversity):
        self.base = base
        self.div = diversity
        self.n = base.n
        self.kmax = base.kmax
        self.device = base.device

    def init(self, lanes: int = 1):
        return self.base.init(lanes)

    def value(self, state):
        return self.base.value(state) + self.div.value(state.sel_mask)

    def gains(self, state):
        return self.base.gains(state) + self.div.gains(state.sel_mask)

    def gains_subset(self, state, idx):
        if not hasattr(self.base, "gains_subset"):
            return torch.gather(self.gains(state), 1, idx)
        return self.base.gains_subset(state, idx) + self.div.gains_at(
            state.sel_mask, idx)

    def set_gain(self, state, idx, mask):
        return self.base.set_gain(state, idx, mask) + self.div.set_gain(
            state.sel_mask, idx, mask)

    def add_set(self, state, idx, mask):
        return self.base.add_set(state, idx, mask)

    def add_one(self, state, a):
        return self.base.add_one(state, a)
