"""Objective interface of the port, with an explicit lane axis.

Ports the single-device half of ``repro/core/objectives/base.py``.  The
JAX reference runs the DASH (OPT, α) guess lattice under ``jax.vmap``;
``torch.vmap`` cannot batch a hand-written kernel, so the port carries the
lattice as a leading lane axis G through every state: a state's tensors
are (G, ...) and every method works on all G lanes at once.  Greedy and
the one-shot baselines are the G = 1 case.

State conventions: ``state`` is a NamedTuple with at least
  * ``sel_mask``: (G, n) bool — membership of the current solution S,
  * ``value``:    (G,)   f32 — f(S).

Set arguments are ``(idx, mask)``: int64 index tensors padded
arbitrarily and bool masks marking the real entries, with the lane axis
leading.  The sharded runtime (``core/distributed.py``) reads the
column-based ``dist_*`` contract of :class:`DistributedObjective`,
lane-batched the same way: it gathers each sampled set's columns across
the ranks and hands the objective the columns themselves.
"""

from __future__ import annotations

import copy
from typing import Any, Protocol

import torch

from repro_torch.kernels.common import resolve_device, resolve_precision


class Objective(Protocol):
    """Protocol implemented by all subset-selection objectives."""

    n: int          # ground-set size
    kmax: int       # capacity for |S|
    device: torch.device

    def init(self, lanes: int = 1) -> Any:
        """State for S = ∅ on ``lanes`` lanes."""

    def value(self, state) -> torch.Tensor:
        """(G,) f(S)."""

    def gains(self, state) -> torch.Tensor:
        """(G, n) singleton marginals f_S(a); 0 for a ∈ S."""

    def set_gain(self, state, idx, mask) -> torch.Tensor:
        """f_S(R) for padded sets R = idx[mask]; idx (G, *B, m) → (G, *B)."""

    def add_set(self, state, idx, mask):
        """State for S ∪ R; idx/mask (G, m)."""


class SupportsSubsetGains(Objective, Protocol):
    """``gains_subset(state, idx)`` equals ``gains(state)`` gathered at
    ``idx`` (G, B) while touching only the gathered columns."""

    def gains_subset(self, state, idx) -> torch.Tensor:
        """(G, B) gains f_S(idx); 0 for already-selected."""


class SupportsFilterEngine(Objective, Protocol):
    """Objectives that batch DASH's filter statistic over samples and
    lanes in one kernel call (``repro_torch.kernels.filter_gains``).

    ``filter_gains_batch(state, idx, mask)`` with idx/mask (G, m, b)
    returns the (G, m, n) gains w.r.t. S_g ∪ R_{g,i} — what
    ``gains(add_set(state, R))`` would give per sample.  ``precision`` is
    the streamed-operand policy ("f32"/"bf16") of every kernel call.
    """

    precision: str

    def filter_gains_batch(self, state, idx, mask) -> torch.Tensor:
        """(G, m, n) gains w.r.t. S ∪ R_i for each sampled R_i."""


class DistributedObjective(Objective, Protocol):
    """Column-based oracle bundle for the sharded runtime.

    Implemented by ``RegressionObjective`` (and ``R2Objective``),
    ``AOptimalityObjective`` (and ``CoresetObjective``) and
    ``ClassificationObjective``; consumed by ``core/distributed.py``.
    ``dstate`` is a NamedTuple of lane-batched tensors, the same on every
    rank of the ``model`` axis except for its shard-local caches (the
    column norms, the A-optimal shared solve W = M⁻¹X_local), whose last
    axis is the shard's column axis; it carries no ``sel_mask``.  ``C`` is
    (G, *B, d, m) of sampled columns gathered from every shard, invalid
    slots zeroed; ``mask`` (G, *B, m) marks the valid slots.

    The methods issue no collective and read neither ``self.X`` nor any
    other (n,)-shaped global: only ``X_local`` (d, n_local), which must
    be contiguous (the kernel wrappers raise otherwise), and (d,)-shaped
    data.
    """

    X: torch.Tensor  # (d, n) ground-set columns — sharded BY THE RUNNER

    def dist_init(self, X_local, lanes: int = 1):
        """State for S = ∅ on ``lanes`` lanes (plus shard-local caches)."""

    def dist_value(self, dstate) -> torch.Tensor:
        """(G,) f(S) from the replicated state."""

    def dist_gains(self, dstate, X_local) -> torch.Tensor:
        """(G, n_local) singleton marginals of this shard's candidates,
        through the kernel wrappers (the kernel on the card)."""

    def dist_set_gain(self, dstate, C, mask) -> torch.Tensor:
        """(G, *B) f_S(R) for the gathered sample columns."""

    def dist_add_set(self, dstate, C, mask, X_local):
        """State for S ∪ R; C (G, d, m), mask (G, m) (the accept and
        capacity rules of ``add_set``; zero columns — padding — are
        never accepted)."""

    def dist_filter_gains_batch(self, dstate, Cs, masks,
                                X_local) -> torch.Tensor:
        """(G, S, n_local) gains w.r.t. S ∪ R_i for this shard — the
        filter engine, one kernel call for every lane and sample;
        Cs (G, S, d, m), masks (G, S, m)."""


def resolve_engine(obj, *, dist: bool = False) -> bool:
    """Whether DASH's filter statistic, FAST's prefix sweep and adaptive
    sequencing go through the filter engine: the objective's
    ``use_filter_engine`` flag (False where it has none), and the
    objective must have the engine method — ``filter_gains_batch``, or
    ``dist_filter_gains_batch`` for the sharded runtime (``dist``).
    Otherwise they take the per-sample path, one ``gains(add_set(...))``
    a sample or prefix."""
    method = "dist_filter_gains_batch" if dist else "filter_gains_batch"
    return (bool(getattr(obj, "use_filter_engine", False))
            and hasattr(obj, method))


def with_precision(obj, precision: str | None):
    """A view of ``obj`` running its kernels at ``precision``.

    Returns ``obj`` itself when the policy already matches; otherwise a
    memoized shallow copy with ``precision`` overridden and its own
    stream-dtype copy of X (a view holds no views).
    """
    p = resolve_precision(precision)
    if getattr(obj, "precision", "f32") == p:
        return obj
    views = obj.__dict__.setdefault("_precision_views", {})
    if p not in views:
        view = copy.copy(obj)
        view.__dict__.pop("_precision_views", None)
        view.__dict__.pop("_xs", None)
        view.precision = p
        views[p] = view
    return views[p]


def normalize_columns(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-mean, unit-norm columns (the paper's preprocessing)."""
    X = X - torch.mean(X, dim=0, keepdim=True)
    nrm = torch.sqrt(torch.sum(X * X, dim=0, keepdim=True))
    return X / torch.clamp(nrm, min=eps)


def one_hot_columns(idx: torch.Tensor, mask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(*B, n, m) selection matrices E with E[idx[j], j] = mask[j], for
    idx and mask of shape (*B, m): ``X @ E`` gathers the padded set's
    columns as a product."""
    m = idx.shape[-1]
    e = torch.zeros((*idx.shape[:-1], n, m), dtype=torch.float32,
                    device=idx.device)
    return e.scatter_(-2, idx.unsqueeze(-2),
                      mask.to(torch.float32).unsqueeze(-2))


def gather_columns(X: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """(*B, d, m) columns X[:, idx] with padded entries zeroed, for idx
    and mask of shape (*B, m)."""
    cols = X[:, idx]                                   # (d, *B, m)
    cols = torch.movedim(cols, 0, -2)                  # (*B, d, m)
    return cols * mask.to(X.dtype).unsqueeze(-2)


def mark_selected(sel_mask: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """sel_mask | (the entries idx[mask]), scattered on the last axis."""
    return sel_mask.scatter(-1, idx, torch.gather(sel_mask, -1, idx) | mask)


def write_accepted_column(Q: torch.Tensor, slot: torch.Tensor,
                          accept: torch.Tensor, q: torch.Tensor) -> None:
    """Write basis column ``q`` into ``Q[..., :, slot]`` only where
    ``accept``, in place, per lane.

    Q: (L, d, k); slot, accept: (L,); q: (L, d).  A rejected candidate
    (at capacity, in span, or padded) leaves the column already stored at
    ``slot`` untouched — an unguarded write would clobber it with zeros.
    """
    lanes = torch.arange(Q.shape[0], device=Q.device)
    prev = Q[lanes, :, slot]                           # (L, d)
    Q[lanes, :, slot] = torch.where(accept[:, None], q, prev)


def check_device(obj, device) -> None:
    """Entry-point rule for algorithms: ``device=None`` means the card.
    Raises when there is none, or when ``obj`` lives elsewhere."""
    dev = resolve_device(device)
    have = obj.device
    if have.type != dev.type or (
        dev.index is not None and have.index is not None
        and have.index != dev.index
    ):
        raise ValueError(
            f"objective lives on {have} but the run asks for {dev}; build "
            "the objective with the same device= as the algorithm"
        )
