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
leading.  The sharded ``dist_*`` contract waits for the sharded slice.
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


def resolve_engine(obj) -> bool:
    """Whether DASH's filter statistic, FAST's prefix sweep and adaptive
    sequencing go through ``filter_gains_batch``: the objective's
    ``use_filter_engine`` flag (False where it has none), and the
    objective must have the method.  Otherwise they take the per-sample
    path, one ``gains(add_set(...))`` a sample or prefix."""
    return (bool(getattr(obj, "use_filter_engine", False))
            and hasattr(obj, "filter_gains_batch"))


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
