"""SDS_MA — the greedy baseline family (Krause & Cevher; paper §5).

Ports the single-device half of ``repro/core/greedy.py``:

``greedy``            — k rounds, each picking argmax_a f_S(a) over the
                        batched gain vector: one singleton-sweep kernel
                        call per pick.
``stochastic_greedy`` — each round restricts the argmax to a uniform
                        sample of s = ⌈(n/k)·ln(1/ε)⌉ unselected
                        candidates, scored through ``gains_subset`` on
                        the gathered columns only.
``lazy_greedy``       — Minoux's lazy bounds on the host, the ``batch``
                        largest stale bounds re-checked in one
                        ``gains_subset`` call.
``*_cost``            — adaptivity and oracle-query accounting.

The distributed twins are ``core/distributed.py``'s
``greedy_distributed`` and ``stochastic_greedy_distributed``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.dash import take_lane
from repro_torch.core.estimators import gumbel_noise, masked_argmax, top_k
from repro_torch.core.objectives.base import check_device


class GreedyResult(NamedTuple):
    sel_mask: torch.Tensor
    sel_idx: torch.Tensor   # (k,) in pick order
    value: torch.Tensor
    values: torch.Tensor    # (k,) trace of f(S) after each pick
    state: Any


def greedy(obj, k: int, *, device=None) -> GreedyResult:
    """Parallel-oracle SDS_MA (argmax over the batched gain vector).
    ``device=None`` means the card.  No host sync inside the loop."""
    check_device(obj, device)
    state = obj.init()
    picks = torch.zeros((k,), dtype=torch.int64, device=obj.device)
    values = torch.zeros((k,), dtype=torch.float32, device=obj.device)
    for i in range(k):
        a = masked_argmax(obj.gains(state), ~state.sel_mask)      # (1,)
        # A saturated step (all gains 0) still marks the pick, keeping
        # the loop shape fixed as in the reference.
        state = obj.add_one(state, a)
        picks[i] = a[0]
        values[i] = obj.value(state)[0]
    value = obj.value(state)[0]
    state = take_lane(state, 0)
    return GreedyResult(sel_mask=state.sel_mask, sel_idx=picks,
                        value=value, values=values, state=state)


def subsample_size(n: int, k: int, eps: float = 0.1) -> int:
    """Mirzasoleiman et al.'s per-round sample size ⌈(n/k)·ln(1/ε)⌉,
    clipped to [1, n]."""
    s = int(math.ceil(n / max(k, 1) * math.log(1.0 / eps)))
    return max(1, min(s, n))


def round_gumbel(key, i: int, n: int, device) -> torch.Tensor:
    """(n,) Gumbel noise for round ``i`` of a per-pick sampler: one draw
    from ``key.fold_in(i)``, the reference's noise layout."""
    return gumbel_noise(key.fold_in(i), n, device)


def stochastic_greedy(obj, k: int, key, *, subsample: int | None = None,
                      eps: float = 0.1, device=None) -> GreedyResult:
    """Subsampled-argmax SDS_MA (stochastic greedy).

    Each round draws a uniform sample of ``subsample`` (default
    ⌈(n/k)·ln(1/ε)⌉) unselected candidates — the top s of the round's
    Gumbel noise with the selected elements at −inf — scores only the
    sample (``gains_subset``), and scatters the gains back to ground-set
    coordinates, so ties resolve to the lowest global index.  Slots past
    the alive count are padding and never win.  ``device=None`` means
    the card.  No host sync inside the loop.
    """
    check_device(obj, device)
    n, dev = obj.n, obj.device
    s = (subsample_size(n, k, eps) if subsample is None
         else max(1, min(int(subsample), n)))
    state = obj.init()
    picks = torch.zeros((k,), dtype=torch.int64, device=dev)
    values = torch.zeros((k,), dtype=torch.float32, device=dev)
    ninf = torch.full((1, n), -torch.inf, device=dev)
    for i in range(k):
        noise = round_gumbel(key, i, n, dev)[None]
        noise = torch.where(state.sel_mask, ninf, noise)
        nv, sidx = top_k(noise, s)                             # (1, s)
        g = obj.gains_subset(state, sidx)
        scat = ninf.scatter(1, sidx, torch.where(torch.isfinite(nv), g,
                                                 -torch.inf))
        a = torch.argmax(scat, dim=-1)                         # (1,)
        state = obj.add_one(state, a)
        picks[i] = a[0]
        values[i] = obj.value(state)[0]
    value = obj.value(state)[0]
    state = take_lane(state, 0)
    return GreedyResult(sel_mask=state.sel_mask, sel_idx=picks,
                        value=value, values=values, state=state)


# ---------------------------------------------------------------------------
# adaptivity / oracle-query accounting
# ---------------------------------------------------------------------------

def greedy_sequential_cost(n: int, k: int) -> dict:
    """Oracle-call/adaptivity accounting for sequential SDS_MA."""
    calls = sum(n - i for i in range(k))
    return {"oracle_calls": calls, "adaptive_rounds": calls}


def greedy_parallel_cost(n: int, k: int) -> dict:
    """Parallel SDS_MA: one adaptive round per pick."""
    return {"oracle_calls": sum(n - i for i in range(k)), "adaptive_rounds": k}


def stochastic_greedy_cost(n: int, k: int, eps: float = 0.1) -> dict:
    """Stochastic greedy: one adaptive round per pick, s queries each."""
    s = subsample_size(n, k, eps)
    return {"oracle_calls": k * s, "adaptive_rounds": k}


def lazy_greedy_cost(n: int, k: int) -> dict:
    """Minoux lazy greedy: adaptivity is data-dependent; the worst case,
    the full sequential sweep, is what the guarantee covers."""
    calls = sum(n - i for i in range(k))
    return {"oracle_calls": calls, "adaptive_rounds": calls}


def lazy_greedy(obj, k: int, *, batch: int = 8, device=None) -> GreedyResult:
    """Minoux lazy greedy with batched re-checks (host loop).

    The bounds live on the host in numpy, as in the reference, so the
    pick order and its ties (``np.argmax``, a stable ``argsort``) are the
    reference's.  Each iteration refreshes the ``batch`` largest stale
    bounds in one ``gains_subset`` call (padded with the current argmax
    to a fixed width); picked elements are never re-checked.  ``k > n``
    stops after n distinct picks.  ``device=None`` means the card.
    """
    check_device(obj, device)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = obj.device

    def recheck(state, idx):
        t = torch.as_tensor(idx, dtype=torch.int64, device=dev)[None]
        return obj.gains_subset(state, t)[0].cpu().numpy()

    state = obj.init()
    ub = obj.gains(state)[0].cpu().numpy().copy()   # stale upper bounds
    fresh = np.zeros_like(ub, dtype=bool)
    dead = np.zeros_like(ub, dtype=bool)            # picked: never revisit
    picks, values = [], []
    for _ in range(k):
        fresh[:] = False
        while True:
            a = int(np.argmax(ub))
            if ub[a] <= 0 or fresh[a]:
                break
            stale = np.flatnonzero(~fresh & ~dead)
            top = stale[np.argsort(-ub[stale], kind="stable")[:batch]]
            top = np.concatenate([top, np.full(batch - top.size, a)])
            ub[top] = recheck(state, top)
            fresh[top] = True
        if not np.isfinite(ub[a]):
            break       # every element committed (k > n): stop early
        state = obj.add_one(state, torch.tensor([a], device=dev))
        ub[a] = -np.inf
        dead[a] = True
        picks.append(a)
        values.append(float(obj.value(state)[0]))
    value = obj.value(state)[0]
    state = take_lane(state, 0)
    return GreedyResult(
        sel_mask=state.sel_mask,
        sel_idx=torch.tensor(picks, dtype=torch.int64, device=dev),
        value=value,
        values=torch.tensor(values, dtype=torch.float32, device=dev),
        state=state,
    )
