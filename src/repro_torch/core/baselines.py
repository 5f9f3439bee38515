"""RANDOM and TOP-k baselines (paper §5), one-shot selectors.

Ports ``repro/core/baselines.py``.  ``k > n`` is clamped to the ground
set, and ``sel_count`` reports how many elements were committed —
``random_select`` can under-fill when fewer than k candidates are alive.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.dash import take_lane
from repro_torch.core.estimators import sample_set_from_mask, top_k
from repro_torch.core.objectives.base import check_device


class SelectResult(NamedTuple):
    sel_mask: torch.Tensor
    value: torch.Tensor
    state: Any
    sel_count: torch.Tensor  # committed |S| — can be < the requested k


def _result(obj, state) -> SelectResult:
    value = obj.value(state)[0]
    state = take_lane(state, 0)
    return SelectResult(state.sel_mask, value, state,
                        torch.sum(state.sel_mask.to(torch.int32)))


def random_select(obj, k: int, key, *, device=None) -> SelectResult:
    """Select ≤ k uniformly random elements in one round (Gumbel-top-k
    from ``key``); invalid slots are masked out of the commit."""
    check_device(obj, device)
    kk = min(int(k), obj.n)
    alive = torch.ones((1, obj.n), dtype=torch.bool, device=obj.device)
    idx, valid = sample_set_from_mask([key], alive, kk)
    return _result(obj, obj.add_set(obj.init(), idx, valid))


def top_k_select(obj, k: int, *, device=None) -> SelectResult:
    """Select the ≤ k elements with the largest singleton value f(a),
    ties to the lower index."""
    check_device(obj, device)
    kk = min(int(k), obj.n)
    _, idx = top_k(obj.gains(obj.init()), kk)                   # (1, kk)
    return _result(obj, obj.add_set(obj.init(), idx,
                                    torch.ones_like(idx, dtype=torch.bool)))
