"""SDS_MA — the marginal-gain greedy baseline (Krause & Cevher; paper §5).

Ports ``repro/core/greedy.py::greedy``: k rounds, each picking
argmax_a f_S(a) over the batched gain vector — one singleton-sweep kernel
call per pick.  Lazy and stochastic greedy wait for the registry slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.dash import take_lane
from repro_torch.core.estimators import masked_argmax
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
    state = take_lane(state, 0)
    return GreedyResult(sel_mask=state.sel_mask, sel_idx=picks,
                        value=state.value, values=values, state=state)
