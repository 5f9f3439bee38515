"""Adaptive sequencing for differentially submodular objectives.

Ports ``repro/core/adaptive_sequencing.py`` (Balkanski–Rubinstein–Singer,
STOC 2019; the paper's §1.2).  Per adaptive round:

  1. draw a uniformly random sequence (a_1, …, a_L) of alive elements,
     L = min(k, n);
  2. evaluate every element's gain at its insertion prefix — all L + 1
     prefixes in one ``filter_gains_batch`` call
     (``core.fast.sequence_prefix_gains``);
  3. commit the longest prefix whose tail clears the threshold α·t/k,
     t = (1 − ε)(OPT − f(S));
  4. filter the alive set by the gains at the committed state (row c of
     the same sweep); a round that commits nothing decays the threshold
     and resets the alive set instead.

The rounds are a host loop with one sync per round (the loop condition),
where the reference runs a ``lax.while_loop``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.dash import take_lane
from repro_torch.core.estimators import sample_set_from_mask
from repro_torch.core.fast import sequence_prefix_gains
from repro_torch.core.objectives.base import check_device, resolve_engine


class AdSeqResult(NamedTuple):
    sel_mask: torch.Tensor
    sel_count: torch.Tensor
    value: torch.Tensor
    rounds: torch.Tensor
    state: Any


def adaptive_sequencing(obj, k: int, key, *, eps: float = 0.2,
                        alpha: float = 0.5, rounds: int = 0, opt=None,
                        device=None) -> AdSeqResult:
    """BRS adaptive sequencing with the residual threshold.

    ``rounds=0`` means min(k, ⌈log₂ n⌉); ``opt=None`` takes the modular
    upper bound k·max_a f(a).  ``device=None`` means the card.
    """
    check_device(obj, device)
    n, dev = obj.n, obj.device
    k = int(k)
    L = min(k, n)
    r = rounds or max(1, min(k, int(math.ceil(math.log2(max(n, 2))))))
    engine = resolve_engine(obj)
    ar = torch.arange(L, device=dev)
    if opt is None:
        opt = torch.max(obj.gains(obj.init())) * k
    opt = torch.as_tensor(opt, dtype=torch.float32, device=dev)

    state = obj.init()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    scale = torch.ones((), dtype=torch.float32, device=dev)
    rho = 0
    while rho < r and bool(count < k):
        key, k_seq = key.split(2)
        t = torch.clamp((1.0 - eps) * (opt - obj.value(state)[0]), min=0.0)
        thr = scale * alpha * t / k
        seq_idx, seq_valid = sample_set_from_mask([k_seq], alive[None], L)
        seq_idx, seq_valid = seq_idx[0], seq_valid[0]
        allowed = torch.clamp(k - count, 0, L)
        slot_ok = seq_valid & (ar < allowed)
        G, marg = sequence_prefix_gains(obj, state, seq_idx, slot_ok,
                                        engine=engine)
        clear = slot_ok & (marg >= thr)
        c_len = torch.max(torch.where(clear, ar + 1, 0)).to(torch.int32)
        state = obj.add_set(state, seq_idx[None], (ar < c_len)[None])
        sel = state.sel_mask[0]
        g_new = G[c_len.long()]
        added = c_len > 0
        alive = torch.where(added, alive & ~sel & (g_new >= thr), ~sel)
        scale = torch.where(added, scale, scale * (1.0 - eps))
        alive = torch.where(torch.sum(alive) > 0, alive, ~sel)
        count = count + c_len
        rho += 1
    value = obj.value(state)[0]
    state = take_lane(state, 0)
    return AdSeqResult(sel_mask=state.sel_mask, sel_count=count,
                       value=value,
                       rounds=torch.tensor(rho, dtype=torch.int32, device=dev),
                       state=state)
