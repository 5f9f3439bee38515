"""FAST — adaptive sequencing with a binary-searched OPT guess.

Ports the single-device half of ``repro/core/fast.py`` (Breuer, Balkanski
& Singer's FAST):

  * **Outer loop — binary-searched OPT guess.**  ⌈log₂ G⌉ probes of the
    geometric guess lattice of ``core.dash.opt_guess_lattice``; a guess is
    feasible when its run attains (1 − 1/e)(1 − ε) of it, and the search
    walks toward the largest feasible guess.  ``lo``, ``hi`` and the
    running best stay on the device, as in the reference.
  * **Threshold ladder.**  From one rung below the top singleton gain
    down to ε·opt/k; a round that commits nothing steps t ← (1 − ε)·t.
  * **Inner adaptive-sequencing rounds.**  Draw a random sequence of
    L = min(k, n) alive elements (Gumbel-top-k), score every element at
    its insertion prefix, commit the leading run that cleared t, and
    filter the survivors by their gains at the committed state.

A sequence's L + 1 insertion prefixes ride the filter engine's sample
axis: prefix j is the "sample" R_j = {a_1, …, a_j}, so one
``filter_gains_batch`` call on idx/mask of shape (1, L + 1, L) returns
the gains at every prefix (row j) and at the post-commit state (row c).

The rounds are a host loop with one sync per round (the loop condition),
where the reference runs a ``lax.while_loop``.  Every threshold decision
compares bf16-quantized values (:func:`q_cmp`), as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.estimators import sample_set_from_mask
from repro_torch.core.objectives.base import (
    check_device,
    resolve_engine,
    with_precision,
)
from repro_torch.core.random import SeedKey


class FastResult(NamedTuple):
    sel_mask: torch.Tensor   # (n,) bool
    sel_count: torch.Tensor  # () int32
    value: torch.Tensor      # () f32 — f(S)
    rounds: torch.Tensor     # () int32 — adaptive rounds consumed
    values: torch.Tensor     # (r_max,) per-round f(S) trace (0-padded)
    opt: torch.Tensor        # () f32 — the OPT guess used


#: Feasibility fraction of the OPT binary search: a guess g survives when
#: the inner run attains (1 − 1/e)(1 − ε)·g.
_FEASIBLE_FRAC = 1.0 - 1.0 / math.e


def ladder_levels(k: int, eps: float) -> int:
    """Geometric decays from the ladder's start (the top singleton gain)
    to the ε·opt/k floor: ⌈ln(k/ε) / −ln(1−ε)⌉."""
    return int(math.ceil(
        math.log(max(int(k), 1) / eps) / -math.log(1.0 - eps)))


def fast_round_cap(k: int, eps: float) -> int:
    """Round bound: every round commits ≥ 1 element (≤ k such rounds) or
    steps the ladder (≤ ``ladder_levels``); +2 for entry and exit."""
    return int(k) + ladder_levels(k, eps) + 2


def q_cmp(x: torch.Tensor) -> torch.Tensor:
    """bf16 view of a comparison operand (round to nearest even, as
    ``astype(bfloat16)`` in JAX).  Every threshold decision looks
    through it; values themselves stay f32."""
    return x.to(torch.bfloat16)


def prefix_masks(L: int, device=None) -> torch.Tensor:
    """(L + 1, L) bool: row j marks the length-j insertion prefix."""
    return (torch.arange(L, device=device)[None, :]
            < torch.arange(L + 1, device=device)[:, None])


def sequence_prefix_gains(obj, state, seq_idx, slot_ok, *, engine: bool):
    """Gains at every insertion prefix of a sequence.

    ``seq_idx`` (L,) int64 and ``slot_ok`` (L,) bool for a one-lane
    ``state``.  Returns ``(G, marg)``: G (L + 1, n), row j the gains
    w.r.t. S ∪ {a_1, …, a_j}; marg (L,) the gain of a_{j+1} at its
    insertion point, ``G[j, seq_idx[j]]``.  With ``engine`` all L + 1
    prefixes are one ``filter_gains_batch`` call; without, one
    ``gains(add_set(...))`` per prefix.
    """
    L = seq_idx.shape[0]
    masks = prefix_masks(L, seq_idx.device) & slot_ok[None, :]
    if engine:
        idx_b = seq_idx[None, None, :].expand(1, L + 1, L).contiguous()
        G = obj.filter_gains_batch(state, idx_b, masks[None])[0]
    else:
        G = torch.cat([obj.gains(obj.add_set(state, seq_idx[None], m[None]))
                       for m in masks])
    marg = G[torch.arange(L, device=G.device), seq_idx]
    return G, marg


def ladder_commit(slot_ok, marg, t, eps: float):
    """A round's decision: the length of the leading run of sequence
    elements that cleared t at their own insertion point (``marg``
    (L,)), and the next threshold — a round that commits nothing (the
    threshold outran the pool) steps down, t ← (1 − ε)·t."""
    clear = slot_ok & (q_cmp(marg) >= q_cmp(t))
    c_len = torch.sum(torch.cumprod(clear.to(torch.int32), 0))
    c_len = c_len.to(torch.int32)
    return c_len, torch.where(c_len > 0, t, (1.0 - eps) * t)


def _fast_core(obj, k: int, eps: float, r_max: int, engine: bool):
    """The single-guess FAST run: ``run(key, opt) -> FastResult``."""
    n, dev = obj.n, obj.device
    L = min(int(k), int(n))
    ar = torch.arange(L, device=dev)

    def run(key, opt):
        opt = torch.as_tensor(opt, dtype=torch.float32, device=dev)
        state = obj.init()
        g0 = obj.gains(state)[0]
        # Seed S with the argmax singleton; the ladder opens one rung
        # below the top of the actual gain range (see the reference).
        a0 = torch.argmax(q_cmp(g0).float())
        state = obj.add_set(state, a0.reshape(1, 1),
                            torch.ones((1, 1), dtype=torch.bool, device=dev))
        t = (1.0 - eps) * torch.max(g0)
        t_min = eps * opt / k
        alive = ((q_cmp(obj.gains(state)[0]) >= q_cmp(t))
                 & ~state.sel_mask[0])
        count = torch.ones((), dtype=torch.int32, device=dev)
        values = torch.zeros((r_max,), dtype=torch.float32, device=dev)
        rho = 0
        while rho < r_max and bool((count < k) & (t >= t_min)):
            key, k_seq = key.split(2)
            seq_idx, seq_valid = sample_set_from_mask([k_seq], alive[None], L)
            seq_idx, seq_valid = seq_idx[0], seq_valid[0]
            allowed = torch.clamp(k - count, 0, L)
            slot_ok = seq_valid & (ar < allowed)
            G, marg = sequence_prefix_gains(obj, state, seq_idx, slot_ok,
                                            engine=engine)
            c_len, t = ladder_commit(slot_ok, marg, t, eps)
            state = obj.add_set(state, seq_idx[None], (ar < c_len)[None])
            count = count + c_len
            g_c = G[c_len.long()]
            alive = (q_cmp(g_c) >= q_cmp(t)) & ~state.sel_mask[0]
            values[rho] = obj.value(state)[0]
            rho += 1
        return FastResult(
            sel_mask=state.sel_mask[0], sel_count=count,
            value=obj.value(state)[0],
            rounds=torch.tensor(rho, dtype=torch.int32, device=dev),
            values=values, opt=opt,
        )

    return run


def _merge(better, new, old):
    return type(new)(*(torch.where(better, a, b) for a, b in zip(new, old)))


def binary_search_opt(run_core, key, guesses, eps: float) -> FastResult:
    """Binary search of the OPT guess lattice.

    ``guesses`` (G,) ascending; ⌈log₂ G⌉ probes of ``run_core``, probe s
    on ``key.fold_in(s)``.  The bounds and the merged running best (a
    NaN value never wins) stay on the device; the probes run one after
    another.
    """
    G = int(guesses.shape[0])
    steps = max(1, int(math.ceil(math.log2(G)))) if G > 1 else 1
    ratio = _FEASIBLE_FRAC * (1.0 - eps)
    dev = guesses.device
    lo = torch.zeros((), dtype=torch.int64, device=dev)
    hi = torch.full((), G - 1, dtype=torch.int64, device=dev)
    best = None
    for s in range(steps):
        mid = torch.clamp(torch.div(lo + hi, 2, rounding_mode="floor"),
                          0, G - 1)
        g = guesses[mid]
        res = run_core(key.fold_in(s), g)
        if best is None:
            best = res
        else:
            ninf = torch.tensor(-torch.inf, device=dev)
            v_new = torch.where(torch.isnan(res.value), ninf, res.value)
            v_old = torch.where(torch.isnan(best.value), ninf, best.value)
            best = _merge(q_cmp(v_new) > q_cmp(v_old), res, best)
        feasible = q_cmp(res.value) >= q_cmp(ratio * g)
        lo = torch.where(feasible, mid + 1, lo)
        hi = torch.where(feasible, hi, mid - 1)
    return best


def fast(obj, k: int, key=None, *, eps: float = 0.06, opt=None,
         n_guesses: int = 8, max_rounds: int = 0,
         precision: str | None = None, device=None) -> FastResult:
    """Run FAST on one device.

    ``opt`` pins a single OPT guess (one ladder run); omitting it binary
    searches the ``n_guesses``-point lattice (⌈log₂ n_guesses⌉ runs).
    ``max_rounds`` overrides the round cap (:func:`fast_round_cap`).
    The objective's ``use_filter_engine`` flag picks the prefix sweep
    (:func:`resolve_engine`): off, one ``gains(add_set(...))`` a prefix.
    ``precision`` runs the kernels through a ``with_precision`` view.  A
    missing key is ``SeedKey(0)``; ``device=None`` means the card.
    """
    from repro_torch.core.dash import opt_guess_lattice

    check_device(obj, device)
    if precision is not None:
        obj = with_precision(obj, precision)
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be a positive integer, got {k!r}")
    if key is None:
        key = SeedKey(0)
    eps = float(eps)
    engine = resolve_engine(obj)
    r_max = int(max_rounds) or fast_round_cap(k, eps)
    if opt is not None:
        guesses = torch.as_tensor(opt, dtype=torch.float32).reshape(1)
        guesses = guesses.to(obj.device)
    else:
        guesses = opt_guess_lattice(obj, eps, n_guesses, k)
    core = _fast_core(obj, k, eps, r_max, engine)
    return binary_search_opt(core, key, guesses, eps)


def fast_cost(n: int, k: int, eps: float = 0.06) -> dict:
    """{"oracle_calls", "adaptive_rounds"} at FAST's leading order: per
    probe ``ladder_levels`` decay rounds plus ⌈log₂(min(n, k) + 1)⌉
    committing rounds, times ⌈log₂ 8⌉ probes; n queries a round."""
    per_probe = ladder_levels(k, eps) + int(
        math.ceil(math.log2(max(min(n, k) + 1, 2))))
    probes = max(1, int(math.ceil(math.log2(8))))
    r = probes * per_probe
    return {"oracle_calls": n * r, "adaptive_rounds": r}
