"""DASH — Differentially-Adaptive-Sampling (paper Algorithm 1, Thm 10).

Ports the single-device half of ``repro/core/dash.py``.  The (OPT, α)
guess lattice of ``dash_auto`` is an explicit leading lane axis: every
lane's selection loop advances in lockstep (``core.selection_loop``), the
filter statistic of all lanes and samples is one filter-engine call, the
current-state fallback of all lanes is one singleton-sweep call, and the
best lane is taken by an on-device argmax.  ``dash`` is the one-lane case.

As in the reference (paper App. G): expectations are Monte-Carlo
estimates over ``n_samples`` sets; the filter averages the gain at
S ∪ R_i over only the samples with a ∉ R_i, with the current-state gain as
fallback when every sample contains a; the inner loop carries the
Lemma-21 iteration cap.  ``dash_auto(guess_mode="loop")`` runs the guesses
one after another instead.  ``dash_checkpointed`` steps one lane round
by round from the host, with a snapshot of the carry at every round
boundary (``core.selection_loop``'s resilience half).  The sharded
runtime (``core/distributed.py``) runs the same loop on a mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.estimators import (
    sample_set_batch,
    sample_set_from_mask,
    trimmed_mean,
)
from repro_torch.core.objectives.base import (
    check_device,
    resolve_engine,
    with_precision,
)
from repro_torch.core.selection_loop import (  # noqa: F401  (re-exported)
    DashConfig,
    DashTrace,
    ResilienceConfig,
    SelectionCarry,
    SelectionHooks,
    drive_checkpointed_rounds,
    initial_carry,
    make_round_body,
    restore_carry,
    run_selection_rounds,
)


class DashResult(NamedTuple):
    sel_mask: torch.Tensor     # (n,) bool, or (G, n) for a lattice
    sel_count: torch.Tensor    # () int32
    value: torch.Tensor        # () f32
    rounds: torch.Tensor       # () int32 — adaptive rounds consumed
    trace: DashTrace
    state: Any


def take_lane(result, lane):
    """Field-by-field lane ``lane`` of a lane-batched NamedTuple result
    (nested NamedTuples included)."""
    def pick(x):
        if isinstance(x, tuple):
            return type(x)(*(pick(v) for v in x))
        return x[lane]
    return pick(result)


def _slot_mask(block: int, allowed, device):
    """(G, block) slots below each lane's remaining capacity."""
    return torch.arange(block, device=device) < allowed[:, None]


def _estimate_set_gain(obj, state, alive, block, allowed, keys, cfg):
    """(G,) Ê_{R~U(X)}[f_S(R)] over cfg.n_samples Monte-Carlo sets."""
    idx, valid = sample_set_batch(keys, alive, block, cfg.n_samples)
    valid = valid & _slot_mask(block, allowed, alive.device)[:, None, :]
    vals = obj.set_gain(state, idx, valid)               # (G, S)
    return trimmed_mean(vals, cfg.trim_frac, dim=1)


def _estimate_elem_gains(obj, state, alive, block, allowed, keys, cfg):
    """(G, n) Ê_R[f_{S∪(R\\{a})}(a)] for every a — the filter statistic.

    Draw ``cfg.n_samples`` sets R_i per lane, evaluate the gain vector at
    every S ∪ R_i, and average per candidate over the samples with
    a ∉ R_i; the current-state gain (all lanes in one singleton sweep) is
    the fallback when every sample contains a.

    Where :func:`resolve_engine` says so, all lanes and samples are
    scored in one filter-engine call (``filter_gains_batch``); an
    objective with the flag off, or without the engine (as
    ``DiversifiedObjective``), takes the per-sample path, one ``gains(add_set(state, R_i))`` of all
    lanes per sample.  The samples stay a loop: one A-optimal state of
    the design main holds W = M⁻¹X (d × n f32, 256 MB a lane).
    """
    g, n = alive.shape
    idx, valid = sample_set_batch(keys, alive, block, cfg.n_samples)
    valid = valid & _slot_mask(block, allowed, alive.device)[:, None, :]

    if resolve_engine(obj):
        gains = obj.filter_gains_batch(state, idx, valid)   # (G, S, n)
    else:
        gains = torch.stack([
            obj.gains(obj.add_set(state, idx[:, s], valid[:, s]))
            for s in range(cfg.n_samples)], dim=1)          # (G, S, n)
    weights = torch.ones((g, cfg.n_samples, n), device=alive.device)
    weights = weights.scatter_add(2, idx, -valid.to(weights.dtype))
    wsum = torch.sum(weights, dim=1)
    est = torch.sum(gains * weights, dim=1) / torch.clamp(wsum, min=1.0)
    return torch.where(wsum > 0, est, obj.gains(state))


def _single_device_hooks(obj, cfg: DashConfig) -> SelectionHooks:
    """Bind the selection loop to a lane-batched objective."""
    block = cfg.block

    def pick_and_add(state, alive, allowed, keys):
        idx, valid = sample_set_from_mask(keys, alive, block)
        valid = valid & _slot_mask(block, allowed, alive.device)
        state = obj.add_set(state, idx, valid)
        return state, torch.sum(valid.to(torch.int32), dim=-1)

    return SelectionHooks(
        value=obj.value,
        sel_mask=lambda state: state.sel_mask,
        estimate_set_gain=lambda state, alive, allowed, keys:
            _estimate_set_gain(obj, state, alive, block, allowed, keys, cfg),
        estimate_elem_gains=lambda state, alive, allowed, keys:
            _estimate_elem_gains(obj, state, alive, block, allowed, keys, cfg),
        pick_and_add=pick_and_add,
    )


def dash_lanes(obj, cfg: DashConfig, keys, opts, alphas) -> DashResult:
    """DASH on len(keys) lanes in lockstep, lane g with guess
    (opts[g], alphas[g]).  Returns a lane-batched :class:`DashResult`."""
    cfg = cfg.resolve(obj.n)
    lanes = len(keys)
    dev = obj.device
    opts = torch.as_tensor(opts, dtype=torch.float32).to(dev).reshape(lanes)
    alphas = torch.as_tensor(alphas, dtype=torch.float32).to(dev)
    alphas = alphas.reshape(lanes)
    alive0 = torch.ones((lanes, obj.n), dtype=torch.bool, device=dev)
    state, _, count, _, trace = run_selection_rounds(
        _single_device_hooks(obj, cfg), cfg, opts, keys, obj.init(lanes),
        alive0, alpha=alphas,
    )
    return DashResult(
        sel_mask=state.sel_mask,
        sel_count=count,
        value=obj.value(state),
        rounds=torch.sum(trace.filter_iters, dim=-1) + cfg.r,
        trace=trace,
        state=state,
    )


def dash(obj, cfg: DashConfig, key, opt, alpha=None, *,
         precision: str | None = None, device=None) -> DashResult:
    """Run DASH for a single (OPT, α) guess — the one-lane case.

    ``alpha`` overrides ``cfg.alpha``; ``precision`` overrides the
    objective's streamed-operand policy for this run.  ``device=None``
    means the card.
    """
    check_device(obj, device)
    if precision is not None:
        obj = with_precision(obj, precision)
    a = cfg.alpha if alpha is None else alpha
    return take_lane(dash_lanes(obj, cfg, [key], [float(opt)], [float(a)]), 0)


def dash_checkpointed(obj, cfg: DashConfig, key, opt, *,
                      resilience: ResilienceConfig, alpha=None,
                      resume: bool = False, failure_injector=None,
                      deadline=None, precision: str | None = None,
                      device=None) -> DashResult:
    """Single-lane DASH stepped round by round from the host, with the
    :class:`SelectionCarry` snapshotted at every round boundary.

    The rounds are :func:`dash`'s (same hooks, same round body), so the
    stepped run commits the fused run's set.  Kill the process anywhere
    and ``resume=True`` replays from the newest complete snapshot in
    ``resilience.ckpt_dir`` to the same set, value and trace as the
    uninterrupted run: each round is a function of the carry alone, and
    the carry is what is saved.  A snapshot needs ``SeedKey`` keys.
    ``failure_injector.check(rho)`` runs before each round; an expired
    ``deadline`` raises ``SelectionDeadlineExceeded``.  One device has
    no responders to lose, so the round ignores the straggler mask
    (``core/distributed.py`` reads it).  ``device=None`` means the card.
    """
    check_device(obj, device)
    if precision is not None:
        obj = with_precision(obj, precision)
    cfg = cfg.resolve(obj.n)
    body = make_round_body(_single_device_hooks(obj, cfg), cfg)
    dev = obj.device
    a = cfg.alpha if alpha is None else alpha
    opt_v = torch.tensor([float(opt)], dtype=torch.float32, device=dev)
    alpha_v = torch.tensor([float(a)], dtype=torch.float32, device=dev)
    carry = initial_carry(cfg, [key], obj.init(1),
                          torch.ones((1, obj.n), dtype=torch.bool, device=dev))
    start_round = 0
    if resume and resilience.ckpt_dir:
        restored = restore_carry(resilience.ckpt_dir, carry, device=dev)
        if restored is not None:
            carry, start_round = restored

    carry = drive_checkpointed_rounds(
        lambda rho, c, arrived: body(rho, c, opt_v, alpha_v),
        carry, cfg, resilience=resilience, start_round=start_round,
        failure_injector=failure_injector, deadline=deadline,
        snapshot_extra={"algo": "dash", "n": int(obj.n)},
    )
    state, _, count, _, trace = carry
    return take_lane(DashResult(
        sel_mask=state.sel_mask,
        sel_count=count,
        value=obj.value(state),
        rounds=torch.sum(trace.filter_iters, dim=-1) + cfg.r,
        trace=trace,
        state=state,
    ), 0)


def opt_guess_lattice(obj, eps: float, n_guesses: int, k: int | None = None):
    """OPT guesses spanning [max_a f(a), k·max_a f(a)] geometrically (a
    single guess gets the geometric midpoint)."""
    g0 = torch.clamp(torch.max(obj.gains(obj.init())), min=1e-12)
    hi = torch.tensor(float(k) if k else 1.0 / eps, dtype=torch.float32,
                      device=g0.device)
    if n_guesses == 1:
        return g0 * torch.sqrt(hi)[None]
    ratio = hi ** (1.0 / (n_guesses - 1))
    i = torch.arange(n_guesses, dtype=torch.float32, device=g0.device)
    return g0 * ratio ** i


def lattice_grid(guesses, alphas):
    """Cross product of the OPT lattice with an α lattice, flattened
    OPT-major: ``(opts, alphas)`` of size n_guesses · n_alphas."""
    guesses = torch.as_tensor(guesses, dtype=torch.float32).reshape(-1)
    alphas = torch.as_tensor(alphas, dtype=torch.float32).reshape(-1)
    alphas = alphas.to(guesses.device)
    g, a = guesses.shape[0], alphas.shape[0]
    return torch.repeat_interleave(guesses, a), alphas.repeat(g)


def nan_to_neginf(v: torch.Tensor) -> torch.Tensor:
    """A numerically degenerate lane (value = NaN) must never win."""
    return torch.where(torch.isnan(v), torch.full_like(v, -torch.inf), v)


def _best_of_lattice(results: DashResult) -> DashResult:
    """On-device argmax over the lane axis — no host sync."""
    return take_lane(results, torch.argmax(nan_to_neginf(results.value)))


def cat_lanes(results):
    """Concatenate lane-batched NamedTuple results along the lane axis
    (nested NamedTuples included)."""
    first = results[0]
    if isinstance(first, tuple):
        return type(first)(*(cat_lanes([r[i] for r in results])
                             for i in range(len(first))))
    return torch.cat(results)


GUESS_MODES = ("batched", "vmap", "loop")


def dash_auto(obj, k: int, key, *, eps: float = 0.2, alpha: float = 0.5,
              r: int = 0, n_samples: int = 8, n_guesses: int = 8,
              trim_frac: float = 0.0, alphas=None,
              guess_mode: str = "batched", return_lattice: bool = False,
              precision: str | None = None, device=None):
    """DASH over the (OPT, α) guess lattice; returns the best solution.

    ``guess_mode="batched"`` (or its alias ``"vmap"``) runs the whole
    lattice as lanes in lockstep; ``"loop"``, the reference's debug mode,
    runs one one-lane DASH per guess, one after another.  Either way the
    best lane is taken by an on-device argmax.  ``alphas`` adds an α
    lattice (OPT-major cross product).  ``return_lattice=True`` also
    returns the lane-batched :class:`DashResult`.  ``device=None`` means
    the card.
    """
    if guess_mode not in GUESS_MODES:
        raise ValueError(f"unknown guess_mode: {guess_mode!r}")
    check_device(obj, device)
    if precision is not None:
        obj = with_precision(obj, precision)
    cfg = DashConfig(k=k, r=r, eps=eps, alpha=alpha, n_samples=n_samples,
                     trim_frac=trim_frac)
    guesses = opt_guess_lattice(obj, eps, n_guesses, k)
    opts, alpha_lanes = lattice_grid(guesses,
                                     [alpha] if alphas is None else alphas)
    keys = key.split(opts.shape[0])
    if guess_mode == "loop":
        results = cat_lanes([
            dash_lanes(obj, cfg, [kk], opts[i:i + 1], alpha_lanes[i:i + 1])
            for i, kk in enumerate(keys)])
    else:
        results = dash_lanes(obj, cfg, keys, opts, alpha_lanes)
    best = _best_of_lattice(results)
    if return_lattice:
        return best, results
    return best
