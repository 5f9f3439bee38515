"""The DASH round/filter control flow, run in lockstep over guess lanes.

Ports the single-device core of ``repro/core/selection_loop.py``.  Per
round (t = (1−ε)(OPT − f(S)), block b = ⌈k/r⌉):

    est ← Ê_{R~U(X)}[f_S(R)]
    while est < α²·t/r and iterations < ⌈log_{1+ε/2} n⌉ and |X| > 0:
        X ← X \\ { a : Ê_R[f_{S∪R}(a)] < α(1+ε/2)·t/k }       (filter)
        est ← Ê_{R~U(X)}[f_S(R)]
    S ← S ∪ R,  R ~ U(X)                                      (commit)

The JAX reference vmaps this loop over the (OPT, α) lattice, so its
inner ``lax.while_loop`` runs while any lane is active and freezes the
carry of finished lanes.  Here the lanes are an explicit leading axis and
the inner loop is a host loop with the same semantics: each lane keeps
its own active flag, a finished lane's alive mask, key, estimate and
iteration count are frozen with ``torch.where``, and the loop runs while
any lane is active — one host sync per filter iteration.  The outer
rounds are a plain ``for`` loop.  Keys are split with the same counts,
in the same order, as the reference: 3 per round, 3 per filter
iteration.

Resilience: the round boundary is the snapshot point.  The whole loop
state is one :class:`SelectionCarry` and one round is a function of
``(carry, round, OPT, α)`` alone, so :func:`drive_checkpointed_rounds`
steps the rounds from the host and snapshots the carry after each one
through ``ckpt/checkpoint.py`` (:class:`RoundCheckpointer`: atomic,
written by a thread from a host copy), and a run killed anywhere and
resumed from its newest complete snapshot commits the set the
uninterrupted run commits.  The carry's keys are Python objects: a
snapshot records each ``SeedKey`` as its ``seed`` (uint64) and ``host``
flag (:func:`carry_snapshot`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.random import SeedKey


class DashTrace(NamedTuple):
    values: torch.Tensor        # (G, r) f(S) after each round
    alive: torch.Tensor         # (G, r) surviving |X| after each round
    filter_iters: torch.Tensor  # (G, r) inner-loop iterations used
    est_set_gain: torch.Tensor  # (G, r) final Ê[f_S(R)] per round


class SelectionCarry(NamedTuple):
    """The between-round loop state of all lanes."""

    state: Any
    alive: torch.Tensor         # (G, n) bool
    count: torch.Tensor         # (G,) int32
    key: list                   # one key per lane
    trace: DashTrace


@dataclass(frozen=True)
class DashConfig:
    k: int                     # cardinality constraint
    r: int = 0                 # outer rounds (0 → ⌈log2 n⌉, clipped to k)
    eps: float = 0.2
    alpha: float = 0.5         # differential-submodularity parameter guess
    n_samples: int = 8         # Monte-Carlo sets per estimate
    trim_frac: float = 0.0     # outlier trimming per side
    max_filter_iters: int = 0  # 0 → ⌈log_{1+ε/2} n⌉ (Lemma 21 cap)

    def resolve(self, n: int) -> "DashConfig":
        r = self.r or max(1, min(self.k, int(math.ceil(math.log2(max(n, 2))))))
        cap = self.max_filter_iters or (
            int(math.ceil(math.log(max(n, 2)) / math.log1p(self.eps / 2.0))) + 1
        )
        return DashConfig(
            k=self.k, r=r, eps=self.eps, alpha=self.alpha,
            n_samples=self.n_samples, trim_frac=self.trim_frac,
            max_filter_iters=cap,
        )

    @property
    def block(self) -> int:
        """⌈k/r⌉ — elements committed per outer round (resolved cfg only)."""
        return max(1, -(-self.k // max(self.r, 1)))


def _count_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.sum(alive.to(torch.int32), dim=-1)


@dataclass(frozen=True)
class SelectionHooks:
    """Oracle bundle binding the loop to a runtime; all lane-batched.

      value(state) -> (G,) f(S)
      sel_mask(state) -> (G, n) bool
      estimate_set_gain(state, alive, allowed, keys) -> (G,) Ê[f_S(R)]
      estimate_elem_gains(state, alive, allowed, keys) -> (G, n)
      pick_and_add(state, alive, allowed, keys) -> (state, (G,) #added)
      count_alive(alive) -> (G,) survivor counts

    ``allowed`` (G,) is the remaining capacity k − |S|; ``keys`` holds one
    key per lane.
    """

    value: Callable[[Any], torch.Tensor]
    sel_mask: Callable[[Any], torch.Tensor]
    estimate_set_gain: Callable[..., torch.Tensor]
    estimate_elem_gains: Callable[..., torch.Tensor]
    pick_and_add: Callable[..., tuple]
    count_alive: Callable[[torch.Tensor], torch.Tensor] = _count_alive


def initial_carry(cfg: DashConfig, keys: list, state0: Any,
                  alive0: torch.Tensor) -> SelectionCarry:
    """Round-0 carry for a ``resolve``-d config (zeroed trace/count)."""
    g, dev = alive0.shape[0], alive0.device
    zf = torch.zeros((g, cfg.r), device=dev)
    zi = torch.zeros((g, cfg.r), dtype=torch.int32, device=dev)
    return SelectionCarry(
        state=state0, alive=alive0,
        count=torch.zeros((g,), dtype=torch.int32, device=dev),
        key=list(keys),
        trace=DashTrace(values=zf, alive=zi, filter_iters=zi.clone(),
                        est_set_gain=zf.clone()),
    )


def _set_column(x: torch.Tensor, rho: int, v: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[:, rho] = v.to(x.dtype)
    return x


def make_round_body(hooks: SelectionHooks, cfg: DashConfig):
    """One DASH round over all lanes:
    ``round_body(rho, carry, opt (G,), alpha (G,)) -> SelectionCarry``."""
    k, r = cfg.k, cfg.r

    def round_body(rho: int, carry: SelectionCarry, opt, alpha):
        state, alive, count, keys, trace = carry
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=alive.device)
        opt = torch.as_tensor(opt, dtype=torch.float32, device=alive.device)
        alpha2 = alpha * alpha
        splits = [key.split(3) for key in keys]
        keys = [s[0] for s in splits]
        value = hooks.value(state)
        t = torch.clamp((1.0 - cfg.eps) * (opt - value), min=0.0)
        thr_set = alpha2 * t / r
        thr_elem = alpha * (1.0 + cfg.eps / 2.0) * t / k
        allowed = torch.clamp(k - count, min=0)

        est = hooks.estimate_set_gain(state, alive, allowed,
                                      [s[1] for s in splits])
        iters = torch.zeros_like(count)
        sel = hooks.sel_mask(state)
        while True:
            active = ((est < thr_set) & (iters < cfg.max_filter_iters)
                      & (hooks.count_alive(alive) > 0))
            act = active.tolist()          # the one host sync per iteration
            if not any(act):
                break
            sub = [key.split(3) for key in keys]
            eg = hooks.estimate_elem_gains(state, alive, allowed,
                                           [s[1] for s in sub])
            alive_new = alive & (eg >= thr_elem[:, None]) & ~sel
            est_new = hooks.estimate_set_gain(state, alive_new, allowed,
                                              [s[2] for s in sub])
            alive = torch.where(active[:, None], alive_new, alive)
            est = torch.where(active, est_new, est)
            iters = iters + active.to(iters.dtype)
            keys = [s[0] if a else key for s, a, key in zip(sub, act, keys)]

        state, added = hooks.pick_and_add(state, alive, allowed,
                                          [s[2] for s in splits])
        alive = alive & ~hooks.sel_mask(state)
        trace = DashTrace(
            values=_set_column(trace.values, rho, hooks.value(state)),
            alive=_set_column(trace.alive, rho, hooks.count_alive(alive)),
            filter_iters=_set_column(trace.filter_iters, rho, iters),
            est_set_gain=_set_column(trace.est_set_gain, rho, est),
        )
        return SelectionCarry(state=state, alive=alive,
                              count=count + added.to(count.dtype), key=keys,
                              trace=trace)

    return round_body


def run_selection_rounds(hooks: SelectionHooks, cfg: DashConfig, opt, keys,
                         state0: Any, alive0: torch.Tensor,
                         alpha=None) -> SelectionCarry:
    """Drive the r DASH rounds for all lanes.  ``cfg`` must already be
    ``resolve``-d; ``opt`` and ``alpha`` are (G,) per-lane guesses
    (``alpha=None`` uses ``cfg.alpha`` on every lane)."""
    g = alive0.shape[0]
    if alpha is None:
        alpha = torch.full((g,), cfg.alpha, dtype=torch.float32)
    body = make_round_body(hooks, cfg)
    carry = initial_carry(cfg, keys, state0, alive0)
    for rho in range(cfg.r):
        carry = body(rho, carry, opt, alpha)
    return carry


# ---------------------------------------------------------------------------
# resilience: snapshots, deadlines, the host-stepped round driver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResilienceConfig:
    """How a selection run snapshots, resumes and rides out stragglers.

    With ``ckpt_dir`` set, the host-stepped drivers save the
    :class:`SelectionCarry` through ``ckpt/checkpoint.py`` every
    ``every`` completed rounds (atomic rename; ``async_save`` hands the
    write to a thread so the device keeps stepping), pruning to the
    ``keep_last`` newest complete snapshots.

    Straggler simulation: ``drop_rate > 0`` makes each round's
    Monte-Carlo replicas miss the deadline independently with that
    probability (``runtime/straggler.py::simulate_arrivals``, a pure
    function of ``(straggler_seed, round)``, so an interrupted and a
    resumed run see the same arrivals; at least ``min_arrived`` arrive).
    ``policy`` (a ``StragglerPolicy``; the default one when None) sets
    the robust reduction of an incomplete round.  Only the sharded
    runtime (``core/distributed.py``) reads the responder mask: one
    device has no responders to lose, so ``dash_checkpointed`` ignores
    it, as in the reference.
    """

    ckpt_dir: str | None = None
    every: int = 1
    keep_last: int = 3
    async_save: bool = True
    drop_rate: float = 0.0
    straggler_seed: int = 0
    min_arrived: int = 1
    policy: Any = None

    @property
    def straggler(self) -> bool:
        return self.drop_rate > 0.0

    def resolved_policy(self):
        if self.policy is not None:
            return self.policy
        from repro_torch.runtime.straggler import StragglerPolicy

        return StragglerPolicy()


class Deadline:
    """A monotonic wall-clock budget for a host-stepped selection run;
    ``clock`` is injectable, and the budget starts at construction."""

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self.clock = clock
        self.t0 = clock()

    def elapsed(self) -> float:
        return self.clock() - self.t0

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


class SelectionDeadlineExceeded(RuntimeError):
    """A host-stepped selection run ran out of deadline budget.

    Carries the number of completed rounds and the partial
    :class:`SelectionCarry`, so that a caller can degrade or reject
    explicitly.  A retry cannot help, so the resilience wrappers take it
    as fatal (``fatal=`` of ``run_with_restart`` / ``run_resumable``).
    """

    def __init__(self, rounds_done: int, carry: Any = None):
        super().__init__(
            f"selection deadline expired after {int(rounds_done)} "
            f"completed rounds"
        )
        self.rounds_done = int(rounds_done)
        self.carry = carry


def keys_snapshot(keys) -> dict:
    """The lanes' keys as arrays: ``seed`` (uint64) and ``host``.  Only
    ``SeedKey`` has this form; another key type raises ``TypeError``."""
    for key in keys:
        if not isinstance(key, SeedKey):
            raise TypeError(
                f"a {type(key).__name__} key has no snapshot form; a "
                "checkpointed run (ResilienceConfig.ckpt_dir) needs "
                "SeedKey keys")
    return {"seed": np.array([k.seed & ((1 << 64) - 1) for k in keys],
                             dtype=np.uint64),
            "host": np.array([k.host for k in keys], dtype=bool)}


def carry_snapshot(carry: SelectionCarry) -> SelectionCarry:
    """The carry with its keys in snapshot form — what a checkpoint
    holds."""
    return carry._replace(key=keys_snapshot(carry.key))


def carry_from_snapshot(snap: SelectionCarry) -> SelectionCarry:
    seeds, hosts = snap.key["seed"].tolist(), snap.key["host"].tolist()
    return snap._replace(key=[SeedKey(int(s), bool(h))
                              for s, h in zip(seeds, hosts)])


class RoundCheckpointer:
    """Round-boundary snapshots of the carry, written by a
    ``ckpt/checkpoint.py::CheckpointManager`` (host copy, then a writer
    thread; ``async_save=False`` waits for each write).  The atomic
    rename in ``save_checkpoint`` means a kill at any point leaves the
    newest complete snapshot restorable.
    """

    def __init__(self, cfg: ResilienceConfig):
        from repro_torch.ckpt.checkpoint import CheckpointManager

        if not cfg.ckpt_dir:
            raise ValueError("RoundCheckpointer needs ResilienceConfig.ckpt_dir")
        self.cfg = cfg
        self.manager = CheckpointManager(cfg.ckpt_dir, every=1,
                                         keep=cfg.keep_last)

    def save(self, rounds_done: int, carry, *, extra: dict | None = None,
             blocking: bool = False):
        """``blocking=True`` writes before returning even when the config
        saves asynchronously."""
        self.manager.maybe_save(
            rounds_done, carry_snapshot(carry),
            blocking=blocking or not self.cfg.async_save,
            extra={**(extra or {}), "round": int(rounds_done)})

    def wait(self, *, raise_errors: bool = True):
        self.manager.wait(raise_errors=raise_errors)


def restore_carry(ckpt_dir: str, like: SelectionCarry, *, device=None):
    """The carry of the newest complete snapshot in the structure of
    ``like``, and the rounds it had completed; ``None`` when the
    directory holds no complete snapshot."""
    from repro_torch.ckpt.checkpoint import (
        latest_complete_step,
        read_manifest,
        restore_checkpoint,
    )

    step = latest_complete_step(ckpt_dir)
    if step is None:
        return None
    snap, _ = restore_checkpoint(ckpt_dir, carry_snapshot(like), step=step,
                                 device=device)
    rounds = int(read_manifest(ckpt_dir, step)["extra"]["round"])
    return carry_from_snapshot(snap), rounds


def round_arrivals(resilience: ResilienceConfig | None, cfg: DashConfig,
                   rho: int) -> np.ndarray:
    """The round's (n_samples,) responder mask — all ones unless the
    resilience config simulates deadline misses.  Pure in (config, ρ)."""
    if resilience is not None and resilience.straggler:
        from repro_torch.runtime.straggler import simulate_arrivals

        return simulate_arrivals(
            resilience.straggler_seed, rho, cfg.n_samples,
            resilience.drop_rate, min_arrived=resilience.min_arrived)
    return np.ones((cfg.n_samples,), bool)


def drive_checkpointed_rounds(
    step_fn: Callable[[int, SelectionCarry, np.ndarray], SelectionCarry],
    carry: SelectionCarry,
    cfg: DashConfig,
    *,
    resilience: ResilienceConfig | None = None,
    start_round: int = 0,
    failure_injector=None,
    snapshot_extra: dict | None = None,
    deadline: Deadline | None = None,
    snapshot_view: Callable[[SelectionCarry], Any] | None = None,
) -> SelectionCarry:
    """Host-driven round loop with snapshots — the resilient twin of
    :func:`run_selection_rounds`.

    ``step_fn(rho, carry, arrived)`` is one round (built from
    :func:`make_round_body`); ``arrived`` is the round's responder mask
    (:func:`round_arrivals`).  ``failure_injector.check(rho)`` runs
    before each round, so an injected kill loses at most the rounds
    since the last snapshot.  An expired ``deadline`` raises
    :class:`SelectionDeadlineExceeded` (with the partial carry) at the
    next round boundary.  With ``resilience.ckpt_dir`` set, a key
    without a snapshot form raises ``TypeError`` before round 0.
    ``snapshot_view(carry)`` (the sharded runtime's) gives what a save
    writes, the global view of a sharded carry, or ``None`` on a rank
    that writes nothing; it is called on every rank at every save.
    """
    ckpt = (RoundCheckpointer(resilience)
            if resilience is not None and resilience.ckpt_dir else None)
    if ckpt is not None:
        keys_snapshot(carry.key)
    try:
        for rho in range(start_round, cfg.r):
            if deadline is not None and deadline.expired():
                raise SelectionDeadlineExceeded(rho, carry)
            if failure_injector is not None:
                failure_injector.check(rho)
            carry = step_fn(rho, carry, round_arrivals(resilience, cfg, rho))
            if ckpt is not None and (rho + 1) % resilience.every == 0:
                view = carry if snapshot_view is None else snapshot_view(
                    carry)
                if view is not None:
                    ckpt.save(rho + 1, view, extra=snapshot_extra)
    finally:
        if ckpt is not None:
            # Let an in-flight write land (so that a restore after an
            # injected failure sees a deterministic newest snapshot)
            # without masking the propagating exception.
            ckpt.wait(raise_errors=False)
    if ckpt is not None:
        ckpt.wait()
    return carry
