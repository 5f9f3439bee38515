"""Checkpoint/restart fault tolerance.

A copy of ``repro/runtime/fault_tolerance.py``, which is plain Python.
``run_with_restart`` wraps a step loop: on failure it restores the last
checkpoint and resumes; a run stays deterministic when each step is a
pure function of its state and index (a DASH round of its carry).
``FailureInjector`` provides deterministic failure injection for the
tests (and doubles as a chaos-testing hook for real deployments).

``on_step`` is the side-effect hook (checkpoint saves, metric emission);
its contract is AT-MOST-ONCE per step index: after a restore rewinds the
loop to an earlier step, replayed steps recompute state but do NOT
re-fire the hook — a restore must never double-write a checkpoint or
double-count a metric.  (Steps the hook never reached — e.g. the step
that failed — fire normally once re-executed.)
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger(__name__)


@dataclass
class FailureInjector:
    """Raise at configured steps (once each) to simulate node loss.

    One instance = ONE injection schedule: each step in ``fail_at``
    fires exactly once across every ``check`` caller, which is the
    right semantics for a single restartable loop (the retry must get
    past the failure) but the WRONG one for concurrent requests — a
    shared instance lets the first request consume a step's failure and
    silently shields every other request's schedule.  Launch-scoped
    users (the selection server's chaos mode) must take an independent
    schedule per launch via :meth:`fork`.  ``check`` is serialized with
    a lock so concurrent callers cannot double-fire a step.
    """

    fail_at: tuple = ()
    _fired: set = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def __post_init__(self):
        if isinstance(self.fail_at, int):
            self.fail_at = (self.fail_at,)

    def check(self, step: int):
        with self._lock:
            if step in self.fail_at and step not in self._fired:
                self._fired.add(step)
                raise RuntimeError(f"injected failure at step {step}")

    def fork(self) -> "FailureInjector":
        """A fresh injector with the same ``fail_at`` schedule and its
        own (empty) fired set — per-request/per-launch chaos schedules
        must not share this instance's mutable step counter."""
        return FailureInjector(fail_at=tuple(self.fail_at))


def run_with_restart(
    *,
    total_steps: int,
    make_state: Callable[[], tuple],        # () → (state, start_step)
    restore: Callable[[], tuple | None],    # () → (state, step) or None
    step_fn: Callable[[object, int], object],   # (state, step) → state
    on_step: Callable[[object, int], None] | None = None,
    max_failures: int = 3,
    backoff_s: float = 0.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    fatal: tuple = (),
):
    """Generic restartable loop.  Returns the final state.

    ``restore() is None`` (no checkpoint yet) falls back to
    ``make_state()`` — the cold-restart path, both at entry and after a
    failure that precedes the first save.  ``backoff_s`` spaces restarts
    exponentially (``backoff_s · 2^(failures−1)`` before the n-th
    restart) so a crash-looping fleet doesn't hammer the restore path;
    ``sleep_fn`` is injectable for tests.  Exception types in ``fatal``
    propagate immediately instead of burning restart attempts — the
    serving layer uses this for deadline overruns, which a retry can
    only make later.
    """
    failures = 0
    restored = restore()
    state, step = restored if restored is not None else make_state()
    # At-most-once side effects: everything strictly below `fired_through`
    # already fired in a previous life of this loop.
    fired_through = step
    while step < total_steps:
        try:
            state = step_fn(state, step)
            if on_step and step >= fired_through:
                on_step(state, step)
                fired_through = step + 1
            step += 1
        except Exception as e:  # noqa: BLE001 — any step failure
            if fatal and isinstance(e, tuple(fatal)):
                raise
            failures += 1
            log.warning("step %d failed (%s); restart %d/%d",
                        step, e, failures, max_failures)
            if failures > max_failures:
                raise
            if backoff_s > 0.0:
                sleep_fn(backoff_s * (2.0 ** (failures - 1)))
            restored = restore()
            if restored is None:
                state, step = make_state()
            else:
                state, step = restored
    return state
