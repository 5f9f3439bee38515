"""Hedged retries for serving launches: resume, don't restart.

A copy of ``repro/runtime/hedging.py``, which is plain Python; the
selection server that uses it is ROADMAP item 13.

A serving launch that dies mid-flight (worker loss, injected chaos)
must be retried without blowing its latency budget twice.  The policy
here composes :func:`repro_torch.runtime.fault_tolerance.run_with_restart`
with in-memory round snapshots: ``run_resumable`` steps a launch one
unit at a time (a DASH round for the selection server's dash tier, the
whole launch for one-shot tiers), keeps the newest completed-step state
as the hedge snapshot, and on failure backs off exponentially and
resumes from that snapshot — attempt N replays only the steps since the
last boundary, so a retried DASH request commits the bitwise-identical
set an unfailed run would (each step is a pure function of the carry).

On a single host the hedge degenerates to sequential backed-off retries;
the snapshot contract is what a true multi-launch hedge would share.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.runtime.fault_tolerance import run_with_restart


@dataclass(frozen=True)
class HedgePolicy:
    """Retry budget for one serving launch.

    ``max_attempts`` counts executions, not failures (1 = no retry);
    ``backoff_s`` seeds the exponential spacing between attempts
    (``backoff_s · 2^(n−1)`` before retry n); ``sleep_fn`` is injectable
    so tests and benchmarks don't actually sleep.
    """

    max_attempts: int = 3
    backoff_s: float = 0.02
    sleep_fn: Callable[[float], None] = time.sleep


class HedgeExhausted(RuntimeError):
    """Raised when every attempt of a hedged launch failed — the caller
    (the selection server) converts this into a terminal FAILED reply,
    never a hang."""


def run_resumable(
    total_steps: int,
    init_state: Any,
    step_fn: Callable[[Any, int], Any],
    *,
    policy: HedgePolicy | None = None,
    fatal: tuple = (),
    on_boundary: Callable[[Any, int], None] | None = None,
) -> tuple[Any, int]:
    """Run ``total_steps`` of ``step_fn(state, step) -> state`` with
    resume-from-snapshot retries.  Returns ``(final_state, attempts)``.

    After every completed step the newest state is kept (keep-last-1
    in-memory snapshot); a failure restores it and re-enters the loop at
    that boundary.  A failure before the first boundary cold-restarts
    from ``init_state``.  Exception types in ``fatal`` propagate
    unwrapped and unretried (deadline overruns); anything else that
    survives ``policy.max_attempts`` raises :class:`HedgeExhausted`
    chained to the last failure.
    """
    policy = policy or HedgePolicy()
    snap: dict[int, Any] = {}
    attempts = {"n": 0}

    def make_state():
        return init_state, 0

    def restore():
        # Called once at entry and once per restart — exactly the
        # attempt count.
        attempts["n"] += 1
        if not snap:
            return None
        s = max(snap)
        return snap[s], s

    def on_step(state, step):
        snap.clear()
        snap[step + 1] = state
        if on_boundary is not None:
            on_boundary(state, step)

    try:
        final = run_with_restart(
            total_steps=total_steps,
            make_state=make_state,
            restore=restore,
            step_fn=step_fn,
            on_step=on_step,
            max_failures=policy.max_attempts - 1,
            backoff_s=policy.backoff_s,
            sleep_fn=policy.sleep_fn,
            fatal=fatal,
        )
    except Exception as e:  # noqa: BLE001 — classify, then re-raise
        if fatal and isinstance(e, tuple(fatal)):
            raise
        raise HedgeExhausted(
            f"launch failed after {attempts['n']} attempts"
        ) from e
    return final, attempts["n"]


__all__ = ["HedgePolicy", "HedgeExhausted", "run_resumable"]
