"""Selection as a service under offered load and injected failures.

The port of ``examples/serve_selection.py``: a short serving run with
offered load past the admission caps, every launch's chaos schedule
killing round 1, and a tight deadline on part of the traffic.  Every
submitted request must end with one terminal reply (a result, a labeled
degraded result, or a rejection with a retry-after hint), and a hedged
DASH retry must commit the set of the unfailed run, bit for bit.  Exits
non-zero on any violation.

    PYTHONPATH=src python -m repro_torch.serve_selection --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.objectives import normalize_columns
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.runtime.hedging import HedgePolicy
from repro_torch.serve import (
    FAILED,
    OK,
    REJECTED,
    AdmissionPolicy,
    LatencyModel,
    SelectionServer,
    SelectRequest,
)


def make_server(chaos=None, device=None) -> SelectionServer:
    # The upper tiers are seeded to "cost" 100 s, so the deadline slice
    # of the traffic degrades deterministically, with no wall-clock race.
    lm = LatencyModel()
    lm.observe("dash", 100.0)
    lm.observe("stochastic_greedy", 100.0)
    srv = SelectionServer(
        admission=AdmissionPolicy(max_batch=4, max_queue=4, max_pending=8),
        chaos=chaos, latency=lm,
        hedge=HedgePolicy(max_attempts=3, backoff_s=0.0,
                          sleep_fn=lambda s: None),
        device=device)
    rng = np.random.default_rng(0)
    d, n = 96, 64
    X = normalize_columns(torch.from_numpy(
        np.asarray(rng.normal(size=(d, n)), np.float32)))
    y = np.asarray(rng.normal(size=(d,)), np.float32)
    srv.register("tenant", "regression", X, y, kmax=8)
    return srv


def offered_load() -> list:
    reqs = [SelectRequest("tenant", 8, s) for s in range(12)]
    # A bucket of its own (k = 6) whose deadline the seeded latency model
    # says the upper tiers cannot meet: served degraded at the floor.
    reqs += [SelectRequest("tenant", 6, 100 + s, deadline_s=5.0)
             for s in range(2)]
    return reqs


def violations(baseline: list, replies: list) -> tuple[list, dict]:
    """The contract's violations, and the counts of the chaotic run."""
    bad = []
    counts = dict(offered=len(replies), served=0, degraded=0, shed=0,
                  hedged=0)
    if len(replies) != len(baseline):
        bad.append("the two runs replied to different numbers of requests")
    for i, (base, rep) in enumerate(zip(baseline, replies)):
        if rep is None:
            bad.append(f"request {i} dropped without a reply")
            continue
        if rep.status not in (OK, REJECTED, FAILED):
            bad.append(f"request {i}: unknown status {rep.status!r}")
        if rep.status == FAILED:
            bad.append(f"request {i} failed: the hedge budget should "
                       f"absorb one failure ({rep.detail})")
        if rep.status == REJECTED:
            if not rep.retry_after_s > 0:
                bad.append(f"request {i} rejected without a retry hint")
            counts["shed"] += 1
            continue
        counts["served"] += 1
        if rep.degraded:
            if rep.tier in ("dash", None):
                bad.append(f"request {i} degraded but served at {rep.tier}")
            counts["degraded"] += 1
        if rep.attempts > 1:
            counts["hedged"] += 1
            if base.status != OK or not np.array_equal(base.sel_mask,
                                                       rep.sel_mask):
                bad.append(f"request {i}: the hedged retry's set differs "
                           "from the unfailed run's")
    if not counts["hedged"]:
        bad.append("the chaos schedule never exercised the hedge")
    if not counts["degraded"]:
        bad.append("the deadline traffic never exercised the ladder")
    return bad, counts


def main(device=None) -> dict:
    """Serve the offered load twice, without and with chaos; raises
    ``SystemExit(1)`` on any violation of the serving contract."""
    dev = resolve_device(device)
    baseline = make_server(device=dev).serve(offered_load())
    chaotic = make_server(chaos=FailureInjector(fail_at=(1,)), device=dev)
    replies = chaotic.serve(offered_load())
    bad, counts = violations(baseline, replies)
    print(f"serve smoke: {counts['offered']} offered, "
          f"{counts['served']} served ({counts['degraded']} degraded), "
          f"{counts['shed']} shed with retry hints, {counts['hedged']} "
          "hedged-resume bitwise-verified")
    if bad:
        for b in bad:
            print(f"violation: {b}", file=sys.stderr)
        raise SystemExit(1)
    return dict(counts, baseline=baseline, replies=replies,
                stats=chaotic.stats)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    main(device=ap.parse_args().device)
