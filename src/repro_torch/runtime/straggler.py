"""Straggler mitigation for the selection oracle fleet.

Ports ``repro/runtime/straggler.py``.  DASH's per-round statistics are
Monte-Carlo means over sample replicas; at fleet scale some replicas
return late or stale.  The policy:

  * over-provision: request ``n_samples × overprovision`` replicas,
  * deadline: use whatever arrived by the deadline (simulated by a
    host-side arrival mask, ``simulate_arrivals``),
  * trim: reduce with the symmetric trimmed mean
    (``core.estimators.trimmed_mean``), which bounds the influence of any
    single replica.

``robust_estimate`` is the reduction for a round whose responder set is
incomplete; the sharded runtime (``core/distributed.py``, with
``ResilienceConfig.drop_rate > 0``) applies it, and the single-device
``dash_checkpointed`` ignores the responder mask, as in the reference.  The arrival masks are numpy and equal the
reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.estimators import trimmed_mean


@dataclass(frozen=True)
class StragglerPolicy:
    overprovision: float = 1.5
    trim_frac: float = 0.125
    min_replicas: int = 4

    def replicas_to_request(self, n_samples: int) -> int:
        return max(self.min_replicas, int(n_samples * self.overprovision))


def robust_estimate(values, arrived_mask, policy: StragglerPolicy):
    """Trimmed mean over the replicas that made the deadline.

    values: (R,) per-replica estimates; arrived_mask: (R,) bool.  Missing
    replicas are imputed with the median of the arrived ones (the mean
    of the two middle values for an even count; 0 when none arrived)
    before trimming, so only arrived values influence the result, in
    any order of the replica axis.
    """
    values = torch.as_tensor(values, dtype=torch.float32)
    arrived = torch.as_tensor(arrived_mask, dtype=torch.bool,
                              device=values.device)
    inf = torch.full_like(values, torch.inf)
    ranked = torch.sort(torch.where(arrived, values, inf)).values
    c = torch.sum(arrived.to(torch.int64))
    lo = ranked[torch.clamp((c - 1) // 2, min=0)]
    hi = ranked[torch.clamp(c // 2, max=values.shape[0] - 1)]
    med = torch.where(c > 0, (lo + hi) / 2.0, torch.zeros_like(lo))
    filled = torch.where(arrived, values, med)
    return trimmed_mean(torch.sort(filled).values, policy.trim_frac)


def simulate_arrivals(seed: int, round_idx: int, n_replicas: int,
                      drop_rate: float, *, min_arrived: int = 1) -> np.ndarray:
    """Deterministic per-round deadline-miss mask for the simulator.

    A pure function of ``(seed, round_idx)``, so a resumed run
    regenerates exactly the masks the interrupted run saw.  At least
    ``min_arrived`` replicas always make the deadline (the first slots
    are forced).
    """
    n_replicas = int(n_replicas)
    rng = np.random.default_rng([int(seed), int(round_idx)])
    arrived = rng.random(n_replicas) >= float(drop_rate)
    if int(arrived.sum()) < min_arrived:
        arrived[:min_arrived] = True
    return arrived


def arrivals_for_rounds(seed: int, n_rounds: int, n_replicas: int,
                        drop_rate: float, *,
                        min_arrived: int = 1) -> np.ndarray:
    """(n_rounds, n_replicas) stacked :func:`simulate_arrivals` masks."""
    return np.stack([
        simulate_arrivals(seed, r, n_replicas, drop_rate,
                          min_arrived=min_arrived)
        for r in range(int(n_rounds))
    ])


__all__ = [
    "StragglerPolicy",
    "robust_estimate",
    "simulate_arrivals",
    "arrivals_for_rounds",
]
