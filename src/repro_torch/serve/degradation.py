"""Deadline-aware degradation along a declared algorithm ladder.

Ports ``repro/serve/degradation.py``.  When a request's remaining
deadline cannot fit the algorithm it asked for, the server downgrades
it along ``dash`` → ``stochastic_greedy`` → ``topk`` and labels the
reply with the tier that served.  The floor tier always serves: a
request with any budget left gets a (possibly degraded) result, and
only a spent budget is rejected.

Cost prediction starts from the registry's adaptivity
(``core/algorithms.py::algorithm_cost``) times a per-round prior, then
switches to an EWMA of the observed launch latencies of each tier.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.algorithms import algorithm_cost


@dataclass(frozen=True)
class DegradationLadder:
    """Ordered quality → speed tiers.  ``tiers[0]`` is the best quality;
    ``tiers[-1]`` is the floor that must fit any non-zero budget."""

    tiers: tuple = ("dash", "stochastic_greedy", "topk")

    def downgrades(self, algo: str) -> tuple:
        """The tiers that may serve a request for ``algo``: itself, then
        everything below it on the ladder."""
        if algo not in self.tiers:
            raise ValueError(
                f"algorithm {algo!r} is not on the serving ladder "
                f"{self.tiers}"
            )
        return self.tiers[self.tiers.index(algo):]

    @property
    def floor(self) -> str:
        return self.tiers[-1]


class LatencyModel:
    """Per-tier launch-latency estimate: a prior of ``round_cost_prior_s``
    per adaptive round (the reference's default), then an EWMA of the
    observed launches.  Estimates are per tier, not per batch shape."""

    def __init__(self, round_cost_prior_s: float = 0.02,
                 decay: float = 0.3):
        self.round_cost_prior_s = float(round_cost_prior_s)
        self.decay = float(decay)
        self._ewma: dict[str, float] = {}

    def predict(self, tier: str, n: int, k: int) -> float:
        if tier in self._ewma:
            return self._ewma[tier]
        rounds = max(1, int(algorithm_cost(tier, n, k)["adaptive_rounds"]))
        return rounds * self.round_cost_prior_s

    def observe(self, tier: str, seconds: float):
        if seconds <= 0:
            return
        if tier not in self._ewma:
            self._ewma[tier] = float(seconds)
        else:
            self._ewma[tier] = ((1 - self.decay) * self._ewma[tier]
                                + self.decay * float(seconds))

    def observed(self) -> dict[str, float]:
        """Each observed tier's EWMA, in seconds."""
        return dict(self._ewma)


def plan_tier(ladder: DegradationLadder, model: LatencyModel,
              requested: str, n: int, k: int,
              remaining_s: float | None) -> tuple[str, bool]:
    """``(tier, degraded)`` for one request: the best tier whose predicted
    latency fits ``remaining_s`` (``None``: the requested tier).  The
    ladder floor is returned even when nothing fits; the caller rejects
    requests whose budget is already spent."""
    options = ladder.downgrades(requested)
    if remaining_s is None:
        return options[0], False
    for tier in options:
        if model.predict(tier, n, k) <= remaining_s:
            return tier, tier != requested
    return options[-1], options[-1] != requested


__all__ = ["DegradationLadder", "LatencyModel", "plan_tier"]
