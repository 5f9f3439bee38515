"""Single-device resilience of the port: restarts, hedged resumes and
the straggler simulator (``runtime/elastic.py`` needs a mesh: ROADMAP
item 11)."""

from repro_torch.runtime.fault_tolerance import (
    FailureInjector,
    run_with_restart,
)
from repro_torch.runtime.hedging import (
    HedgeExhausted,
    HedgePolicy,
    run_resumable,
)
from repro_torch.runtime.straggler import (
    StragglerPolicy,
    arrivals_for_rounds,
    robust_estimate,
    simulate_arrivals,
)

__all__ = [
    "run_with_restart",
    "FailureInjector",
    "HedgePolicy",
    "HedgeExhausted",
    "run_resumable",
    "StragglerPolicy",
    "robust_estimate",
    "simulate_arrivals",
    "arrivals_for_rounds",
]
