"""Resilience of the port: restarts, hedged resumes, the straggler
simulator and, on a mesh, elastic resharding (``runtime/elastic.py``)."""

from repro_torch.runtime.elastic import (
    elastic_mesh,
    gather_tree,
    reshard_tree,
)
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
    "elastic_mesh",
    "gather_tree",
    "reshard_tree",
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
