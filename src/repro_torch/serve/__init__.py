"""Selection as a service: overload- and failure-hardened batched select().

Ports ``repro/serve/``: many tenants' ``(dataset, k, key, deadline)``
requests are bucketed by ``(fingerprint, k, algo)``, padded to a power
of two of lanes and run as one lane-batched DASH stepped round by round
from the host, behind bounded admission queues with explicit load
shedding, a deadline-driven degradation ladder, hedged resume-not-
restart retries and a fingerprint-keyed objective cache with warm
column updates.  ``SelectionServer(device=None)`` runs on the card.
"""

from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
    bucket_key,
    padded_batch,
)
from repro_torch.serve.batcher import (
    BatchOutput,
    DashBucket,
    build_dash_bucket,
    build_opt_probe,
    build_single_shot,
)
from repro_torch.serve.cache import (
    DatasetEntry,
    ObjectiveCache,
    chained_fingerprint,
    fingerprint_arrays,
    make_factory,
)
from repro_torch.serve.degradation import (
    DegradationLadder,
    LatencyModel,
    plan_tier,
)
from repro_torch.serve.request import (
    FAILED,
    OK,
    REJECTED,
    SelectReply,
    SelectRequest,
)
from repro_torch.serve.server import SelectionServer, ServePolicy

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "BatchOutput",
    "DashBucket",
    "DatasetEntry",
    "DegradationLadder",
    "FAILED",
    "LatencyModel",
    "OK",
    "ObjectiveCache",
    "REJECTED",
    "SelectReply",
    "SelectRequest",
    "SelectionServer",
    "ServePolicy",
    "bucket_key",
    "build_dash_bucket",
    "build_opt_probe",
    "build_single_shot",
    "chained_fingerprint",
    "fingerprint_arrays",
    "make_factory",
    "padded_batch",
    "plan_tier",
]
