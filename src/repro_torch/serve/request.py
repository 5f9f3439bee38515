"""Request and reply types of the selection service.

Ports ``repro/serve/request.py``.  A :class:`SelectRequest` is one
tenant's ``(dataset, k, key, deadline)`` ask; a :class:`SelectReply` is
its terminal answer.  Every admitted request gets exactly one reply — a
result, or an explicit rejection with a retry-after hint — never a hang.
Caller bugs (``k <= 0``, an algorithm off the ladder, an unregistered
dataset) raise ``ValueError`` at submit time; overload is not a caller
bug and comes back as a ``REJECTED`` reply.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Terminal statuses — one of these per admitted request, always.
OK = "ok"              # served; sel_mask/value populated
REJECTED = "rejected"  # shed (queue pressure or drain deadline); retry later
FAILED = "failed"      # launch died through the whole hedge budget


@dataclass
class SelectRequest:
    """One selection request against a registered dataset.

    ``dataset`` is a name or fingerprint from
    ``SelectionServer.register``; ``key`` is an int seed (a ``SeedKey``)
    or any port key (``core/random.py::Key``); ``deadline_s`` is the
    request's wall-clock budget from admission (``None``: no deadline,
    never degraded for time); ``opt``/``alpha`` optionally pin DASH's
    (OPT, α) guess — by default the server derives OPT from a cached
    TOP-k probe.
    """

    dataset: str
    k: int
    key: Any
    algo: str = "dash"
    deadline_s: float | None = None
    opt: float | None = None
    alpha: float | None = None


@dataclass
class SelectReply:
    """The terminal reply for one request.

    ``tier`` names the algorithm that served (``degraded`` is True when
    it is below the requested one on the ladder); ``attempts`` counts
    hedged launch executions (> 1: the launch died and was resumed);
    ``retry_after_s`` is non-zero exactly when ``status == REJECTED``.
    ``sel_idx`` and ``sel_mask`` are host numpy arrays.
    """

    request_id: int
    status: str
    tier: str | None = None
    degraded: bool = False
    sel_idx: Any = None          # selected indices, host ints
    sel_mask: Any = None         # (n,) bool
    sel_count: int | None = None
    value: float | None = None
    attempts: int = 1
    retry_after_s: float = 0.0
    latency_s: float | None = None
    detail: str = ""
    extras: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == OK


__all__ = ["OK", "REJECTED", "FAILED", "SelectRequest", "SelectReply"]
