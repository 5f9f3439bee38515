"""Admission control: bounded queues, bucketed shapes, explicit shedding.

Ports ``repro/serve/admission.py`` (pure host code):

* **Bucketing** — requests are grouped by :func:`bucket_key`
  ``(dataset fingerprint, k, algo)`` and run in lane counts padded to
  powers of two up to ``max_batch`` (:func:`padded_batch`).  Pad lanes
  replicate lane 0's inputs and are discarded.  On the card the lane
  count also bounds the shapes the kernels' plans see.

* **Bounded queues + load shedding** — per-bucket and global queue
  depths are hard caps.  An admit over either cap is refused with a
  non-zero retry-after hint derived from the observed drain rate, not
  silently queued.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class AdmissionPolicy:
    """Queue and batch-shape limits.

    ``max_batch`` caps lanes per launch; ``max_queue`` bounds each
    bucket's FIFO; ``max_pending`` bounds the queued requests across
    buckets; ``drain_rate_hint`` (requests/s) seeds the retry-after
    estimate until real drains are observed; ``min_retry_after_s``
    floors the hint so that a rejection never carries a zero backoff.
    """

    max_batch: int = 8
    max_queue: int = 32
    max_pending: int = 64
    drain_rate_hint: float = 50.0
    min_retry_after_s: float = 0.05


def bucket_key(req) -> tuple:
    """The bucket of a request — requests sharing a key can ride one
    launch.  ``dataset`` must already be resolved to a fingerprint."""
    return (req.dataset, int(req.k), req.algo)


def padded_batch(b: int, max_batch: int) -> int:
    """Lane count for a batch of ``b`` requests: the next power of two,
    clipped to ``max_batch``."""
    if b <= 0:
        raise ValueError(f"batch must be positive, got {b}")
    b = min(b, max_batch)
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch)


class AdmissionController:
    """Bounded multi-bucket FIFO with drain-rate-aware shedding."""

    def __init__(self, policy: AdmissionPolicy | None = None,
                 clock=time.monotonic):
        self.policy = policy or AdmissionPolicy()
        self.clock = clock
        self._queues: dict[tuple, deque] = {}
        self._order: deque = deque()        # bucket keys, oldest first
        self._pending = 0
        # Drain-rate EWMA (requests/s) feeding the retry-after hint.
        self._rate = float(self.policy.drain_rate_hint)

    def pending(self) -> int:
        return self._pending

    def retry_after(self, backlog: int) -> float:
        """Hint for a shed request: time for the backlog to drain at the
        observed rate, floored at the policy minimum."""
        return max(self.policy.min_retry_after_s,
                   backlog / max(self._rate, 1e-6))

    def try_admit(self, item, key: tuple) -> tuple[bool, float]:
        """Admit ``item`` into bucket ``key``: ``(True, 0.0)``, or
        ``(False, retry_after_s > 0)`` when the bucket or the global cap
        is full."""
        q = self._queues.get(key)
        if self._pending >= self.policy.max_pending:
            return False, self.retry_after(self._pending)
        if q is not None and len(q) >= self.policy.max_queue:
            return False, self.retry_after(len(q))
        if q is None:
            q = self._queues[key] = deque()
        if key not in self._order:
            self._order.append(key)
        q.append(item)
        self._pending += 1
        return True, 0.0

    def next_batch(self) -> tuple[tuple, list] | None:
        """Pop up to ``max_batch`` requests from the oldest non-empty
        bucket (FIFO across buckets and within one)."""
        while self._order:
            key = self._order[0]
            q = self._queues.get(key)
            if not q:
                self._order.popleft()
                self._queues.pop(key, None)
                continue
            batch = []
            while q and len(batch) < self.policy.max_batch:
                batch.append(q.popleft())
            self._pending -= len(batch)
            if not q:
                self._order.popleft()
                self._queues.pop(key, None)
            else:
                self._order.rotate(-1)      # round-robin across buckets
            return key, batch
        return None

    def observe_drain(self, n_requests: int, seconds: float):
        """Fold one completed launch into the drain-rate EWMA."""
        if seconds <= 0 or n_requests <= 0:
            return
        inst = n_requests / seconds
        self._rate = 0.7 * self._rate + 0.3 * inst

    def drain_all(self) -> list[tuple[tuple, list]]:
        """Pop everything still queued (leftovers at a drain deadline are
        rejected, not left waiting)."""
        out = []
        while True:
            nb = self.next_batch()
            if nb is None:
                return out
            out.append(nb)


__all__ = ["AdmissionPolicy", "AdmissionController", "bucket_key",
           "padded_batch"]
