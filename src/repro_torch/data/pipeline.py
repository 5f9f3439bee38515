"""Host-side token pipeline: deterministic, prefetching, numpy only.

A copy of ``repro/data/pipeline.py``'s ``TokenPipeline`` and
``pool_from_callable``.  ``TokenPipeline`` cuts a token stream into
(batch, seq) examples with a deterministic per-step mapping (a restart
from checkpoint step N replays the same data order), a pool mode that
over-provisions selection candidates from a disjoint RNG stream, and a
background prefetch thread with a deterministic shutdown (``close()``
joins; the pipeline is a context manager).

RNG streams: every draw is seeded with a ``np.random.SeedSequence`` over
``(seed, stream_tag, step)``, so the per-step batch stream and the
selection pool stream never collide.  The same seed gives the
reference's arrays bit for bit.  Placing a batch on a mesh
(``shard_batch``) comes with the port's sharded training.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

#: Stream tags for the (seed, tag, step) SeedSequence entropy.
BATCH_STREAM = 0
POOL_STREAM = 1


class TokenPipeline:
    def __init__(self, tokens: np.ndarray, batch: int, seq: int,
                 *, start_step: int = 0, prefetch: int = 2,
                 seed: int = 1234):
        self.tokens = tokens
        self.batch = batch
        self.seq = seq
        self.seed = int(seed)
        self.step = start_step
        self.examples_total = len(tokens) // seq
        if self.examples_total < batch:
            raise ValueError("token stream too small for one batch")
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _rng(self, stream: int, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, stream, step)))

    def _rows(self, idx) -> np.ndarray:
        return np.stack(
            [self.tokens[i * self.seq:(i + 1) * self.seq] for i in idx]
        ).astype(np.int32)

    def batch_for_step(self, step: int) -> dict:
        """Deterministic batch for a global step (restart-replayable)."""
        idx = self._rng(BATCH_STREAM, step).choice(
            self.examples_total, size=self.batch, replace=False)
        return {"tokens": self._rows(idx)}

    def pool_for_step(self, step: int, size: int) -> tuple[dict, np.ndarray]:
        """``size`` distinct candidate examples for the selection period
        starting at ``step``, from the pool stream.  Returns (batch dict,
        example ids); the ids index the token stream, so selections can
        be compared across runs."""
        size = int(min(size, self.examples_total))
        idx = self._rng(POOL_STREAM, step).choice(
            self.examples_total, size=size, replace=False)
        return {"tokens": self._rows(idx)}, idx.astype(np.int64)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_for_step(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._q.get()
        self.step += 1
        return b

    def close(self):
        """Stop and join the prefetch thread (idempotent).  The queue is
        drained first, so a ``put`` blocked on a full queue sees the
        stop event within one timeout."""
        self._stop.set()
        if self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "TokenPipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def pool_from_callable(batch_for_step, step: int,
                       n_batches: int) -> tuple[dict, np.ndarray]:
    """Candidate pool for a bare ``step -> batch`` source: ``n_batches``
    batches at pseudo-steps ``(1 << 30) + step · n_batches + j``, a
    region of the step space disjoint from any training step.  Returns
    (pooled batch, pool-local example ids)."""
    base = (1 << 30) + step * n_batches
    parts = [batch_for_step(base + j) for j in range(n_batches)]
    pooled = {
        k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0)
        for k in parts[0]
    }
    n = next(iter(pooled.values())).shape[0]
    return pooled, np.arange(n, dtype=np.int64)
