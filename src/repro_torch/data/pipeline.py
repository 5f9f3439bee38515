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
reference's arrays bit for bit.  ``shard_batch`` gives a rank of a
mesh its rows of a host batch, on its device.
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


def shard_batch(batch: dict, mesh, *, microbatches: int = 1) -> dict:
    """This rank's rows of a host ``batch`` (numpy arrays, the global
    batch on every rank), as tensors on ``mesh.device``.

    The rows are split over the batch axes (``('pod', 'data')``, or
    ``('data',)``) and the rank takes the block at its row-major
    coordinate over them: where the reference's ``shard_batch`` puts
    them with ``NamedSharding(mesh, P(('pod', 'data')))``.  Ranks that
    differ only on ``model`` get the same rows.  With ``microbatches``
    = m the global batch is first cut into m equal microbatches, as the
    reference's train step cuts it, and the rank takes its block of each,
    in order: its microbatch j is its block of the reference's
    microbatch j.  Raises ``ValueError`` where the ranks (times m) do
    not divide the rows.
    """
    import torch

    from repro_torch.sharding.partitioning import batch_axes_for_mesh

    axes = batch_axes_for_mesh(mesh)
    size, idx = mesh.size(axes), mesh.index(axes)
    m = int(microbatches)

    def rows(x):
        x = np.asarray(x)
        b = x.shape[0]
        if b % (size * m):
            raise ValueError(f"batch of {b} rows does not split over the "
                             f"{size} ranks of the batch axes {axes}"
                             + (f" in {m} microbatches" if m > 1 else ""))
        blk = x.reshape(m, size, b // (m * size), *x.shape[1:])[:, idx]
        blk = np.ascontiguousarray(blk.reshape(b // size, *x.shape[1:]))
        return torch.from_numpy(blk).to(mesh.device)

    return {k: rows(v) for k, v in batch.items()}
