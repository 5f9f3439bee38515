"""Wall-clock timing helpers: a port of ``repro/utils/timing.py``."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from repro_torch.tree import tree_leaves


@dataclass
class Timer:
    """Accumulating named timer."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: total={total:.4f}s calls={n} "
                         f"mean={total / n:.6f}s")
        return "\n".join(lines)


def _sync(devices) -> None:
    """Wait for the CUDA devices among ``devices`` (the reference's
    ``block_until_ready``); nothing for host or ``meta`` devices."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def synced_seconds(dev, fn):
    """(fn(), host seconds of the call) with ``dev`` synchronized before
    and after, where it is a CUDA device."""
    _sync((dev,))
    t0 = time.perf_counter()
    out = fn()
    _sync((dev,))
    return out, time.perf_counter() - t0


def timed(fn, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """(result, seconds per call) of ``fn`` over ``iters`` calls after at
    least one warm-up call, the devices of a CUDA result synchronized
    before and after the timed calls."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kwargs)
    devices = {t.device for t in tree_leaves(result)
               if isinstance(t, torch.Tensor)}
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _sync(devices)
    return result, (time.perf_counter() - t0) / iters
