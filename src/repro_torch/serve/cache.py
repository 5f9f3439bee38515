"""Objective cache keyed on dataset fingerprint, with warm updates.

Ports ``repro/serve/cache.py``.  An entry holds its dataset as tensors on
the server's device, the factory that builds its objective, and the
runners (``serve/batcher.py``) that survive warm updates.

No stale derived tensors: a port objective caches tensors derived from
X when it is built (column norms, ‖y‖², X in the stream dtype), where
the reference rebuilds its objective inside every trace.  So the entry
builds its objective through the factory and keeps it until the data
change, a warm update (:meth:`ObjectiveCache.update_columns`) writes a
new X tensor — never into the old one, which a running bucket may hold —
and drops the objective, and a runner takes the entry's current
objective at call time and holds none itself.  A warm update therefore
re-keys the entry under a chained fingerprint, keeps every runner (no
new ``builds``) and drops only the derived OPT probes.

Fingerprints are the reference's strings: ``register`` hashes the arrays
in the dtypes JAX stores them in with 64-bit types off (float64 as
float32, int64 as int32), ``update_columns`` the patch as int32 indices
and float32 columns.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

# The dtypes JAX stores 64-bit host arrays in when 64-bit types are off.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def _numpy(v) -> np.ndarray:
    """A host numpy view of an array, tensor (any device) or sequence."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _narrow(v) -> np.ndarray:
    a = _numpy(v)
    return a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)


def fingerprint_arrays(kind: str, arrays: dict) -> str:
    """Content hash of a dataset: kind + per-array name/shape/dtype/bytes.
    Two registrations of identical data share one cache entry."""
    h = hashlib.sha256(kind.encode())
    for name in sorted(arrays):
        a = _numpy(arrays[name])
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def chained_fingerprint(parent: str, idx, cols) -> str:
    """Fingerprint after a warm update — a hash of (parent, patch) rather
    than of the whole arrays, so an update costs O(patch)."""
    h = hashlib.sha256(parent.encode())
    h.update(_numpy(idx).tobytes())
    h.update(_numpy(cols).tobytes())
    return h.hexdigest()[:16]


def make_factory(kind: str, kmax: int, *, device=None,
                 **kw) -> Callable[[dict], Any]:
    """An arrays → objective constructor for a supported kind, on
    ``device`` (the entry's)."""
    if kind == "regression":
        from repro_torch.core.objectives import RegressionObjective

        return lambda a: RegressionObjective(a["X"], a["y"], kmax,
                                             device=device, **kw)
    if kind == "aopt":
        from repro_torch.core.objectives import AOptimalityObjective

        return lambda a: AOptimalityObjective(a["X"], kmax, device=device,
                                              **kw)
    if kind == "classification":
        from repro_torch.core.objectives import ClassificationObjective

        return lambda a: ClassificationObjective(a["X"], a["y"], kmax,
                                                 device=device, **kw)
    raise ValueError(
        f"unknown objective kind {kind!r}; "
        "supported: regression, aopt, classification"
    )


@dataclass
class DatasetEntry:
    """One registered dataset: tensors, factory, its current objective
    and the runner store that survives warm updates."""

    name: str
    kind: str
    fingerprint: str
    arrays: dict
    factory: Callable[[dict], Any]
    kmax: int
    runners: dict = field(default_factory=dict)
    opt_probe: dict = field(default_factory=dict)   # k → probed OPT base
    builds: int = 0     # runner builds — a warm update adds none
    objective_builds: int = 0
    obj: Any = None     # the objective of the current arrays, or None

    @property
    def n(self) -> int:
        return int(self.arrays["X"].shape[1])

    def objective(self):
        """The objective of the current arrays, built on first use after
        registration or a warm update."""
        if self.obj is None:
            self.obj = self.factory(self.arrays)
            self.objective_builds += 1
        return self.obj

    def runner(self, key, build: Callable[[], Any]):
        """Memoized runner keyed on launch shape and config; runners take
        the objective at call time, so they outlive warm updates."""
        if key not in self.runners:
            self.runners[key] = build()
            self.builds += 1
        return self.runners[key]


class ObjectiveCache:
    """LRU of :class:`DatasetEntry` keyed on fingerprint, with name
    aliases, holding its tensors on ``device`` (``None``: the card).
    Evicting an entry drops its tensors, objective and runners."""

    def __init__(self, capacity: int = 8, *, device=None):
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self._entries: OrderedDict[str, DatasetEntry] = OrderedDict()
        self._names: dict[str, str] = {}          # alias → fingerprint

    def register(self, name: str, kind: str, arrays: dict, *,
                 kmax: int, **obj_kw) -> str:
        """Add (or re-reference) a dataset; returns its fingerprint."""
        host = {k: _narrow(v) for k, v in arrays.items()}
        fp = fingerprint_arrays(kind, host)
        if fp in self._entries:
            self._entries.move_to_end(fp)
        else:
            factory = make_factory(kind, kmax, device=self.device, **obj_kw)
            self._entries[fp] = DatasetEntry(
                name=name, kind=kind, fingerprint=fp,
                arrays={k: torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device) for k, a in host.items()},
                factory=factory, kmax=kmax,
            )
            while len(self._entries) > self.capacity:
                old_fp, _ = self._entries.popitem(last=False)
                self._names = {n: f for n, f in self._names.items()
                               if f != old_fp}
        self._names[name] = fp
        return fp

    def get(self, name_or_fp: str) -> DatasetEntry:
        fp = self._names.get(name_or_fp, name_or_fp)
        try:
            entry = self._entries[fp]
        except KeyError:
            raise ValueError(
                f"unknown dataset {name_or_fp!r}; registered: "
                f"{sorted(self._names)}"
            ) from None
        self._entries.move_to_end(fp)
        return entry

    def update_columns(self, name_or_fp: str, idx, cols) -> str:
        """Warm update: columns ``idx`` of the entry's X become ``cols``
        in a new X tensor, the objective is rebuilt on next use, the
        entry is re-keyed under a chained fingerprint, runners are kept
        and the OPT probes dropped."""
        entry = self.get(name_or_fp)
        idx = _numpy(idx).astype(np.int32)
        cols = _numpy(cols).astype(np.float32)
        X = entry.arrays["X"]
        if cols.shape != (X.shape[0], idx.shape[0]):
            raise ValueError(
                f"column patch shape {cols.shape} does not match "
                f"(d={X.shape[0]}, |idx|={idx.shape[0]})"
            )
        new_fp = chained_fingerprint(entry.fingerprint, idx, cols)
        X = X.clone()
        X[:, torch.from_numpy(idx.astype(np.int64)).to(X.device)] = (
            torch.from_numpy(cols).to(X.device))
        entry.arrays = dict(entry.arrays, X=X)
        entry.obj = None
        entry.opt_probe.clear()
        self._entries.pop(entry.fingerprint, None)
        old_fp, entry.fingerprint = entry.fingerprint, new_fp
        self._entries[new_fp] = entry
        self._names = {n: (new_fp if f == old_fp else f)
                       for n, f in self._names.items()}
        return new_fp


__all__ = ["ObjectiveCache", "DatasetEntry", "fingerprint_arrays",
           "chained_fingerprint", "make_factory"]
