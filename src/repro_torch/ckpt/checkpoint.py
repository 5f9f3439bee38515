"""Fault-tolerant checkpointing.

Ports ``repro/ckpt/checkpoint.py`` with its design:

  * atomic:   write to ``<dir>/tmp.<step>``, then ``os.replace`` to
              ``step_<step>`` — a crash mid-write never corrupts the
              newest checkpoint;
  * manifest: JSON with the flattened tree paths, shapes, dtypes and
              the package version — a restore validates the WHOLE
              manifest against the expected structure before it makes
              any tensor (a corrupt or mismatched checkpoint is a clear
              ``ValueError``);
  * async:    ``CheckpointManager`` copies the tree to the host (after a
              device synchronize) and hands the copy to a writer thread,
              which never touches a CUDA tensor;
  * prune:    ``prune_checkpoints(dir, keep_last=N)`` retires old
              checkpoints but never the newest complete one — a
              half-written or truncated directory (the manifest/npz
              cross-check) cannot shadow the last good snapshot.

Format: one ``arrays.npz`` per checkpoint plus ``manifest.json``; keys
are ``/``-joined tree paths (dict keys in sorted order, NamedTuple field
names, sequence indices).  A tree is nested dicts, lists, tuples and
NamedTuples whose leaves are tensors, numpy arrays or Python scalars.
numpy has no bfloat16: a bf16 tensor is stored as its bits, a uint16
array (the manifest says uint16), and a bf16 leaf of ``like`` gets them
back bit for bit.
``restore_checkpoint`` places the leaves on ``device=``, or, given a
``mesh=`` and ``specs=``, gives each rank its block of every leaf
(``runtime/elastic.py::reshard_tree``): the elastic restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import __version__


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(path entry, child) pairs of a container node, else None."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree) -> dict:
    out: dict = {}

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out["/".join(prefix)] = node
            return
        for name, child in kids:
            walk(child, prefix + [name])

    walk(tree, [])
    return out


def _unflatten(like, flat: dict):
    def build(node, prefix):
        kids = _children(node)
        if kids is None:
            return flat["/".join(prefix)]
        vals = [build(child, prefix + [name]) for name, child in kids]
        if isinstance(node, dict):
            return dict(zip([k for k, _ in kids], vals))
        if _is_namedtuple(node):
            return type(node)(*vals)
        return type(node)(vals)

    return build(like, [])


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _tensor_to_numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        v = v.view(torch.int16)
        return v.numpy().view(np.uint16).copy()
    return v.numpy().copy()


def _shape(leaf) -> list:
    return list(leaf.shape) if hasattr(leaf, "shape") else list(
        np.shape(leaf))


def _host_leaves(flat: dict) -> dict:
    """Numpy copies of the leaves, after one device synchronize when a
    leaf lives on the card."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in flat.values()):
        torch.cuda.synchronize()

    def host(v):
        if isinstance(v, torch.Tensor):
            return _tensor_to_numpy(v)
        return np.array(v, copy=True)

    return {k: host(v) for k, v in flat.items()}


def to_host(tree):
    """The tree with every leaf copied to a numpy array — what a writer
    thread may touch."""
    return _unflatten(tree, _host_leaves(_flatten_with_paths(tree)))


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: dict | None = None,
                    keep_last: int | None = None) -> str:
    """Atomically write checkpoint ``step``; with ``keep_last``, prune
    old ones after the rename."""
    os.makedirs(directory, exist_ok=True)
    host = _host_leaves(_flatten_with_paths(tree))
    tmp = os.path.join(directory, f"tmp.{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "version": __version__,
        "extra": extra or {},
        "leaves": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in host.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    final = _step_dir(directory, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep_last is not None:
        prune_checkpoints(directory, keep_last)
    return final


def checkpoint_steps(directory: str) -> list[int]:
    """All step numbers with a ``step_*`` directory, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_")
    )


def latest_step(directory: str) -> int | None:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


def is_complete(directory: str, step: int) -> bool:
    """True iff checkpoint ``step``'s manifest parses and ``arrays.npz``
    opens as an archive whose members cover every manifest leaf."""
    path = _step_dir(directory, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            return set(manifest["leaves"]) <= set(data.files)
    except Exception:       # missing file, truncated zip, bad JSON, …
        return False


def latest_complete_step(directory: str) -> int | None:
    """Newest step that passes :func:`is_complete` (restore target)."""
    for step in reversed(checkpoint_steps(directory)):
        if is_complete(directory, step):
            return step
    return None


def prune_checkpoints(directory: str, keep_last: int) -> list[int]:
    """Retire old checkpoints, keeping the newest ``max(1, keep_last)``
    complete ones; returns the deleted steps.  The newest complete
    checkpoint is never deleted (even with ``keep_last=0``); incomplete
    directories older than it are removed, and anything at or past it is
    left alone (it may be a concurrent writer's rename landing)."""
    keep = max(1, int(keep_last))
    steps = checkpoint_steps(directory)
    complete = [s for s in steps if is_complete(directory, s)]
    if not complete:
        return []
    newest = complete[-1]
    keep_set = set(complete[-keep:])
    dropped = []
    for s in steps:
        if s >= newest or s in keep_set:
            continue
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
        dropped.append(s)
    return dropped


def _validate_manifest(manifest: dict, flat_like: dict, npz_files,
                       where: str) -> None:
    """Every ``like`` leaf must exist in both manifest and archive with
    the expected shape and dtype — checked before any leaf is rebuilt."""
    leaves = manifest.get("leaves", {})
    missing = sorted(set(flat_like) - (set(leaves) & set(npz_files)))
    if missing:
        raise ValueError(
            f"{where}: checkpoint missing leaves: {missing[:5]}…")
    problems = []
    for key, ref in flat_like.items():
        meta = leaves[key]
        if list(meta["shape"]) != _shape(ref):
            problems.append(
                f"{key}: shape {tuple(meta['shape'])} != "
                f"expected {tuple(_shape(ref))}")
        elif np.dtype(meta["dtype"]) != _np_dtype(ref):
            problems.append(
                f"{key}: dtype {meta['dtype']} != expected "
                f"{_np_dtype(ref).name}")
    if problems:
        raise ValueError(
            f"{where}: manifest/structure mismatch — " + "; ".join(problems))


def restore_checkpoint(directory: str, like: Any, *, step: int | None = None,
                       device=None, mesh=None,
                       specs=None) -> tuple[Any, int]:
    """Restore into the structure of ``like``; returns (tree, step).

    A tensor leaf of ``like`` comes back as a tensor on ``device``
    (default: that leaf's device), any other leaf as a numpy array.
    With ``mesh`` and ``specs`` (a tree of per-leaf specs in the
    structure of ``like``, see ``runtime/elastic.py``) each leaf comes
    back as this rank's block, tensors on the mesh's device.
    ``step=None`` restores the newest complete checkpoint, skipping a
    truncated or half-written newer directory.
    """
    if (mesh is None) != (specs is None):
        raise ValueError("restore_checkpoint: pass mesh= and specs= "
                         "together")
    if mesh is not None:
        device = mesh.device
    if step is None:
        step = latest_complete_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints in {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten_with_paths(like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        _validate_manifest(manifest, flat_like, data.files, where=path)
        arrays = {k: data[k] for k in flat_like}

    def rebuild(key, ref):
        if isinstance(ref, torch.Tensor):
            dev = ref.device if device is None else torch.device(device)
            a = arrays[key]
            if ref.dtype == torch.bfloat16:
                return torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).to(dev)
            return torch.from_numpy(a).to(dev)
        return arrays[key]

    restored = _unflatten(like, {k: rebuild(k, v)
                                 for k, v in flat_like.items()})
    if mesh is not None:
        from repro_torch.runtime.elastic import reshard_tree

        restored = reshard_tree(restored, specs, mesh)
    return restored, manifest["step"]


class CheckpointManager:
    """Periodic async checkpointing with retention.

    ``maybe_save`` copies the tree to the host (one synchronize when a
    leaf lives on the card) and writes and prunes on a thread — one
    write in flight at a time; a failed write raises on the next
    ``maybe_save`` or ``wait``.  The thread sees numpy arrays only.
    """

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def maybe_save(self, step: int, tree, *, blocking: bool = False,
                   extra: dict | None = None):
        if step % self.every != 0:
            return
        self.wait()
        host = to_host(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra=extra,
                                keep_last=self.keep)
            except Exception as e:   # surfaced on the next maybe_save/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self, *, raise_errors: bool = True):
        """Join the write in flight; ``raise_errors=False`` keeps a
        failed write's error for the next call."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error and raise_errors:
            err, self._error = self._error, None
            raise err

    def latest(self) -> int | None:
        return latest_step(self.directory)
