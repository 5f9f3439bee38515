"""Elastic scaling: rebuild the mesh from the surviving ranks and reshard.

Ports ``repro/runtime/elastic.py``.  When a fleet loses ranks, the
recovery path is

  1. ``elastic_mesh(ranks)`` — the largest power of two of the surviving
     ranks, laid out (data, model) with the model axis kept if possible;
  2. ``reshard_tree`` — each rank takes its block of every leaf of a
     global (host-view) tree, by the leaf's spec: a tuple naming, per
     dimension, the mesh axis that dimension is sharded over (``None``:
     replicated; a shorter tuple leaves the trailing dimensions
     replicated).  With ``ckpt/checkpoint.py::restore_checkpoint(...,
     mesh=, specs=)`` this is the restore onto a smaller fleet;
  3. ``gather_tree`` — the inverse, every rank's blocks back to the
     global tree (collective: every member calls it), which is what a
     round snapshot holds, whatever the mesh it was taken on.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.tree import tree_map


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def elastic_mesh(ranks=None, *, model_axis: int | None = None,
                 axes=("data", "model"), device=None):
    """The best (data, model) mesh over the surviving ``ranks`` (default:
    every rank of the world): its first power-of-two ranks, the model
    axis ``model_axis`` (default min(n, 16)) halved until it divides
    them.  Every rank of the world must call it; the ranks left out get
    a mesh whose ``member`` is False."""
    import torch.distributed as dist

    ranks = sorted(range(dist.get_world_size()) if ranks is None
                   else (int(r) for r in ranks))
    n = _pow2_floor(len(ranks))
    model = min(n, 16) if model_axis is None else int(model_axis)
    while n % model and model > 1:
        model //= 2
    return make_mesh((n // model, model), axes, ranks=ranks[:n],
                     device=device)


def _spec_dims(spec, ndim: int):
    """(dim, axis) pairs of the sharded dimensions of a spec."""
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than a "
                         f"{ndim}-dim leaf")
    return [(dim, axis) for dim, axis in enumerate(spec) if axis]


def reshard_tree(tree, specs, mesh):
    """Each leaf's block on this rank of ``mesh`` (a tensor moves to the
    mesh's device; a numpy leaf stays numpy)."""
    def one(x, spec):
        is_np = not isinstance(x, torch.Tensor)
        for dim, axis in _spec_dims(spec, np.ndim(x)):
            size = mesh.size(axis)
            if x.shape[dim] % size:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                 f"does not divide axis {axis!r} ({size})")
            block = x.shape[dim] // size
            lo = mesh.index(axis) * block
            x = (np.take(x, range(lo, lo + block), axis=dim) if is_np
                 else x.narrow(dim, lo, block))
        if is_np:
            return np.ascontiguousarray(x)
        return x.to(mesh.device).contiguous()

    return tree_map(one, tree, specs)


def gather_tree(tree, specs, mesh):
    """The global tree from every rank's blocks (collective over the
    sharded axes; every member must call it).  A numpy leaf travels as
    a tensor (uint64 as int64 bits) and comes back numpy."""
    def one(x, spec):
        is_np = not isinstance(x, torch.Tensor)
        if is_np:
            arr = np.asarray(x)
            dt = arr.dtype
            t = torch.from_numpy(arr.view(np.int64) if dt == np.uint64
                                 else arr).to(mesh.device)
        else:
            t = x
        for dim, axis in reversed(_spec_dims(spec, t.dim())):
            t = torch.cat(list(mesh.all_gather(t, axis)), dim=dim)
        if is_np:
            out = t.cpu().numpy()
            return out.view(np.uint64) if dt == np.uint64 else out
        return t

    return tree_map(one, tree, specs)


__all__ = ["elastic_mesh", "reshard_tree", "gather_tree", "tree_map"]
