"""Placements for decode caches, batches and the optimizer's state.

A port of ``repro/sharding/cache_specs.py`` over the port's trees.  A
placement is a tuple with one entry per dimension (an axis name, a tuple
of axis names, or None), as in ``partitioning.py``.  The reference's
cache leaves are stacked over super-blocks, (n_super, B, ...), and the
port's are one layer's, (B, ...): a layer's placement is the
reference's with the leading entry dropped.  ``step_offset`` (B,) and
``enc_out`` (B, S, D) are not stacked in either package.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sharding.partitioning import (
    _divisible,
    _rebuild,
    extend_first_free,
    fsdp_takes_stack,
    stack_count,
)


def axes_entry(axes):
    """A placement's entry for ``axes``: the name of a single axis, else
    the tuple (the form ``PartitionSpec`` normalizes to)."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def batch_dim_spec(b: int, mesh, axes):
    """``axes`` where their ranks divide the batch ``b``, else None (a
    batch of 1 stays whole)."""
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return axes_entry(axes) if _divisible(b, size) else None


def _names(path):
    return [p for p in path if isinstance(p, str)]


def cache_partition_specs(cache_shapes, cfg, mesh, axes):
    """Placements of a decode cache (``Model.init_cache``, real or
    ``meta`` tensors): the batch over ``axes`` where it divides; a KV
    cache's heads over ``model`` where they divide it, else its
    positions; a ring cache's ``positions`` over ``model`` with them;
    everything else replicated.  KV leaves are (B, C, Hkv, Dh), the
    ring's positions (B, C)."""
    model_size = mesh.shape.get("model", 1)
    n_kv = cfg.attn.n_kv_heads

    def spec_for(path, leaf):
        name = _names(path)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name == "step_offset":
            return (batch_dim_spec(shape[0], mesh, axes),)
        if name == "enc_out":
            return (batch_dim_spec(shape[0], mesh, axes), None, None)
        spec = [None] * nd
        spec[0] = batch_dim_spec(shape[0], mesh, axes)
        if name in ("k", "v") and nd == 4:
            if shape[2] == n_kv and _divisible(n_kv, model_size):
                spec[2] = "model"          # KV heads over model
            elif _divisible(shape[1], model_size):
                spec[1] = "model"          # else the cache's positions
        if (name == "positions" and nd == 2 and spec[0] is not None
                and _divisible(shape[1], model_size)
                and not _divisible(n_kv, model_size)):
            spec[1] = "model"
        return tuple(spec)

    return _rebuild(cache_shapes, spec_for)


def batch_partition_specs(batch_shapes, mesh, axes):
    """Each batch entry's first dimension over ``axes`` where it
    divides."""
    return {k: (batch_dim_spec(v.shape[0], mesh, axes),)
            + (None,) * (len(v.shape) - 1)
            for k, v in batch_shapes.items()}


def zero1_specs(param_specs, param_shapes, mesh, axes, cfg=None):
    """The parameters' placements extended with the optimizer state's
    (ZeRO-1) sharding: the first free dimension that the ``axes``' ranks
    divide goes over ``axes``, unless a leaf is already sharded over one
    of them (``fsdp``).  ``cfg`` names the stacked layers
    (``partitioning.stack_count``): the reference's stacked axis comes
    first, and ``fsdp`` may hold it."""
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    entry = axes_entry(axes)
    specs = dict(_walk_specs(param_specs))

    def extend(path, leaf):
        spec = specs[path]
        shape = tuple(leaf.shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for d in dims:
            used.update(d if isinstance(d, tuple) else (d,))
        if fsdp_takes_stack(path, shape, cfg, mesh):
            used.add("data")
        if any(a in used for a in axes):
            return tuple(dims)
        return extend_first_free(dims, shape, stack_count(path, cfg),
                                 entry, size)

    return _rebuild(param_shapes, extend)


def _walk_specs(tree, path=()):
    """(path, placement) of every leaf of a placement tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_specs(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk_specs(v, path + (i,))
    else:
        yield path, tree


@dataclass(frozen=True)
class Zero1Part:
    """Where one leaf's optimizer state lives over the batch axes under
    ZeRO-1 (``zero1_layout``).  ``axes`` empty: replicated.  ``dim`` set:
    cut along ``dim`` into ``mesh.size(axes)`` blocks, block c on the
    member at coordinate c.  ``dim`` None with ``axes``: the reference
    stacks ``stacked`` layers into this leaf and places the stack over
    ``axes``, so this layer, ``block`` of the stack, lives whole on the
    member at coordinate ``block // (stacked // size)``."""
    axes: tuple
    dim: int | None = None
    stacked: int = 1
    block: int = 0

    def owner(self, size: int) -> int:
        """The coordinate of the member that holds a stacked leaf."""
        return self.block // (self.stacked // size)


def _stack_block(path, cfg) -> int:
    """The super-block (or encoder layer) of the leaf at ``path``: its
    index in the reference's stack."""
    if path and path[0] == "layers":
        return path[1] // cfg.pattern_period
    if path and path[0] == "enc_layers":
        return path[1]
    return 0


def zero1_layout(grad_specs, param_shapes, mesh, axes, cfg):
    """A tree of :class:`Zero1Part` with the parameters' structure: what
    ``zero1_specs``' placements (``grad_specs``) mean for a rank of the
    port, whose leaves are one layer each.  A leaf whose placement names
    batch axes is cut along that dimension.  One whose placement names
    none is either a slice of a reference stack that goes over the batch
    axes (``fsdp`` took the stack over ``data``, or ZeRO-1 took it over
    ``axes``: ``extend_first_free`` leaves the per-layer placement alone
    then) or replicated."""
    specs = dict(_walk_specs(grad_specs))
    size = 1
    for a in axes:
        size *= mesh.shape[a]

    def part(path, leaf):
        shape = tuple(leaf.shape)
        for i, d in enumerate(specs[path]):
            names = d if isinstance(d, tuple) else (d,)
            held = tuple(a for a in names if a in axes)
            if held:
                return Zero1Part(held, i)
        stacked = stack_count(path, cfg)
        block = _stack_block(path, cfg)
        if fsdp_takes_stack(path, shape, cfg, mesh):
            return Zero1Part(("data",), None, stacked, block)
        if stacked > 1 and _divisible(stacked, size):
            return Zero1Part(tuple(axes), None, stacked, block)
        return Zero1Part(())

    return _rebuild(param_shapes, part)
