"""The train step: loss and gradients, microbatched accumulation, AdamW.

A port of ``repro/train/step.py``.  With
``tcfg.microbatches = M`` the batch is cut into M equal parts along its
first axis, each part's gradient is taken in turn and summed in f32, and
the sum is divided by M (activation memory ∝ 1/M).  Optional gradient
compression applies to the accumulated gradient before the optimizer, as
in the reference.  Gradients are ``torch.autograd.grad`` of
``Model.loss`` with respect to the parameter leaves; nothing is held on
the parameters between steps, and a step returns a new state without
writing into the old one.

Compression works per leaf (a top-k threshold, an int8 scale), and the
reference's leaves are a pattern position's weights stacked over
super-blocks (and the encoder's over its layers); the port's are one
layer's.  So the step compresses each reference leaf from its layers'
gradients together (``reference_units``,
``optim.compression.compress_parts``): the same leaves, the same
thresholds and scales.  The one function serves every step below, the
parts of a leaf on several ranks included.

On a mesh (``make_train_step(..., mesh=)``) the step is data parallel,
the port's counterpart of the reference's step jitted under
``activation_sharding_ctx`` with batches sharded over the batch axes:
the parameters and the optimizer's state are replicated, each rank
takes the gradient of its share of the loss on its rows (``Model.loss``
under the context: the global token count, the MoE's global dispatch
and aux loss), and the f32 gradients are summed over the batch axes'
group only — ranks that differ on ``model`` hold the same rows, and a
sum over the whole world would count each row ``model``-size times.
The sum runs in flat buckets of at most ``BUCKET_ELEMS`` elements, in
the leaves' fixed order, so a rerun gives the same bits, and every rank
gets the same bits; clipping, compression and AdamW then run alike on
every rank, on the global gradient (the reference's order).  The
metrics are summed the same way.  With microbatches, the batch given to
the step is ``data.pipeline.shard_batch(..., microbatches=M)``'s: the
rank's block of each of the reference's microbatches, in order.  The
first call checks, with a checksum broadcast over every axis, that
every rank starts from the same state.  Where the batch axes hold one
rank the step is the single-device step, bit for bit.

**ZeRO-1** (``make_train_step(..., mesh=, grad_specs=)``, the
reference's ``grad_specs``: ``sharding.zero1_specs``' placements of the
optimizer's state).  Each rank holds AdamW's master, m and v only for
its part of every leaf over the batch axes (``sharding.zero1_layout``,
on the shapes of the leaves the rank holds): a block
along the placed dimension; or, where the reference's stack of layers
goes over the batch axes, the whole leaf on the member that holds its
super-block and nothing (an empty tensor) elsewhere; or, where nothing
divides, the whole leaf everywhere.  ``shard_train_state`` cuts a
replicated state so, ``gather_train_state`` puts it back together.  A
step takes the f32 gradients of the rank's rows as above, then:

  1. sums them over the batch axes and keeps the rank's part: one
     ``Mesh.psum_scatter`` per bucket of whole leaves (a reference
     stack's layers together, so that every member's block has one
     size), over the placement's axes (and a ``psum`` over the other
     batch axes, where the placement names a subset); the replicated
     leaves are all-reduced as above;
  2. takes the global gradient norm from the parts' sums of squares,
     summed over the batch axes (a part that several members hold
     counted once);
  3. runs AdamW on the parts;
  4. all-gathers the new parameters (the parameters' dtype) over the
     placement's axes.

At world 1 every part is the whole leaf and the step is the
single-device step, bit for bit.  The first call checks the parameters
and the step count, the state every rank shares.  Gradient compression
(``optim.compression.compress_parts``) runs on the parts after the
reduce-scatter (1.), each with its whole leaf's threshold or scale; the
error feedback is cut like the master.

**Tensor parallelism** (``make_train_step(..., mesh=,
tensor_parallel=True)``, with or without ``grad_specs``): the state's
parameters, master, m, v and error feedback are the rank's shards over
``model`` by the parameters' placements
(``shard_train_state(..., param_specs=)``), and the loss runs under the
tensor-parallel context (``sharding/tensor_parallel.py``).  The
gradients of split leaves stay with their shards; those of replicated
leaves come out equal on every ``model`` rank; the sums over the batch
axes are as above.  The global norm sums the squares of the split
leaves over ``model`` once and counts the replicated leaves once, and
compression takes a split leaf's threshold or scale over its shards.
Where ``model`` holds one rank every path is the one above.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import dtype_of
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    Holders,
    compress_parts,
    init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding.cache_specs import zero1_layout
from repro_torch.sharding.flags import get_flags, set_flags
from repro_torch.sharding.partitioning import (
    activation_sharding_ctx,
    batch_axes_for_mesh,
    param_partition_specs,
)
from repro_torch.sharding.tensor_parallel import (
    MODEL,
    gather_params,
    model_dims,
    shard_params,
    tp_gap,
)
from repro_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)
from repro_torch.utils.timing import synced_seconds

#: Elements of one bucket of the gradients' all-reduce (64 MiB of f32).
BUCKET_ELEMS = 1 << 24


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    error_fb: Any       # gradient-compression error feedback, or ()


def init_train_state(model, generator: torch.Generator, tcfg) -> TrainState:
    """Random parameters from ``generator`` (on its device), the
    optimizer's state, and zero error feedback when ``tcfg`` compresses
    gradients."""
    params = model.init(generator)
    opt = adamw_init(params)
    ef = (init_error_feedback(params) if tcfg.grad_compression != "none"
          else ())
    return TrainState(params=params, opt=opt, error_fb=ef)


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """M equal parts of every batch entry along its first axis."""
    def split(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             f"microbatches")
        return x.reshape(m, b // m, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def stack_layers(tree, period: int):
    """A tree of the parameters' structure in the reference's layout:
    ``layers[j]`` stacks layers j, j + period, … along a new first axis,
    and ``enc_layers`` stacks every encoder layer."""
    stack = lambda *xs: torch.stack(xs)
    out = {k: v for k, v in tree.items() if k not in ("layers",
                                                      "enc_layers")}
    layers = tree["layers"]
    out["layers"] = [tree_map(stack, *layers[j::period])
                     for j in range(period)]
    if "enc_layers" in tree:
        out["enc_layers"] = tree_map(stack, *tree["enc_layers"])
    return out


def loss_and_grads(model, params, batch):
    """(loss, metrics, gradients) of ``model.loss`` at ``params``; the
    gradients have the parameters' structure and dtypes (a leaf the loss
    does not reach gets zeros)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def all_reduce_buckets(leaves: list, mesh, axes) -> list:
    """The f32 ``leaves`` summed over ``axes`` of ``mesh``, in flat
    buckets of at most ``BUCKET_ELEMS`` elements taken in order (a leaf
    larger than a bucket goes alone)."""
    out: list = []
    bucket: list = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        flat = mesh.psum(flat, axes)
        for g, piece in zip(bucket, torch.split(
                flat, [g.numel() for g in bucket])):
            out.append(piece.reshape(g.shape))
        bucket.clear()

    for g in leaves:
        if bucket and size + g.numel() > BUCKET_ELEMS:
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()
    return out


def state_checksum(state) -> torch.Tensor:
    """(2,) float64: the sum and the sum of squares of every leaf of
    ``state``, taken in order."""
    leaves = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
    dev = leaves[0].device
    acc = torch.zeros((2,), dtype=torch.float64, device=dev)
    for t in leaves:
        x = t.detach().to(torch.float64)
        acc += torch.stack([x.sum(), (x * x).sum()])
    return acc


def check_same_state(state, mesh, axes=None) -> None:
    """Raise unless every rank of ``mesh`` holds the same ``state``: each
    axis (of ``axes``, default every axis) broadcasts its first member's
    checksum and every member compares its own.  On ``meta`` tensors (a
    ``ShapeMesh``'s dry run) the broadcasts run and nothing is compared,
    which ``mesh.notes`` records."""
    mine = state_checksum(state)
    axes = mesh.axis_names if axes is None else axes
    if mine.device.type == "meta":
        for axis in axes:
            mesh.broadcast(mine, axis, 0)
        mesh.notes.append("the first call's state check broadcast its "
                          "checksums and compared nothing (meta tensors)")
        return
    for axis in axes:
        first = mesh.broadcast(mine, axis, 0)
        if not torch.equal(first, mine):
            raise RuntimeError(
                f"rank {mesh.rank} starts from another state than the "
                f"first rank of axis {axis!r}: checksum "
                f"{mine.tolist()} against {first.tolist()}")


def check_tp_state(trees: list, dims: list, mesh) -> None:
    """``check_same_state`` under tensor parallelism: ``trees`` (each of
    the parameters' structure, or a tensor every rank shares) the same
    over every batch axis, and their leaves that no placement splits
    (``dims``: per parameter leaf, its ``model`` dimension or None) the
    same over ``model``."""
    check_same_state(trees, mesh, [a for a in mesh.axis_names
                                   if a != MODEL])
    whole = [x for t in trees for x, d in zip(
        tree_leaves(t), dims if isinstance(t, (dict, list)) else [None])
        if d is None]
    check_same_state(whole, mesh, (MODEL,))


def tp_global_norm(grads: list, dims: list, mesh) -> torch.Tensor:
    """√(Σ‖g‖²) of the whole gradient from the rank's shards: the split
    leaves' squares summed over ``model``, the replicated leaves' (the
    same on every rank) counted once."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    split = sum((x for x, d in zip(sq, dims) if d is not None), zero)
    whole = sum((x for x, d in zip(sq, dims) if d is None), zero)
    return torch.sqrt(mesh.psum(split, MODEL) + whole)


def reference_units(model, params, mesh=None, dims=None, parts=None):
    """Per reference leaf of ``model``'s parameter tree ``params`` (a
    pattern position's layers stacked over super-blocks, the encoder's
    layers, or a leaf alone), the (indices, numel, holders) that
    ``optim.compression.compress_parts`` takes; its holders are the axes
    of ``mesh`` that split it: ``model`` where ``dims`` names a
    dimension, the ZeRO-1 part's axes (``parts``: ``Zero1Part`` per
    leaf) where it has any.  ``numel`` counts the whole leaf, whatever
    this rank holds of it."""
    period = model.cfg.pattern_period
    whole_shapes = [tuple(x.shape) for x in tree_leaves(model.param_specs())]
    units: dict = {}
    for i, (path, _) in enumerate(tree_leaves_with_path(params)):
        if path[0] == "layers":
            key = ("layers", path[1] % period) + path[2:]
        elif path[0] == "enc_layers":
            key = ("enc_layers",) + path[2:]
        else:
            key = path
        units.setdefault(key, []).append(i)
    out = []
    for idx in units.values():
        axes = []
        if dims is not None and dims[idx[0]] is not None:
            axes.append(MODEL)
        if parts is not None and parts[idx[0]].axes:
            ax = parts[idx[0]].axes
            axes.append(ax[0] if len(ax) == 1 else ax)
        numel = sum(math.prod(whole_shapes[i]) for i in idx)
        out.append((idx, numel, Holders(mesh, axes)))
    return out


class Zero1Plan:
    """Where every leaf of a parameter tree lives under ZeRO-1 on a mesh
    (``zero1_layout`` of the placements ``grad_specs``), and the
    collectives that cut a tree of whole leaves into this rank's parts
    and put parts back together.  Leaves are taken in ``tree_leaves``
    order.  A unit is one leaf placed along a dimension, or every layer
    of one reference stack placed over the batch axes; every member's
    part of a unit has one size.  The units placed over the same axes
    are cut in buckets of whole units of at most ``BUCKET_ELEMS``
    elements (a larger unit goes alone)."""

    def __init__(self, params, grad_specs, mesh, cfg, dims=None):
        self.mesh = mesh
        # per leaf: the dimension a placement splits over model (tensor
        # parallelism: the leaves are the rank's shards), else None
        self.dims = dims
        axes = batch_axes_for_mesh(mesh)
        self.axes = tuple(a for a in axes if a in mesh.shape)
        self.parts = tree_leaves(zero1_layout(grad_specs, params, mesh,
                                              axes, cfg))
        leaves = tree_leaves_with_path(params)
        self.shapes = [tuple(x.shape) for _, x in leaves]
        self.replicated = [i for i, p in enumerate(self.parts)
                           if not p.axes]
        units: dict = {}
        for i, (path, _) in enumerate(leaves):
            p = self.parts[i]
            if not p.axes:
                continue
            key = path
            if p.dim is None:           # a reference stack: one unit
                pos = path[1] % cfg.pattern_period \
                    if path[0] == "layers" else 0
                key = (path[0], pos) + path[2:]
            units.setdefault((p.axes, key), []).append(i)
        self.buckets: list = []         # (axes, [units])
        current: dict = {}              # axes -> [its open bucket, elems]
        for (axes_, _), unit in units.items():
            elems = sum(math.prod(self.shapes[i]) for i in unit)
            cur = current.get(axes_)
            if cur is None or (cur[1] and cur[1] + elems > BUCKET_ELEMS):
                cur = current[axes_] = [[], 0]
                self.buckets.append((axes_, cur[0]))
            cur[0].append(unit)
            cur[1] += elems

    def piece_shape(self, i: int, c: int) -> tuple:
        """Shape of the part of leaf ``i`` held at coordinate ``c`` of its
        axes."""
        p, shape = self.parts[i], self.shapes[i]
        if not p.axes:
            return shape
        size = self.mesh.size(p.axes)
        if p.dim is None:
            return shape if p.owner(size) == c else (0,)
        out = list(shape)
        out[p.dim] //= size
        return tuple(out)

    def piece(self, x, i: int):
        """This rank's part of leaf ``i`` (the whole tensor ``x``)."""
        p = self.parts[i]
        if not p.axes:
            return x
        c = self.mesh.index(p.axes)
        size = self.mesh.size(p.axes)
        if p.dim is None:
            return x if p.owner(size) == c else x.reshape(-1)[:0]
        n = x.shape[p.dim] // size
        return x.narrow(p.dim, c * n, n)

    def pieces(self, leaves: list) -> list:
        """This rank's parts of whole leaves, copied (no view of a whole
        leaf outlives the call)."""
        return [self.piece(x, i).clone() for i, x in enumerate(leaves)]

    def _rows(self, leaves: list, unit: list, size: int):
        """(size, n): row c the flattened parts of ``unit``'s leaves at
        coordinate c, in the unit's order."""
        p = self.parts[unit[0]]
        if p.dim is None:
            return torch.stack([torch.cat(
                [leaves[i].reshape(-1) for i in unit
                 if self.parts[i].owner(size) == c]) for c in range(size)])
        x, d = leaves[unit[0]], p.dim
        shape = x.shape[:d] + (size, x.shape[d] // size) + x.shape[d + 1:]
        return x.reshape(shape).movedim(d, 0).reshape(size, -1)

    def _split(self, row, units: list, c: int) -> list:
        """The parts at coordinate c of ``units``' leaves, in order, from
        one row of a bucket."""
        idx = [i for u in units for i in u]
        shapes = [self.piece_shape(i, c) for i in idx]
        return [x.reshape(sh) for x, sh in zip(
            torch.split(row, [math.prod(sh) for sh in shapes]), shapes)]

    def reduce_scatter(self, grads: list) -> list:
        """This rank's parts of the f32 gradients ``grads`` (whole
        leaves) summed over the batch axes."""
        mesh = self.mesh
        out: list = [None] * len(grads)
        for axes, units in self.buckets:
            size, me = mesh.size(axes), mesh.index(axes)
            flat = torch.cat([self._rows(grads, u, size) for u in units],
                             dim=1).reshape(-1)
            mine = mesh.psum_scatter(flat, axes)
            rest = tuple(a for a in self.axes if a not in axes)
            if rest:
                # the members over the other batch axes hold this part too
                mine = mesh.psum(mine, rest[0] if len(rest) == 1 else rest)
            idx = [i for u in units for i in u]
            for i, x in zip(idx, self._split(mine, units, me)):
                out[i] = x
        if self.replicated:
            summed = all_reduce_buckets([grads[i] for i in self.replicated],
                                        mesh, self.axes)
            for i, x in zip(self.replicated, summed):
                out[i] = x
        return out

    def all_gather(self, parts: list) -> list:
        """Whole leaves from every rank's ``parts`` (this rank's given),
        gathered over each placement's axes, a bucket's units of one
        dtype at a time."""
        mesh = self.mesh
        out = list(parts)
        for axes, units in self.buckets:
            size = mesh.size(axes)
            for dt in dict.fromkeys(parts[u[0]].dtype for u in units):
                sub = [u for u in units if parts[u[0]].dtype == dt]
                rows = mesh.all_gather(torch.cat(
                    [parts[i].reshape(-1) for u in sub for i in u]), axes)
                got = [self._split(rows[c], sub, c) for c in range(size)]
                for j, i in enumerate(i for u in sub for i in u):
                    p = self.parts[i]
                    if p.dim is None:
                        out[i] = got[p.owner(size)][j]
                    else:
                        out[i] = torch.cat([got[c][j] for c in range(size)],
                                           dim=p.dim)
        return out

    def global_norm(self, parts: list) -> torch.Tensor:
        """√(Σ‖g‖²) of the whole gradient from this rank's ``parts``: the
        sums of squares grouped by how many members of the batch axes
        hold a part, each group summed over the batch axes and divided
        by that count; the parts every member holds are added here.  A
        group of parts of leaves split over ``model`` (``dims``) is also
        summed over ``model``: each model rank holds another part."""
        mesh = self.mesh
        size = mesh.size(self.axes)
        dims = self.dims or [None] * len(parts)
        sums: dict = {}
        for x, p, d in zip(parts, self.parts, dims):
            held = (size // mesh.size(p.axes) if p.axes else size,
                    d is not None)
            sq = torch.sum(torch.square(x.to(torch.float32)))
            sums[held] = sums[held] + sq if held in sums else sq
        total = sums.pop((size, False), None)
        if sums:
            held = sorted(sums)
            summed = mesh.psum(torch.stack([sums[h] for h in held]),
                               self.axes)
            split = [j for j, h in enumerate(held) if h[1]]
            if split:
                # a part of a leaf split over model: the model ranks'
                # parts differ, and each is counted
                summed = summed.clone()
                summed[split] = mesh.psum(summed[split].contiguous(), MODEL)
            for j, (h, _) in enumerate(held):
                part = summed[j] / h
                total = part if total is None else total + part
        return torch.sqrt(total)


def _map_state(state: TrainState, fn, params=True) -> TrainState:
    """``state`` with ``fn`` applied to the master, m, v, the error
    feedback (where there is any) and, with ``params``, the
    parameters."""
    opt = state.opt
    ef = state.error_fb
    return TrainState(params=fn(state.params) if params else state.params,
                      opt=AdamWState(step=opt.step, master=fn(opt.master),
                                     m=fn(opt.m), v=fn(opt.v)),
                      error_fb=fn(ef) if tree_leaves(ef) else ef)


def shard_train_state(state: TrainState, mesh, grad_specs=None, cfg=None,
                      *, param_specs=None) -> TrainState:
    """This rank's state from a replicated ``state``.  ``param_specs``
    (tensor parallelism: the parameters' placements) cuts every tree to
    the rank's shards over ``model``; ``grad_specs`` (ZeRO-1) then cuts
    master, m, v and the error feedback to its parts over the batch
    axes, the parameters and step staying as they are."""
    if param_specs is not None:
        state = _map_state(state, lambda t: shard_params(t, param_specs,
                                                         mesh))
    if grad_specs is None:
        return state
    plan = Zero1Plan(state.params, grad_specs, mesh, cfg)
    return _map_state(state, lambda t: tree_unflatten(
        t, plan.pieces(tree_leaves(t))), params=False)


def gather_train_state(state: TrainState, mesh, grad_specs=None, cfg=None,
                       *, param_specs=None) -> TrainState:
    """The replicated state from every rank's ``state``
    (:func:`shard_train_state`'s inverse; a collective: every member of
    the mesh calls it)."""
    if grad_specs is not None:
        plan = Zero1Plan(state.params, grad_specs, mesh, cfg)
        state = _map_state(state, lambda t: tree_unflatten(
            state.params, plan.all_gather(tree_leaves(t))), params=False)
    if param_specs is not None:
        state = _map_state(state, lambda t: gather_params(t, param_specs,
                                                          mesh))
    return state


def tp_param_specs(model, mesh):
    """The parameters' placements on ``mesh`` that tensor parallelism
    follows: the reference's, without ``fsdp`` (the port shards no
    parameter over the batch axes)."""
    flags = get_flags()
    try:
        set_flags(fsdp=False)
        return param_partition_specs(model.param_specs(), model.cfg, mesh)
    finally:
        set_flags(fsdp=flags.fsdp)


def make_train_step(model, tcfg, *, mesh=None, grad_specs=None,
                    tensor_parallel: bool = False):
    """``train_step(state, batch) -> (state, metrics)``; metrics are f32
    scalar tensors ``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``
    and ``lr``.  ``batch`` is a dict of tensors on the parameters'
    device: the whole batch, or with ``mesh`` this rank's rows
    (``data.pipeline.shard_batch``).  With a mesh the step's
    ``allreduce_seconds`` lists each call's host seconds in the
    gradients' all-reduce (the device synchronized before and after).

    ``grad_specs`` (with a mesh: ``sharding.zero1_specs``' placements)
    makes the step ZeRO-1 (the module docstring): ``state`` is then a
    rank's ZeRO-1 state (``shard_train_state``), and the step's
    ``reduce_scatter_seconds`` and ``all_gather_seconds`` list each
    call's host seconds in those collectives (``allreduce_seconds`` the
    replicated leaves' and the metrics' all-reduce).

    ``tensor_parallel`` (with a mesh) makes the step tensor parallel over
    ``model`` (the module docstring): ``state`` is the rank's shards
    (``shard_train_state(..., param_specs=tp_param_specs(model,
    mesh))``).  Where ``model`` holds one rank it changes nothing."""
    if grad_specs is not None and mesh is None:
        raise ValueError("grad_specs (ZeRO-1) needs a mesh")
    dims = None
    if tensor_parallel:
        if mesh is None:
            raise ValueError("tensor_parallel needs a mesh")
        gap = tp_gap(model.cfg)
        if gap is not None:
            raise ValueError(f"{model.cfg.name}: the port's tensor "
                             f"parallelism does not cover {gap}")
        if mesh.size(MODEL) > 1:
            dims = model_dims(model.param_specs(),
                              tp_param_specs(model, mesh))
    if grad_specs is not None:
        return _make_zero1_step(model, tcfg, mesh, grad_specs, dims)
    cfg = model.cfg
    pdt = dtype_of(cfg.param_dtype)
    m = tcfg.microbatches
    axes = batch_axes_for_mesh(mesh) if mesh is not None else None
    ranks = mesh.size(axes) if mesh is not None else 1
    checked = [mesh is None]

    def context():
        if mesh is None:
            return contextlib.nullcontext()
        return activation_sharding_ctx(axes, mesh=mesh,
                                       tensor_parallel=dims is not None)

    def all_reduce(grads, metrics, loss):
        names = sorted(metrics)
        (leaves, vals), seconds = synced_seconds(loss.device, lambda: (
            all_reduce_buckets(tree_leaves(grads), mesh, axes),
            mesh.psum(torch.stack([loss] + [metrics[k] for k in names]),
                      axes)))
        train_step.allreduce_seconds.append(seconds)
        return (tree_unflatten(grads, leaves),
                dict(zip(names, vals[1:])), vals[0])

    def train_step(state: TrainState, batch):
        if not checked[0]:
            if dims is None:
                check_same_state(state, mesh)
            else:
                check_tp_state([state.params, state.opt.master,
                                state.opt.m, state.opt.v, state.error_fb,
                                state.opt.step], dims, mesh)
            checked[0] = True
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        with context():
            loss, metrics, grads = accumulate(state, batch)
        if ranks > 1:
            grads, metrics, loss = all_reduce(grads, metrics, loss)

        error_fb = state.error_fb
        if tcfg.grad_compression != "none":
            gl, el = compress_parts(
                tree_leaves(grads), tree_leaves(error_fb),
                units(state.params), tcfg.grad_compression)
            grads = tree_unflatten(grads, gl)
            error_fb = tree_unflatten(error_fb, el)

        gnorm = (None if dims is None
                 else tp_global_norm(tree_leaves(grads), dims, mesh))
        params, opt, om = adamw_update(grads, state.opt, lr, tcfg,
                                       param_dtype=pdt, gnorm=gnorm)
        metrics = {**metrics, **om, "loss": loss, "lr": lr}
        return TrainState(params=params, opt=opt, error_fb=error_fb), metrics

    def accumulate(state: TrainState, batch):
        """(loss, metrics, f32 gradients) of this rank's batch, averaged
        over the microbatches."""
        if m > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.opt.step.device)
            sums: dict = {}
            for mb in _split_microbatches(batch, m):
                mloss, metrics, g = loss_and_grads(model, state.params, mb)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                loss = loss + mloss
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
            grads = tree_map(lambda g: g / m, grads)
            return loss / m, {k: v / m for k, v in sums.items()}, grads
        loss, metrics, grads = loss_and_grads(model, state.params, batch)
        return loss, metrics, tree_map(lambda g: g.to(torch.float32), grads)

    def units(params):
        """``reference_units`` of the rank's shards (memoized)."""
        if not unit_cache:
            unit_cache.append(reference_units(model, params, mesh, dims))
        return unit_cache[0]

    unit_cache: list = []
    train_step.allreduce_seconds = []
    train_step.accumulate = accumulate
    return train_step


def _make_zero1_step(model, tcfg, mesh, grad_specs, dims=None):
    """The ZeRO-1 train step (``make_train_step``'s docstring): its two
    halves are ``train_step.accumulate(state, batch)``, the loss, metrics
    and f32 gradients of the rank's rows, and ``train_step.update(state,
    accumulated)``, everything after; ``accumulated`` is a list of the
    three, which ``update`` empties so that the gradients are freed once
    cut to the rank's parts."""
    cfg = model.cfg
    pdt = dtype_of(cfg.param_dtype)
    axes = batch_axes_for_mesh(mesh)
    plain = make_train_step(model, tcfg).accumulate
    plans: list = []                # built on the first call

    def accumulate(state: TrainState, batch):
        with activation_sharding_ctx(axes, mesh=mesh,
                                     tensor_parallel=dims is not None):
            return plain(state, batch)

    def update(state: TrainState, accumulated: list):
        if not plans:
            if dims is None:
                check_same_state((state.params, state.opt.step), mesh)
            else:
                check_tp_state([state.params, state.opt.step], dims, mesh)
            plan = Zero1Plan(state.params, grad_specs, mesh, cfg, dims)
            units = (reference_units(model, state.params, mesh, dims,
                                     plan.parts)
                     if tcfg.grad_compression != "none" else None)
            plans.append((plan, units))
        plan, units = plans[0]
        loss, metrics, grads = accumulated
        accumulated.clear()
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        dev = loss.device
        parts, t_rs = synced_seconds(
            dev, lambda: plan.reduce_scatter(tree_leaves(grads)))
        del grads
        names = sorted(metrics)
        vals, t_ar = synced_seconds(dev, lambda: mesh.psum(
            torch.stack([loss] + [metrics[k] for k in names]), axes))
        metrics, loss = dict(zip(names, vals[1:])), vals[0]
        error_fb = state.error_fb
        if tcfg.grad_compression != "none":
            parts, fb = compress_parts(parts, tree_leaves(error_fb), units,
                                       tcfg.grad_compression)
            error_fb = tree_unflatten(error_fb, fb)
        parts = tree_unflatten(state.params, parts)
        gn = plan.global_norm(tree_leaves(parts))
        new_parts, opt, om = adamw_update(parts, state.opt, lr, tcfg,
                                          param_dtype=pdt, gnorm=gn)
        del parts
        leaves, t_ag = synced_seconds(
            dev, lambda: plan.all_gather(tree_leaves(new_parts)))
        train_step.reduce_scatter_seconds.append(t_rs)
        train_step.allreduce_seconds.append(t_ar)
        train_step.all_gather_seconds.append(t_ag)
        params = tree_unflatten(state.params, leaves)
        metrics = {**metrics, **om, "loss": loss, "lr": lr}
        return TrainState(params=params, opt=opt, error_fb=error_fb), metrics

    def train_step(state: TrainState, batch):
        return update(state, list(accumulate(state, batch)))

    train_step.accumulate = accumulate
    train_step.update = update
    train_step.reduce_scatter_seconds = []
    train_step.allreduce_seconds = []
    train_step.all_gather_seconds = []
    return train_step
