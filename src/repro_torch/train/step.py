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
layer's.  So the step compresses the gradients in the reference's
layout (``stack_layers``) and splits the result back: the same leaves,
the same thresholds and scales.

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
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import dtype_of
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_gradients,
    decompress_gradients,
    init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding.partitioning import (
    activation_sharding_ctx,
    batch_axes_for_mesh,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def unstack_layers(tree, period: int, n_layers: int, n_enc: int = 0):
    """The inverse of :func:`stack_layers`."""
    out = {k: v for k, v in tree.items() if k not in ("layers",
                                                      "enc_layers")}
    out["layers"] = [tree_map(lambda x: x[i // period],
                              tree["layers"][i % period])
                     for i in range(n_layers)]
    if "enc_layers" in tree:
        out["enc_layers"] = [tree_map(lambda x: x[i], tree["enc_layers"])
                             for i in range(n_enc)]
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


def check_same_state(state, mesh) -> None:
    """Raise unless every rank of ``mesh`` holds the same ``state``: each
    axis broadcasts its first member's checksum and every member
    compares its own."""
    mine = state_checksum(state)
    for axis in mesh.axis_names:
        first = mesh.broadcast(mine, axis, 0)
        if not torch.equal(first, mine):
            raise RuntimeError(
                f"rank {mesh.rank} starts from another state than the "
                f"first rank of axis {axis!r}: checksum "
                f"{mine.tolist()} against {first.tolist()}")


def make_train_step(model, tcfg, *, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``; metrics are f32
    scalar tensors ``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``
    and ``lr``.  ``batch`` is a dict of tensors on the parameters'
    device: the whole batch, or with ``mesh`` this rank's rows
    (``data.pipeline.shard_batch``).  With a mesh the step's
    ``allreduce_seconds`` lists each call's host seconds in the
    gradients' all-reduce (the device synchronized before and after)."""
    cfg = model.cfg
    pdt = dtype_of(cfg.param_dtype)
    m = tcfg.microbatches
    period = cfg.pattern_period
    n_enc = cfg.encoder.n_layers if cfg.is_encdec else 0
    axes = batch_axes_for_mesh(mesh) if mesh is not None else None
    ranks = mesh.size(axes) if mesh is not None else 1
    checked = [mesh is None]

    def context():
        if mesh is None:
            return contextlib.nullcontext()
        return activation_sharding_ctx(axes, mesh=mesh)

    def all_reduce(grads, metrics, loss):
        dev = loss.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        leaves = all_reduce_buckets(tree_leaves(grads), mesh, axes)
        names = sorted(metrics)
        vals = mesh.psum(torch.stack([loss] + [metrics[k] for k in names]),
                         axes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_step.allreduce_seconds.append(time.perf_counter() - t0)
        return (tree_unflatten(grads, leaves),
                dict(zip(names, vals[1:])), vals[0])

    def train_step(state: TrainState, batch):
        if not checked[0]:
            check_same_state(state, mesh)
            checked[0] = True
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        with context():
            loss, metrics, grads = _accumulate(state, batch)
        if ranks > 1:
            grads, metrics, loss = all_reduce(grads, metrics, loss)

        error_fb = state.error_fb
        if tcfg.grad_compression != "none":
            comp, error_fb = compress_gradients(
                stack_layers(grads, period), stack_layers(error_fb, period),
                tcfg.grad_compression)
            grads = unstack_layers(
                decompress_gradients(comp, tcfg.grad_compression),
                period, cfg.n_layers, n_enc)
            error_fb = unstack_layers(error_fb, period, cfg.n_layers, n_enc)

        params, opt, om = adamw_update(grads, state.opt, lr, tcfg,
                                       param_dtype=pdt)
        metrics = {**metrics, **om, "loss": loss, "lr": lr}
        return TrainState(params=params, opt=opt, error_fb=error_fb), metrics

    def _accumulate(state: TrainState, batch):
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

    train_step.allreduce_seconds = []
    return train_step
