"""The train step: loss and gradients, microbatched accumulation, AdamW.

A port of the single-device half of ``repro/train/step.py``.  With
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
"""

from __future__ import annotations

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
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


def make_train_step(model, tcfg):
    """``train_step(state, batch) -> (state, metrics)``; metrics are f32
    scalar tensors ``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``
    and ``lr``.  ``batch`` is a dict of tensors on the parameters'
    device."""
    cfg = model.cfg
    pdt = dtype_of(cfg.param_dtype)
    m = tcfg.microbatches
    period = cfg.pattern_period
    n_enc = cfg.encoder.n_layers if cfg.is_encdec else 0

    def train_step(state: TrainState, batch):
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        if m > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32, device=lr.device)
            sums: dict = {}
            for mb in _split_microbatches(batch, m):
                mloss, metrics, g = loss_and_grads(model, state.params, mb)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                loss = loss + mloss
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
            grads = tree_map(lambda g: g / m, grads)
            loss = loss / m
            metrics = {k: v / m for k, v in sums.items()}
        else:
            loss, metrics, grads = loss_and_grads(model, state.params, batch)
            grads = tree_map(lambda g: g.to(torch.float32), grads)

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

    return train_step
