"""Mixture-of-Experts layer: token-choice top-k routing, capacity-bounded
sort dispatch, dense per-expert products.

A port of ``repro/models/layers/moe.py``:

  1. router logits → top-k (expert, weight) per token,
  2. stable-sort the T·k assignments by expert id,
  3. position in expert by segment arithmetic; assignments past the
     per-expert capacity C = int(⌈T·k/E⌉ · capacity_factor) are dropped,
  4. scatter into an (E, C, D) buffer, dense per-expert products,
  5. gather back, unsort, combine with the routing weights.

Only the JAX package's path without token groups is ported: its
``moe_groups`` flag defaults to 0, and the grouped dispatch (one sort per
data shard) and the expert-parallel sharding constraints come with the
port's ``sharding/`` (ROADMAP item 14.6).  The expert products are
``torch.bmm`` (the JAX package's ``einsum``, outside any Pallas kernel).

Ties: ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities; ``torch.topk`` documents no order for ties, so the port
takes the first k of a stable descending sort, which does.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import normal
from repro_torch.models.layers.mlp import _act


def expert_capacity(tk: int, e: int, capacity_factor: float) -> int:
    """Slots per expert for ``tk`` assignments over ``e`` experts: the
    reference's truncating ``int`` of a float product, at least 1."""
    return max(int(-(-tk // e) * capacity_factor), 1)


def route(params, xt, cfg):
    """xt: (T, D) → router probabilities (T, E) in f32, and each token's
    top-k weights (renormalised) and experts (T, k).  The router product
    runs in the compute dtype before the cast to f32, as the reference's."""
    logits = (xt @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_e = srt.values[:, :k], srt.indices[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def _dispatch_group(xt, flat_e, e: int, cap: int, topk: int):
    """Sort-based dispatch.  xt: (T, D), flat_e: (T·k,) expert ids.
    Returns (buf (E, cap, D), dest, keep, sort_idx, counts).  Every kept
    assignment has a slot of its own, so ``index_add_`` adds each once to
    a zero and the result does not depend on the order of the adds; the
    dropped ones (zeros) share the overflow slot E·cap, which is cut."""
    d = xt.shape[1]
    tk = flat_e.shape[0]
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)
    src = xt[sort_idx // topk]                             # (T·k, D)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, src * keep[:, None].to(xt.dtype))
    return buf[:e * cap].reshape(e, cap, d), dest, keep, sort_idx, counts


def _combine_group(out_buf, dest, keep, sort_idx, e: int, cap: int,
                   topk: int, dtype):
    """Inverse of ``_dispatch_group``: (E, cap, D) → (T, k, D)."""
    tk = dest.shape[0]
    d = out_buf.shape[-1]
    out_sorted = out_buf.reshape(e * cap, d)[torch.clamp(dest,
                                                         max=e * cap - 1)]
    out_sorted = out_sorted * keep[:, None].to(dtype)
    out_flat = torch.zeros((tk, d), dtype=dtype, device=out_buf.device)
    out_flat.index_copy_(0, sort_idx, out_sorted.to(dtype))
    return out_flat.reshape(tk // topk, topk, d)


def moe_apply(params, x, cfg):
    """x: (B, S, D) → (B, S, D), aux_loss (scalar f32)."""
    b, s, d = x.shape
    m = cfg.moe
    e, topk = m.n_experts, m.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, top_w, top_e = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)                              # (T·k,)
    tk = t * topk
    cap = expert_capacity(tk, e, m.capacity_factor)
    buf, dest, keep, sort_idx, counts = _dispatch_group(xt, flat_e, e, cap,
                                                        topk)
    h = torch.bmm(buf, params["w1"])
    if m.gated:
        h = _act(cfg.activation, h) * torch.bmm(buf, params["w3"])
    else:
        h = _act(cfg.activation, h)
    out_buf = torch.bmm(h, params["w2"])
    out = _combine_group(out_buf, dest, keep, sort_idx, e, cap, topk,
                         x.dtype)
    out = out * top_w[..., None].to(x.dtype)
    out = torch.sum(out, dim=1).reshape(b, s, d)

    # load-balance auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)                           # (E,)
    dispatch_frac = counts.to(torch.float32) / tk
    aux = e * torch.sum(me * dispatch_frac) * m.aux_loss_weight
    return out, aux


def dispatch_counts(params, x, cfg):
    """What ``moe_apply``'s dispatch does with x (B, S, D): each expert's
    routed assignments (E,), the assignments it keeps (E,), and the
    capacity."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    _, _, top_e = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)
    cap = expert_capacity(flat_e.shape[0], m.n_experts, m.capacity_factor)
    _, _, keep, sort_idx, counts = _dispatch_group(
        xt, flat_e, m.n_experts, cap, m.top_k)
    kept = torch.bincount(flat_e[sort_idx][keep], minlength=m.n_experts)
    return counts, kept, cap


def init_moe(gen, cfg, dtype):
    """Random weights with the JAX init's shapes and scales.  Each expert
    stack is drawn one expert at a time, so the f32 draw of a stack never
    lives whole (llama4-maverick's (128, 5120, 8192) is 21.5 GB in f32)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def stack(shape, scale):
        w = torch.empty((e,) + shape, dtype=dtype, device=gen.device)
        for i in range(e):
            w[i] = normal(gen, shape, scale, dtype)
        return w

    p = {"router": normal(gen, (d, e), d ** -0.5, dtype),
         "w1": stack((d, f), d ** -0.5),
         "w2": stack((f, d), f ** -0.5)}
    if cfg.moe.gated:
        p["w3"] = stack((d, f), d ** -0.5)
    return p
