"""Mixture-of-Experts layer: token-choice top-k routing, capacity-bounded
sort dispatch, dense per-expert products.

A port of ``repro/models/layers/moe.py``:

  1. router logits → top-k (expert, weight) per token,
  2. stable-sort the T·k assignments by expert id,
  3. position in expert by segment arithmetic; assignments past the
     per-expert capacity C = int(⌈T·k/E⌉ · capacity_factor) are dropped,
  4. scatter into an (E, C, D) buffer, dense per-expert products,
  5. gather back, unsort, combine with the routing weights.

With ``moe_groups = G`` (``sharding/flags.py``) the tokens are cut into
G groups of whole rows, in order, and each group is dispatched on its
own (its own sort, capacity C = int(⌈T·k/(G·E)⌉ · capacity_factor)),
the G buffers laid out (E, G·C, D) for the expert products, as the
reference's vmapped dispatch.  The expert products are ``torch.bmm``
(the JAX package's ``einsum``, outside any Pallas kernel).

Data parallel (``sharding.activation_sharding_ctx`` with a mesh): this
rank holds its block of the global batch's rows, and the layer computes
the reference's function of the global batch.
  * The load-balance loss is global: the sums of ``probs`` (with
    autograd, so that each rank's gradient is its rows' share) and the
    expert counts are summed over the batch axes before ``aux`` is
    formed.
  * With groups, a multiple of the batch axes' ranks, each rank's rows
    are whole groups of the global batch (group g holds rows
    [g·B/G, (g+1)·B/G), and rank r rows [r·B/R, (r+1)·B/R)), so the
    dispatch needs no collective; any other group count raises.
  * Without groups the reference sorts all T·k assignments of the
    global batch together and keeps the first C of each expert, in
    token order.  An assignment's place in its expert is its place
    among this rank's assignments plus the count of that expert's
    assignments on the ranks before it (rows earlier in the batch), so
    one all-gather of the (E,) counts makes every keep-or-drop decision
    the reference's.  That is exact; each rank's buffer keeps the
    global capacity's E·C rows (the other ranks' slots stay zero), so
    the expert products cost each rank what the whole batch's cost one
    device, as they do in the reference's single global dispatch.

Tensor parallel (``sharding/tensor_parallel.py``): where E divides the
``model`` axis each rank holds E/M experts; every rank routes the same
replicated tokens into the same buffer, runs its own experts, and the
combined outputs are summed over ``model``: capacity, drops and the aux
loss are the single-device ones.  Otherwise d_ff is split inside every
expert and the expert products are summed over ``model``.

Ties: ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities; ``torch.topk`` documents no order for ties, so the port
takes the first k of a stable descending sort, which does.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import normal
from repro_torch.models.layers.mlp import _act
from repro_torch.sharding.flags import get_flags
from repro_torch.sharding.partitioning import batch_group
from repro_torch.sharding.tensor_parallel import model_group


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


def expert_counts(flat_e, e: int):
    """(E,) int64 count of each expert's assignments: ``bincount`` with
    ``minlength`` E, as a scatter-add, whose output shape does not depend
    on the data (it runs on ``meta`` tensors, in the dry run)."""
    return torch.zeros((e,), dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def _dispatch_group(xt, flat_e, e: int, cap: int, topk: int, before=None):
    """Sort-based dispatch.  xt: (T, D), flat_e: (T·k,) expert ids.
    Returns (buf (E, cap, D), dest, keep, sort_idx, counts).  Every kept
    assignment has a slot of its own, so ``index_add_`` adds each once to
    a zero and the result does not depend on the order of the adds; the
    dropped ones (zeros) share the overflow slot E·cap, which is cut.
    ``before`` (E,) counts each expert's assignments ahead of these
    (other ranks' rows): an assignment's slot is its place after them."""
    d = xt.shape[1]
    tk = flat_e.shape[0]
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = expert_counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    if before is not None:
        starts = starts - before
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
    """x: (B, S, D) → (B, S, D), aux_loss (scalar f32).  Under a
    data-parallel context x is this rank's rows and aux_loss the global
    batch's (the same on every rank)."""
    b, s, d = x.shape
    m = cfg.moe
    e, topk = m.n_experts, m.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, top_w, top_e = route(params, xt, cfg)
    tpg = model_group(cfg)
    mode = tpg.layout.moe if tpg is not None else None
    if mode == "experts":
        _check_routing(tpg, top_e)
        # the dispatch and the combine feed only this rank's experts:
        # their gradients are summed over model (the router's and the
        # aux loss's are whole on every rank)
        xt, top_w = tpg.enter(xt), tpg.enter(top_w)
    flat_e = top_e.reshape(-1)                              # (T·k,)
    tk = t * topk
    grp = batch_group()
    ranks = grp.size if grp is not None else 1
    groups = get_flags().moe_groups
    if groups and (b * ranks) % groups == 0:
        if groups % ranks:
            raise ValueError(f"moe_groups={groups} is not a multiple of the "
                             f"{ranks} ranks of the batch axes: a group "
                             f"would span ranks")
        g = groups // ranks                 # this rank's whole groups
        cap = expert_capacity(tk * ranks, groups * e, m.capacity_factor)
        parts = [_dispatch_group(xg, eg, e, cap, topk) for xg, eg in zip(
            xt.reshape(g, t // g, d), flat_e.reshape(g, tk // g))]
        # (G, E, cap, D) → (E, G·cap, D)
        buf = torch.stack([p[0] for p in parts], 1).reshape(e, g * cap, d)
        counts = torch.stack([p[4] for p in parts]).sum(0)
    else:
        g = 1
        cap = expert_capacity(tk * ranks, e, m.capacity_factor)
        before = None
        if grp is not None:
            every = grp.all_gather(expert_counts(flat_e, e))
            before = every[:grp.index].sum(0)
        parts = [_dispatch_group(xt, flat_e, e, cap, topk, before)]
        buf, counts = parts[0][0], parts[0][4]
    out_buf = _experts(params, buf, cfg, tpg, mode)
    out_g = out_buf.reshape(e, g, cap, d).transpose(0, 1)
    # expert parallel: this rank's experts' part of every token, summed
    # over model in f32
    cdt = torch.float32 if mode == "experts" else x.dtype
    out = torch.cat([_combine_group(ob, p[1], p[2], p[3], e, cap, topk,
                                    cdt)
                     for ob, p in zip(out_g, parts)])   # (T, k, D)
    out = out * top_w[..., None].to(cdt)
    out = torch.sum(out, dim=1)
    if mode == "experts":
        out = tpg.reduce(out, x.dtype)
    out = out.reshape(b, s, d)

    # load-balance auxiliary loss (Switch-style), over the global batch
    if grp is None:
        me = torch.mean(probs, dim=0)                       # (E,)
    else:
        me = grp.psum_grad(torch.sum(probs, dim=0)) / (t * ranks)
        counts = grp.psum(counts)
    dispatch_frac = counts.to(torch.float32) / (tk * ranks)
    aux = e * torch.sum(me * dispatch_frac) * m.aux_loss_weight
    return out, aux


def _experts(params, buf, cfg, tpg, mode):
    """The expert products of the dispatch buffer (E, C, D).  Under
    tensor parallelism: ``experts``, this rank's block of experts, the
    other blocks zero; ``dff``, every expert on the rank's columns of
    d_ff, the partial products summed over ``model`` in f32."""
    e = buf.shape[0]
    lo = el = 0
    if mode == "experts":
        el = params["w1"].shape[0]
        lo = tpg.index * el
        buf = buf[lo:lo + el]
    elif mode == "dff":
        buf = tpg.enter(buf)
    h = torch.bmm(buf, params["w1"])
    if cfg.moe.gated:
        h = _act(cfg.activation, h) * torch.bmm(buf, params["w3"])
    else:
        h = _act(cfg.activation, h)
    if mode == "dff":
        return tpg.reduce(torch.bmm(h.float(), params["w2"].float()),
                          h.dtype)
    out = torch.bmm(h, params["w2"])
    if mode == "experts":
        rest = tuple(out.shape[1:])
        out = torch.cat([out.new_zeros((lo,) + rest), out,
                         out.new_zeros((e - lo - el,) + rest)])
    return out


def _check_routing(tpg, top_e) -> None:
    """Raise unless every rank of ``model`` routed the tokens alike (the
    expert-parallel layer's premise), checked on the first call in a
    context (not on ``meta`` tensors)."""
    if top_e.device.type == "meta" or not tpg.once("moe-routing"):
        return
    first = tpg.mesh.broadcast(top_e.contiguous(), "model", 0)
    if not torch.equal(first, top_e):
        raise RuntimeError(f"model rank {tpg.index} routes other experts "
                           "than rank 0")


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
        if gen.device.type == "meta":            # shapes only
            return normal(gen, (e,) + shape, scale, dtype)
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
