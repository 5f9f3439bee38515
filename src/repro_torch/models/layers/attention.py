"""Attention: GQA + RoPE + sliding window + logit softcap.

A port of ``repro/models/layers/attention.py``.  Three prefill and
training paths, selected by ``impl``:

  * ``kernel``  — the flash-attention wrapper
                  (``repro_torch.kernels.flash_attention``), the
                  counterpart of the JAX package's ``"pallas"``: the
                  hand-written CUDA kernel on a CUDA tensor, its plain
                  version on a CPU tensor.  That plain version
                  materialises the (S, S) scores, so on a CPU tensor it
                  is also the JAX package's ``full`` (``full_attention``).
  * ``full``    — ``full_attention``, the plain version above on any
                  device: what ``Model.loss`` runs up to 1024 positions,
                  as the JAX package's loss does (the kernel has no
                  backward, and the reference's loss never reaches it).
  * ``chunked`` — the online-softmax recurrence over KV chunks as a host
                  loop (the JAX package's ``lax.map`` × ``lax.scan``);
                  O(chunk²) score memory.

Decode (one query position against a KV cache) has its own entry point
over linear and ring-buffer caches.  ``cache_update`` writes the cache in
place (the JAX package returns a new one; in place saves a copy of every
layer's cache per token) and returns it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.layers import normal
from repro_torch.models.layers.rotary import apply_rope
from repro_torch.sharding.tensor_parallel import model_group, partial_matmul

NEG_INF = -1e30


def _softcap(scores, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def _group_q(q, n_kv: int):
    """(B, S, H, D) → (B, S, Hkv, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _valid(rel, causal: bool, window: int):
    valid = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        valid &= rel >= 0
    if window and window > 0:
        valid &= rel < window
    return valid


def _mode(cfg):
    """(the model group, its attention layout) where the context shards
    this config's attention, else (None, None)."""
    grp = model_group(cfg)
    mode = grp.layout.attn if grp is not None else None
    return (grp, mode) if mode else (None, None)


def qkv_project(params, x, cfg):
    """x: (B, S, D) → q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh).

    Under tensor parallelism (``sharding/tensor_parallel.py``):
    on the head path this rank's heads (the weights' columns), on the
    contracting path every head, from the rank's rows of the weights and
    its slice of x, the partial products summed over ``model``."""
    b, s, _ = x.shape
    a = cfg.attn
    grp, mode = _mode(cfg)
    hq, hkv = a.n_heads, a.n_kv_heads
    if mode == "contract":
        # one sum over model for the three partial products
        w = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
        qkv = grp.reduce(partial_matmul(grp.slice_last(x), w), x.dtype)
        q, k, v = (t.contiguous() for t in torch.split(
            qkv, [hq * a.head_dim, hkv * a.head_dim, hkv * a.head_dim],
            dim=-1))
    else:
        if mode == "heads":
            x = grp.enter(x)
            hq, hkv = hq // grp.size, hkv // grp.size
        q = x @ params["wq"]
        k = x @ params["wk"]
        v = x @ params["wv"]
    if a.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, hq, a.head_dim)
    k = k.reshape(b, s, hkv, a.head_dim)
    v = v.reshape(b, s, hkv, a.head_dim)
    return q, k, v


# The plain attention that materialises the (S, S) scores is the flash
# kernel's plain version; under the JAX package's name it is the
# reference for ``chunked`` and ``decode_attention``.
full_attention = flash_attention_ref


def chunked_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                      q_chunk: int = 512, kv_chunk: int = 512,
                      q_offset: int = 0):
    """Flash-style attention: a host loop over q chunks, and within each
    the online-softmax recurrence over kv chunks.  Equals
    ``full_attention`` up to f32 rounding."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    nkv = -(-skv // kv_chunk)
    pad_kv = nkv * kv_chunk - skv
    kr, vr = k, v
    if pad_kv:
        kr = F.pad(kr, (0, 0, 0, 0, 0, pad_kv))
        vr = F.pad(vr, (0, 0, 0, 0, 0, pad_kv))
    kr = kr.reshape(b, nkv, kv_chunk, hkv, d).permute(1, 0, 3, 2, 4)
    vr = vr.reshape(b, nkv, kv_chunk, hkv, d).permute(1, 0, 3, 2, 4)
    # kr/vr: (nkv, B, Hkv, kv_chunk, D)

    nq = -(-sq // q_chunk)
    pad_q = nq * q_chunk - sq
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    qp = qp.reshape(b, nq, q_chunk, hkv, g, d).permute(1, 0, 3, 4, 2, 5)
    # qp: (nq, B, Hkv, G, q_chunk, D)

    outs = []
    for qi in range(nq):
        qc = qp[qi]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=dev)
        for ci in range(nkv):
            kc, vc = kr[ci], vr[ci]
            kpos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc).to(torch.float32) \
                * scale
            s = _softcap(s, softcap)
            rel = qpos[:, None] - kpos[None, :]
            valid = (kpos < skv)[None, :] & _valid(rel, causal, window)
            s = torch.where(valid[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(qc.dtype), vc).to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    # (nq, B, Hkv, G, q_chunk, D) → (B, Sq, H, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, nq * q_chunk, h, d)
    return out[:, :sq].to(q.dtype)


def _decode_scores(q, k_cache, cache_positions, pos, window, softcap):
    """(scores (B, Hkv, G, 1, C) in f32, masked; valid (B, C))."""
    d = q.shape[-1]
    qg = _group_q(q, k_cache.shape[2])                     # (B,1,Hkv,G,D)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).to(torch.float32) \
        * scale
    s = _softcap(s, softcap)
    rel = pos[:, None] - cache_positions                   # (B, C)
    valid = (cache_positions >= 0) & (rel >= 0)
    if window and window > 0:
        valid &= rel < window
    return torch.where(valid[:, None, None, None, :], s, NEG_INF), valid


def decode_attention(q, k_cache, v_cache, cache_positions, pos, *,
                     window: int, softcap: float):
    """Single-step decode: q (B, 1, H, D) against a cache (B, C, Hkv, D).

    ``cache_positions``: (B, C) absolute position held in each slot
    (−1 = empty); linear caches and ring buffers alike.  Grouped einsum:
    the cache is read once, never head-repeated.
    """
    b, _, h, d = q.shape
    s, _ = _decode_scores(q, k_cache, cache_positions, pos, window, softcap)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache)
    return out.reshape(b, 1, h, d)


def merge_partials(m, l, acc, grp):
    """The softmax-weighted values over every rank's slots from each
    rank's row maxima ``m``, sums ``l`` and unnormalised values ``acc``
    (f32): the maxima's maximum over ``model``, then the sums of the
    rescaled sums and values (one sum for both)."""
    mx = grp.pmax(m)
    c = torch.exp(m - mx)
    both = grp.psum(torch.cat([acc * c[..., None], (l * c)[..., None]],
                              dim=-1))
    return both[..., :-1] / both[..., -1:]


def decode_attention_slots(q, k_cache, v_cache, cache_positions, pos, grp,
                           *, window: int, softcap: float):
    """``decode_attention`` over a cache whose slots are split over
    ``model``: each rank attends over its own slots (their positions
    ``cache_positions``, (B, C/M)) and the parts merge by log-sum-exp
    (:func:`merge_partials`).  A rank with no valid slot contributes
    nothing (its maxima are −1e30, its terms 0)."""
    b, _, h, d = q.shape
    s, valid = _decode_scores(q, k_cache, cache_positions, pos, window,
                              softcap)
    m = torch.amax(s, dim=-1)                              # (B,Hkv,G,1)
    p = torch.where(valid[:, None, None, None, :],
                    torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.to(torch.float32))
    out = merge_partials(m, p.sum(-1), acc, grp)           # (B,Hkv,G,1,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor            # (B, C, Hkv, Dh)
    v: torch.Tensor            # (B, C, Hkv, Dh)
    positions: torch.Tensor    # (B, C) int32; −1 = empty


class SlotKVCache(KVCache):
    """This rank's block of a KV cache whose slots are split over
    ``model`` (``cache_partition_specs``): slots [i·C, (i + 1)·C) of the
    M·C at coordinate i; ``positions`` is this block's (B, C) where the
    placement splits it too, else the whole (B, M·C)."""
    __slots__ = ()


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        positions=torch.full((batch, capacity), -1, dtype=torch.int32,
                             device=device),
    )


def cache_update(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Write one step at absolute position ``pos`` (B,) into the cache, in
    place.  Ring semantics: slot = pos % capacity (a linear cache has
    capacity ≥ the positions it holds, so the mod is the identity)."""
    cap = cache.k.shape[1]
    slot = (pos % cap).long()                               # (B,)
    bidx = torch.arange(cache.k.shape[0], device=cache.k.device)
    cache.k[bidx, slot] = k_new[:, 0]
    cache.v[bidx, slot] = v_new[:, 0]
    cache.positions[bidx, slot] = pos.to(cache.positions.dtype)
    return cache


def cache_update_slots(cache: SlotKVCache, k_new, v_new, pos, grp):
    """``cache_update`` on this rank's block of a slot-split cache: the
    rank that owns slot pos % capacity writes the step, the others
    rewrite what they hold (shapes do not depend on the data)."""
    cl = cache.k.shape[1]
    cap, lo = cl * grp.size, grp.index * cl
    slot = (pos % cap).long()
    own = (slot >= lo) & (slot < lo + cl)
    local = torch.clamp(slot - lo, 0, cl - 1)
    bidx = torch.arange(cache.k.shape[0], device=cache.k.device)
    for t, new in ((cache.k, k_new), (cache.v, v_new)):
        t[bidx, local] = torch.where(own[:, None, None], new[:, 0],
                                     t[bidx, local])
    p = pos.to(cache.positions.dtype)
    if cache.positions.shape[1] == cl:
        cache.positions[bidx, local] = torch.where(
            own, p, cache.positions[bidx, local])
    else:
        cache.positions[bidx, slot] = p
    return cache


def slot_positions(cache: SlotKVCache, grp):
    """The positions (B, C) of this rank's block of slots."""
    cl = cache.k.shape[1]
    if cache.positions.shape[1] == cl:
        return cache.positions
    return cache.positions[:, grp.index * cl:(grp.index + 1) * cl]


def attention_output(params, attn_out, cfg):
    """(B, S, H, Dh) → (B, S, D).  Under tensor parallelism:
    on the head path the rank's heads through its rows of ``wo``, summed
    over ``model``; on the contracting path every head through its
    columns, all-gathered."""
    b, s, h, d = attn_out.shape
    o = attn_out.reshape(b, s, h * d)
    grp, mode = _mode(cfg)
    if mode == "heads":
        return grp.reduce(partial_matmul(o, params["wo"]), o.dtype)
    if mode == "contract":
        return grp.gather_last(grp.enter(o) @ params["wo"])
    return o @ params["wo"]


def attention_block(params, x, cfg, *, impl: str, positions,
                    window_override=None):
    """Prefill attention block: projection, RoPE, mixing, output.
    ``window_override`` replaces the config's window (``local_attn``).

    Returns (y, k, v) with k roped: the prefill writes them to the cache,
    so q/k/v are computed once (the JAX package projects twice; the
    function is the same)."""
    a = cfg.attn
    window = a.window if window_override is None else window_override
    q, k, v = qkv_project(params, x, cfg)
    q = apply_rope(q, positions, a.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, a.rope_theta, cfg.rope_scaling)
    kwargs = dict(causal=a.causal, window=window, softcap=a.softcap)
    if impl == "chunked":
        o = chunked_attention(q, k, v, **kwargs)
    elif impl == "full":
        o = full_attention(q, k, v, **kwargs)
    elif impl == "kernel":
        o = flash_attention(q, k, v, **kwargs)
    else:
        raise ValueError(impl)
    return attention_output(params, o, cfg), k, v


def init_attention(gen, cfg, dtype):
    """Random weights with the JAX init's shapes and scales."""
    a = cfg.attn
    d = cfg.d_model
    hq, hk = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    p = {
        "wq": normal(gen, (d, hq), d ** -0.5, dtype),
        "wk": normal(gen, (d, hk), d ** -0.5, dtype),
        "wv": normal(gen, (d, hk), d ** -0.5, dtype),
        "wo": normal(gen, (hq, d), hq ** -0.5, dtype),
    }
    if a.qkv_bias:
        for name, n in (("bq", hq), ("bk", hk), ("bv", hk)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p
