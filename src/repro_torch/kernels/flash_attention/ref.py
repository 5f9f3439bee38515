"""Plain PyTorch version of flash attention (GQA, causal, sliding window,
logit softcap, ``q_offset``).

The function of ``repro/kernels/flash_attention/ref.py``: the (B, H,
Sq, Skv) scores materialised, GQA by grouped einsums (query heads
h·G … h·G + G − 1 read KV head h), so the KV repeat is never
materialised.  The scores are taken in the inputs' type and then cast to
f32, as the reference does; the probabilities are cast back to the
inputs' type before P·V.  It is also the port's ``full`` attention
(``repro_torch.models.layers.attention.full_attention``).
``NEG_INF`` stays finite (−1e30), so a fully masked row is a uniform
softmax, not a NaN.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: True where query row i may see key j."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(skv, device=device)
    rel = qpos[:, None] - kpos[None, :]
    valid = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        valid &= rel >= 0
    if window and window > 0:
        valid &= rel < window
    return valid


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D).  Returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    s = s / math.sqrt(d)
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = attention_mask(sq, skv, causal=causal, window=window,
                           q_offset=q_offset, device=q.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v)
    return out.reshape(b, sq, h, d)
