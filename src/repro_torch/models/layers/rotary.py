"""Rotary position embeddings (RoPE), angles in f32.

A transliteration of ``repro/models/layers/rotary.py``.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, scaling: float = 1.0,
               device=None):
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=device) / half))
    return inv / scaling


def apply_rope(x, positions, theta: float, scaling: float = 1.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, scaling, device=x.device)
    ang = positions.to(torch.float32)[..., None] * inv      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
