"""Normalization layers.  All normalize in f32 and cast back.

A transliteration of ``repro/models/layers/norms.py``.  ``nonparametric``
is OLMo's LayerNorm without affine parameters (arXiv:2402.00838 §2).
"""

from __future__ import annotations

import torch


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm in the ``(1 + scale)`` form (scale initialised to 0)."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf / torch.sqrt(ms + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) / torch.sqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def nonparametric_ln(x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, params, x):
    """Dispatch by config.norm.  ``params`` may be None (nonparametric)."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparametric":
        return nonparametric_ln(x)
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)
