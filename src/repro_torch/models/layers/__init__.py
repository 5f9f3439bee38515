"""Layers of the port's decoder LM (norms, rotary, MLP, MoE, attention,
RG-LRU)."""

import torch


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale²) weights drawn in f32 from ``gen`` on its device, then
    cast to ``dtype`` — the JAX init's ``normal(key, shape) * scale``."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)
