"""Layers of the port's decoder LM (norms, rotary, MLP, MoE, attention,
RG-LRU)."""

import torch


class MetaGenerator:
    """Stands in for the generator of an init: every tensor it draws or
    allocates is a ``meta`` tensor (shape and dtype, no storage)."""

    device = torch.device("meta")
    generator = torch.Generator()


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale²) weights drawn in f32 from ``gen`` on its device, then
    cast to ``dtype`` — the JAX init's ``normal(key, shape) * scale``."""
    w = torch.randn(shape, generator=getattr(gen, "generator", gen),
                    device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)
