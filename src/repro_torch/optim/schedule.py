"""Learning-rate schedules (a port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio · base_lr`` at ``total_steps``.  ``step``: an
    integer tensor; returns an f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
