"""Plain PyTorch version of the batched A-optimality (Sherman–Morrison)
gains.  Given the cached shared solve W = M⁻¹X:

    gain(a) = σ⁻² ‖w_a‖² / max(1 + σ⁻² x_aᵀ w_a, 1e-30)

A transliteration of ``repro/kernels/aopt_gains/ref.py``; broadcasting
also takes a leading lane axis on W (X (d, n) shared, W (G, d, n) →
(G, n)).
"""

from __future__ import annotations

import torch


def aopt_gains_ref(X, W, isig2):
    """X: (d, n); W: (..., d, n); isig2 = 1/σ².  Returns (..., n)."""
    num = isig2 * torch.sum(W * W, dim=-2)
    den = 1.0 + isig2 * torch.sum(X * W, dim=-2)
    return num / torch.clamp(den, min=1e-30)
