"""Plain PyTorch version of the batched A-optimality (Sherman–Morrison)
gains.  Given the cached shared solve W = M⁻¹X:

    gain(a) = σ⁻² ‖w_a‖² / max(1 + σ⁻² x_aᵀ w_a, 1e-30)

A transliteration of ``repro/kernels/aopt_gains/ref.py``; broadcasting
also takes a leading lane axis on W (X (d, n) shared, W (G, d, n) →
(G, n)).

The sums over d are pairwise trees whose order depends on d alone, so a
column's gain has the same bits in a call over all n columns and in one
over a shard of them (``torch.sum`` over a non-inner dimension orders
each column's sum by its position among the n).
"""

from __future__ import annotations

import torch


def column_sums(x):
    """(..., d, n) → (..., n): each column summed over d by halving, an
    order fixed by d, so the bits do not depend on n."""
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        top = x[..., :h, :] + x[..., h:2 * h, :]
        x = torch.cat([top, x[..., 2 * h:, :]], dim=-2) if x.shape[-2] % 2 \
            else top
    return x[..., 0, :]


def aopt_gains_ref(X, W, isig2):
    """X: (d, n); W: (..., d, n); isig2 = 1/σ².  Returns (..., n)."""
    num = isig2 * column_sums(W * W)
    den = 1.0 + isig2 * column_sums(X * W)
    return num / torch.clamp(den, min=1e-30)
