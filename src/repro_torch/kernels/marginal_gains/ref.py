"""Plain PyTorch version of the batched regression marginal gains.

    gain(a) = (x_aᵀ r)² / (‖x_a‖² − ‖Qᵀ x_a‖²)

with gains of in-span columns (denominator ≤ tol·max(‖x_a‖², 1)) clamped
to 0.  Unnormalized — the objective divides by ‖y‖².  A transliteration
of ``repro/kernels/marginal_gains/ref.py``; broadcasting also takes a
leading lane axis (Q (G, d, k), resid (G, d) → (G, n)).  On the CPU the
sweep runs over fixed-width column blocks
(``kernels/common.py::by_column_blocks``), so a column's bits do not
depend on n.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_column_blocks

SPAN_TOL = 1e-6


def regression_gains_ref(X, Q, resid, col_sq, *, span_tol: float = SPAN_TOL):
    """X: (d, n), Q: (..., d, k) zero-padded orthonormal basis, resid:
    (..., d), col_sq: (n,) column squared norms of X.  Returns (..., n)."""
    return by_column_blocks(
        lambda Xb, c: _gains(Xb, Q, resid, c, span_tol), X, col_sq)


def _gains(X, Q, resid, col_sq, span_tol):
    c = resid @ X                                       # (..., n)
    B = Q.transpose(-1, -2) @ X                         # (..., k, n)
    denom = col_sq - torch.sum(B * B, dim=-2)           # (..., n)
    floor = span_tol * torch.clamp(col_sq, min=1.0)
    gains = (c * c) / torch.clamp(denom, min=1e-30)
    return torch.where(denom > floor, gains, torch.zeros_like(gains))
