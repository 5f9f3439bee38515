"""Plain PyTorch versions of the sample-batched regression filter gains.

The filter step of DASH evaluates the batched gain vector at every
Monte-Carlo perturbed state S ∪ R_i.  The state splits into a shared
orthonormal basis Q of span(X_S) plus per-sample delta columns D_i ⊥ Q
and residual r_i, so

    gain_i(a) = (x_aᵀ r_i)² / (‖x_a‖² − ‖Qᵀ x_a‖² − ‖D_iᵀ x_a‖²)

with the shared-base term computed once for all samples.  In-span
candidates are clamped to 0 as in ``marginal_gains.ref``; the gains are
unnormalized.  Transliterations of the regression parts of
``repro/kernels/filter_gains/ref.py``.
"""

from __future__ import annotations

import torch

SPAN_TOL = 1e-6


def filter_gains_ref(X, Q, D, R, col_sq, *, span_tol: float = SPAN_TOL):
    """X: (d, n); Q: (d, k) shared zero-padded orthonormal basis;
    D: (m, d, b) per-sample delta bases (zero-padded, ⊥ Q);
    R: (m, d) per-sample residuals; col_sq: (n,).  Returns (m, n) f32."""
    c = R @ X                                           # (m, n)
    B = Q.T @ X                                         # (k, n)
    base = torch.sum(B * B, dim=0)                      # (n,) — shared
    BD = torch.einsum("mdb,dn->mbn", D, X)              # (m, b, n)
    sd = torch.sum(BD * BD, dim=1)                      # (m, n)
    denom = (col_sq - base)[None, :] - sd
    floor = span_tol * torch.clamp(col_sq, min=1.0)
    gains = (c * c) / torch.clamp(denom, min=1e-30)
    return torch.where(denom > floor[None, :], gains, torch.zeros_like(gains))


def filter_gains_lattice_ref(X, Q, D, R, col_sq, *,
                             span_tol: float = SPAN_TOL):
    """Per-guess bases Q: (G, d, k), deltas D: (G, m, d, b), residuals
    R: (G, m, d); shared X: (d, n), col_sq: (n,).  Returns (G, m, n)."""
    return torch.stack([
        filter_gains_ref(X, Q[g], D[g], R[g], col_sq, span_tol=span_tol)
        for g in range(Q.shape[0])
    ])
