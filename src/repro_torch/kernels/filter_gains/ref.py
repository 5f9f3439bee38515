"""Plain PyTorch versions of the sample-batched filter gains.

The filter step of DASH evaluates the batched gain vector at every
Monte-Carlo perturbed state S ∪ R_i, split into state shared by all
samples plus a small per-sample delta:

* regression: a shared orthonormal basis Q of span(X_S) plus per-sample
  delta columns D_i ⊥ Q and residual r_i, so

      gain_i(a) = (x_aᵀ r_i)² / (‖x_a‖² − ‖Qᵀ x_a‖² − ‖D_iᵀ x_a‖²)

  with the shared-base term computed once for all samples.  In-span
  candidates are clamped to 0 as in ``marginal_gains.ref``; the gains are
  unnormalized.
* A-optimality: the shared solve W = M⁻¹X plus per-sample Woodbury
  factors E_i with M_i⁻¹ = M⁻¹ − E_i E_iᵀ and Grams F_i = E_iᵀE_i.
* logistic: per-sample refit logits η_i; each row is exactly
  ``logistic_gains_ref`` at η_i.

Transliterations of ``repro/kernels/filter_gains/ref.py``, evaluated on
the CPU over fixed-width column blocks
(``kernels/common.py::by_column_blocks``) so that a column's bits do not
depend on n.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_column_blocks
from repro_torch.kernels.logistic_gains.ref import logistic_gains_ref

SPAN_TOL = 1e-6


def filter_gains_ref(X, Q, D, R, col_sq, *, span_tol: float = SPAN_TOL):
    """X: (d, n); Q: (d, k) shared zero-padded orthonormal basis;
    D: (m, d, b) per-sample delta bases (zero-padded, ⊥ Q);
    R: (m, d) per-sample residuals; col_sq: (n,).  Returns (m, n) f32."""
    return by_column_blocks(
        lambda Xb, c: _filter_gains(Xb, Q, D, R, c, span_tol), X, col_sq)


def _filter_gains(X, Q, D, R, col_sq, span_tol):
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


def aopt_filter_gains_ref(X, W, E, F, isig2):
    """X: (d, n); W = M⁻¹X (d, n) shared solve; E: (m, d, b) per-sample
    Woodbury factors (zero-padded columns); F: (m, b, b) Grams E_iᵀE_i;
    isig2 = 1/σ².  Returns (m, n) f32 gains

        σ⁻² ‖M_i⁻¹x_a‖² / (1 + σ⁻² x_aᵀM_i⁻¹x_a).
    """
    return by_column_blocks(
        lambda Xb, Wb: _aopt_filter_gains(Xb, Wb, E, F, isig2), X, W)


def _aopt_filter_gains(X, W, E, F, isig2):
    wsq = torch.sum(W * W, dim=0)                       # (n,) — shared
    xw = torch.sum(X * W, dim=0)                        # (n,) — shared
    T = torch.einsum("mdb,dn->mbn", E, X)               # E_iᵀ X
    U = torch.einsum("mdb,dn->mbn", E, W)               # E_iᵀ W
    FT = torch.einsum("mbc,mcn->mbn", F, T)
    num = (wsq[None, :] - 2.0 * torch.sum(U * T, dim=1)
           + torch.sum(T * FT, dim=1))
    den = 1.0 + isig2 * (xw[None, :] - torch.sum(T * T, dim=1))
    # num is a squared norm: clamp the f32 cancellation residue at 0.
    return isig2 * torch.clamp(num, min=0.0) / torch.clamp(den, min=1e-30)


def aopt_filter_gains_lattice_ref(X, W, E, F, isig2):
    """Per-guess shared solves W: (G, d, n), factors E: (G, m, d, b),
    Grams F: (G, m, b, b); shared X: (d, n).  Returns (G, m, n)."""
    return torch.stack([
        aopt_filter_gains_ref(X, W[g], E[g], F[g], isig2)
        for g in range(W.shape[0])
    ])


def logistic_filter_gains_ref(X, y, etas, *, steps: int = 3,
                              eps: float = 1e-9):
    """X: (d, n); y: (d,); etas: (S, d) per-sample refit logits.  Row i
    is ``logistic_gains_ref`` at η_i — (S, n) gains.  One state at a
    time: a (S, d, n) temporary would be 12.9 GB in f32 at the main
    path's d = n = 8192, S = 48."""
    out = torch.empty((etas.shape[0], X.shape[1]), dtype=X.dtype,
                      device=X.device)
    for i, eta in enumerate(etas):
        out[i] = logistic_gains_ref(X, y, eta, steps=steps, eps=eps)
    return out


def logistic_filter_gains_lattice_ref(X, y, etas, *, steps: int = 3,
                                      eps: float = 1e-9):
    """Per-guess logits etas: (G, m, d); shared X: (d, n), y: (d,).
    Returns (G, m, n)."""
    g, m, d = etas.shape
    out = logistic_filter_gains_ref(X, y, etas.reshape(g * m, d),
                                    steps=steps, eps=eps)
    return out.reshape(g, m, -1)
