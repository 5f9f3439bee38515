"""γ / α of A-optimal design — the differential-submodularity parameters
(paper §3, Cor. 9).

Ports ``spectral_norm_sq``, ``gamma_aopt`` and ``alpha_from_gamma`` of
``repro/core/spectral.py``:

    γ = β² / (‖X‖² (β² + σ⁻² ‖X‖²)),    α = γ²

The sampled sparse-eigenvalue estimates of regression and
classification wait for the registry slice.
"""

from __future__ import annotations

import torch


def spectral_norm_sq(X: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """‖X‖² (the square of the largest singular value) by power
    iteration from the uniform start vector."""
    n = X.shape[1]
    v = torch.ones((n,), dtype=X.dtype, device=X.device) / (n ** 0.5)
    for _ in range(iters):
        u = X.T @ (X @ v)
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    return torch.dot(v, X.T @ (X @ v))


def gamma_aopt(X: torch.Tensor, beta2: float, sigma2: float) -> torch.Tensor:
    """Closed-form lower bound of Cor. 9."""
    xs = spectral_norm_sq(X)
    return beta2 / torch.clamp(xs * (beta2 + xs / sigma2), min=1e-30)


def alpha_from_gamma(gamma):
    """Differential submodularity parameter α = γ² (Cors. 7–9)."""
    return gamma * gamma
