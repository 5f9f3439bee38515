"""γ / α estimation — the differential-submodularity parameters (paper §3).

Ports ``repro/core/spectral.py``:

* Regression (Cor. 7): γ = λ_min(2k)/λ_max(2k) of the feature
  covariance, the sparse eigenvalues estimated on random 2k-subsets.
* Classification (Cor. 8): the same covariance-ratio estimate, the
  standard practical surrogate for m/M.
* A-optimality (Cor. 9): γ = β² / (‖X‖² (β² + σ⁻² ‖X‖²)) in closed form.

α = γ² in every case.  The reference draws its subsets with
``jax.random.choice``, which no key of the port replays; here each probe
takes the top 2k of one Gumbel draw of its key (``core.random``'s one
noise layout), a uniform subset all the same.
"""

from __future__ import annotations

import torch

from repro_torch.core.estimators import gumbel_noise, top_k


def spectral_norm_sq(X: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """‖X‖² (the square of the largest singular value) by power
    iteration from the uniform start vector."""
    n = X.shape[1]
    v = torch.ones((n,), dtype=X.dtype, device=X.device) / (n ** 0.5)
    for _ in range(iters):
        u = X.T @ (X @ v)
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    return torch.dot(v, X.T @ (X @ v))


def probe_subsets(key, n: int, s: int, n_probes: int, device) -> torch.Tensor:
    """(n_probes, s) uniform s-subsets of range(n), one per child of
    ``key.split(n_probes)``: the top s of each child's Gumbel draw."""
    return torch.stack([top_k(gumbel_noise(pk, n, device), s)[1]
                        for pk in key.split(n_probes)])


def subset_eig_extremes(X: torch.Tensor, idx: torch.Tensor):
    """(λ_min, λ_max) of X_Rᵀ X_R / d for every subset R = idx[p]:
    idx (P, s) → two (P,) tensors."""
    cols = X[:, idx].permute(1, 0, 2)                 # (P, d, s)
    ev = torch.linalg.eigvalsh(cols.mT @ cols / X.shape[0])
    return ev[:, 0], ev[:, -1]


def sparse_eig_ratio(X: torch.Tensor, k: int, key,
                     n_probes: int = 32) -> torch.Tensor:
    """Estimate γ = λ_min(2k)/λ_max(2k) of the column covariance of X on
    ``n_probes`` random 2k-subsets (Def. 5 restriction)."""
    n = X.shape[1]
    idx = probe_subsets(key, n, min(2 * k, n), n_probes, X.device)
    mins, maxs = subset_eig_extremes(X, idx)
    lam_min = torch.clamp(torch.min(mins), min=0.0)
    return lam_min / torch.clamp(torch.max(maxs), min=1e-30)


def gamma_regression(X, k: int, key, n_probes: int = 32):
    return sparse_eig_ratio(X, k, key, n_probes)


def gamma_classification(X, k: int, key, n_probes: int = 32):
    """The covariance-spectrum ratio as the practical surrogate of the
    logistic RSC/RSM ratio m/M (the Hessian is Xᵀdiag(p(1−p))X with
    p(1−p) ∈ (0, 1/4])."""
    return sparse_eig_ratio(X, k, key, n_probes)


def gamma_aopt(X: torch.Tensor, beta2: float, sigma2: float) -> torch.Tensor:
    """Closed-form lower bound of Cor. 9."""
    xs = spectral_norm_sq(X)
    return beta2 / torch.clamp(xs * (beta2 + xs / sigma2), min=1e-30)


def alpha_from_gamma(gamma):
    """Differential submodularity parameter α = γ² (Cors. 7–9)."""
    return gamma * gamma
