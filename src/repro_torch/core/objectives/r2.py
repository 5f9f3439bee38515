"""R² goodness-of-fit objective (paper Appendix F).

Ports ``repro/core/objectives/r2.py``:

    R²(S) = b_Sᵀ C_S⁻¹ b_S

with C the predictor correlation matrix and b the predictor–response
correlations, for standardized variables (App. F Def. 14).  After
standardization this is the normalized ℓ_reg variance reduction, so the
oracle is the regression objective on standardized data, with its
kernels (the singleton sweep and the filter engine) on the card;
``brute_r2`` evaluates Def. 14 directly as the test oracle.
"""

from __future__ import annotations

import torch

from repro_torch.core.objectives.base import normalize_columns
from repro_torch.core.objectives.regression import RegressionObjective


def standardize(X, y):
    """Zero-mean unit-norm columns; y centred to zero mean."""
    Xs = normalize_columns(torch.as_tensor(X, dtype=torch.float32))
    y = torch.as_tensor(y, dtype=torch.float32)
    return Xs, y - torch.mean(y)


class R2Objective(RegressionObjective):
    """f(S) = R²(S) on standardized data; f ∈ [0, 1]."""

    def __init__(self, X, y, kmax: int, **kw):
        Xs, ys = standardize(X, y)
        super().__init__(Xs, ys, kmax, **kw)

    def brute_r2(self, sel_idx):
        """Direct Def.-14 evaluation: b_Sᵀ C_S⁻¹ b_S (test oracle)."""
        idx = torch.as_tensor(sel_idx, device=self.device).long()
        Xs = self.X[:, idx]
        C = Xs.T @ Xs
        b = Xs.T @ (self.y / torch.clamp(torch.linalg.norm(self.y),
                                         min=1e-12))
        sol = torch.linalg.solve(C, b)
        return torch.dot(b, sol)
