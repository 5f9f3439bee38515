"""Plain PyTorch version of the batched 1-D-Newton logistic marginal gains.

For every candidate column a, ``steps`` scalar-Newton iterations on

    max_w  ℓ(y, η + x_a·w),   ℓ(y, z) = Σ_i y_i z_i − softplus(z_i)

starting from w = 0 (step 1 reproduces the Theorem-6 quadratic proxy
g²/2h), then the log-likelihood improvement ℓ_new − ℓ_old, clamped at 0.

A transliteration of ``repro/kernels/logistic_gains/ref.py`` and of the
TPU kernel's shared ``newton_gain_sweep`` (``kernel.py``), keeping the
reference's formula: ℓ_new − ℓ_old is the difference of two sums of
order d·ln 2, which cancels in f32 (the CUDA kernel sums per-row
differences instead; ``chip_smoke.py`` holds both against this function
run in float64).  softplus is ``torch.logaddexp(z, 0)``, as
``jax.nn.softplus``; ``torch.nn.functional.softplus`` cuts off at
``threshold=20`` and is another function.  The functions take any float
dtype, so float64 is the anchor of the kernels' parity gate.  On the CPU
the sweep runs over fixed-width column blocks (``kernels/common.py::
by_column_blocks``), so a column's bits do not depend on n.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_column_blocks


def softplus(z: torch.Tensor) -> torch.Tensor:
    """log(1 + e^z) without a cut-off, as ``jax.nn.softplus``."""
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))


def newton_gain_sweep(x, y, eta, *, steps: int, eps: float):
    """``steps`` scalar-Newton iterations per candidate column of ``x``
    (d, bn) at logits ``eta`` (d, 1), labels ``y`` (d, 1); returns the
    (1, bn) log-likelihood improvements."""
    w = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
    for _ in range(steps):
        z = eta + x * w                                 # (d, bn)
        p = torch.sigmoid(z)
        g = torch.sum(x * (y - p), dim=0, keepdim=True)
        h = torch.sum((x * x) * (p * (1.0 - p)), dim=0, keepdim=True)
        w = w + g / (h + eps)
    z = eta + x * w
    ll_new = torch.sum(y * z - softplus(z), dim=0, keepdim=True)
    ll_old = torch.sum(y * eta - softplus(eta))
    return torch.clamp(ll_new - ll_old, min=0.0)


def logistic_gains_ref(X, y, eta, *, steps: int = 3, eps: float = 1e-9):
    """X: (d, n), y: (d,) ∈ {0,1}, eta: (d,) current logits.  → (n,)."""
    return by_column_blocks(
        lambda Xb: newton_gain_sweep(Xb, y[:, None], eta[:, None],
                                     steps=steps, eps=eps), X)[0]
