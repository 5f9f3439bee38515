"""LASSO baseline (paper §5, App. I.3) — FISTA in PyTorch.

Ports ``repro/core/lasso.py``: accelerated proximal gradient with ℓ1
soft-thresholding for the linear and logistic losses, and a warm-started
log-spaced λ path whose support size comes closest to the target k (the
paper's "manually varying the regularization parameter λ" protocol).
The products are plain ``torch.matmul``: the reference computes them
outside any Pallas kernel.  ``device=None`` means the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.common import resolve_device, set_full_f32_matmul

TASKS = ("linear", "logistic")


class LassoResult(NamedTuple):
    w: torch.Tensor          # (n,)
    support: torch.Tensor    # (n,) bool
    nnz: torch.Tensor        # () int32
    lam: torch.Tensor        # () f32


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _grad(w, X, y, task: str):
    if task == "linear":
        return X.T @ (X @ w - y)
    return X.T @ (torch.sigmoid(X @ w) - y)


def _lipschitz(X, task: str, iters: int = 30):
    """Power iteration for λmax(XᵀX); the logistic loss scales by 1/4."""
    n = X.shape[1]
    v = torch.ones((n,), dtype=X.dtype, device=X.device) / math.sqrt(n)
    for _ in range(iters):
        u = X.T @ (X @ v)
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    lmax = torch.dot(v, X.T @ (X @ v))
    return (lmax if task == "linear" else 0.25 * lmax) + 1e-6


def _inputs(X, y, device):
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_full_f32_matmul()
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    return X, y


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"task={task!r}; expected one of {TASKS}")


def fista(X, y, lam, w0=None, *, task: str = "linear", iters: int = 300,
          device=None) -> LassoResult:
    """min_w loss(w) + λ‖w‖₁ by FISTA.  X: (d, n), y: (d,).  No host
    sync."""
    _check_task(task)
    X, y = _inputs(X, y, device)
    n = X.shape[1]
    step = 1.0 / _lipschitz(X, task)
    lam = torch.as_tensor(lam, dtype=torch.float32).to(X.device)
    w = (torch.zeros((n,), device=X.device) if w0 is None
         else torch.as_tensor(w0, dtype=torch.float32).to(X.device))
    z, t = w, torch.ones((), device=X.device)
    for _ in range(iters):
        w_new = _soft(z - step * _grad(z, X, y, task), step * lam)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = w_new + ((t - 1.0) / t_new) * (w_new - w)
        w, t = w_new, t_new
    support = torch.abs(w) > 1e-8
    return LassoResult(w=w, support=support,
                       nnz=torch.sum(support.to(torch.int32)), lam=lam)


def _logspace(first: float, last: float, num: int) -> torch.Tensor:
    """``num`` f32 values from ``first`` to ``last``, evenly spaced in
    log10, by the reference's formula: start·(1 − s) + stop·s with
    s = i/(num − 1) in f32, the last point exactly stop."""
    lo, hi = torch.log10(torch.tensor([first, last], dtype=torch.float32))
    if num == 1:
        return torch.pow(10.0, lo.reshape(1))
    s = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    lin = torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])
    return torch.pow(10.0, lin)


def lasso_path_select(X, y, k: int, *, task: str = "linear",
                      n_lams: int = 20, iters: int = 300, device=None):
    """Warm-started λ path from λ_max down to 1e-4·λ_max, stopping once
    a support reaches 2k (one host sync per λ).  Returns the result whose
    support size is closest to k, and the whole path."""
    _check_task(task)
    X, y = _inputs(X, y, device)
    n = X.shape[1]
    w = torch.zeros((n,), device=X.device)
    lam_max = float(torch.max(torch.abs(_grad(w, X, y, task))))
    lams = _logspace(lam_max, lam_max * 1e-4, n_lams)
    results = []
    for lam in lams:
        res = fista(X, y, lam, w0=w, task=task, iters=iters, device=X.device)
        w = res.w
        results.append(res)
        if int(res.nnz) >= 2 * k:
            break
    best = min(results, key=lambda r: abs(int(r.nnz) - k))
    return best, results
