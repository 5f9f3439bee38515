"""Synthetic data of the paper's App. I.2 protocol, numpy only.

Copies of the D1 regression, D1 experimental-design and D3
classification generators of ``repro/data/synthetic.py``: the same seed
gives byte-identical arrays (the tests check it).  The other datasets
come with the slices that use them.
"""

from __future__ import annotations

import numpy as np


def _correlated_normal(rng, n_rows: int, n_cols: int, rho: float):
    """Columns ~ N(0,1) with pairwise correlation ≈ rho (one-factor)."""
    common = rng.normal(size=(n_rows, 1))
    eps = rng.normal(size=(n_rows, n_cols))
    x = np.sqrt(rho) * common + np.sqrt(1.0 - rho) * eps
    return x


def _normalize_cols(X):
    X = X - X.mean(axis=0, keepdims=True)
    X = X / np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-12)
    return X


def make_d1_regression(seed: int = 0, n_samples: int = 1000,
                       n_features: int = 500, support: int = 100,
                       rho: float = 0.4, noise: float = 0.1):
    """Paper D1: correlated features (cov 0.4), β ~ U(−2,2) on a random
    support, small additive noise.  Returns (X (d, n) f32 with unit,
    zero-mean columns, y (d,) f32, support indices)."""
    rng = np.random.default_rng(seed)
    X = _correlated_normal(rng, n_samples, n_features, rho)
    beta = np.zeros(n_features)
    sup = rng.choice(n_features, size=support, replace=False)
    beta[sup] = rng.uniform(-2, 2, size=support)
    y = X @ beta + noise * rng.normal(size=n_samples)
    return _normalize_cols(X).astype(np.float32), y.astype(np.float32), sup


def make_d1_design(seed: int = 0, n_samples: int = 1024,
                   n_features: int = 256, rho: float = 0.8):
    """Paper D1, experimental-design variant: correlated features (cov
    0.8), rows ℓ2-normalized.  Returns the (d = n_features, n = n_samples)
    f32 stimuli matrix whose *columns* are the candidate experiments."""
    rng = np.random.default_rng(seed)
    X = _correlated_normal(rng, n_samples, n_features, rho)
    X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    return X.T.astype(np.float32)


def make_d3_classification(seed: int = 2, n_samples: int = 1000,
                           n_features: int = 200, support: int = 50,
                           rho: float = 0.4):
    """Paper D3: correlated features (cov 0.4), β ~ U(−2,2) on a random
    support, y = 1[σ(Xβ) > 0.5].  Returns (X (d, n) f32 with zero-mean
    columns of norm √d, y (d,) f32 in {0, 1}, support indices)."""
    rng = np.random.default_rng(seed)
    X = _correlated_normal(rng, n_samples, n_features, rho)
    beta = np.zeros(n_features)
    sup = rng.choice(n_features, size=support, replace=False)
    beta[sup] = rng.uniform(-2, 2, size=support)
    p = 1.0 / (1.0 + np.exp(-(X @ beta)))
    y = (p > 0.5).astype(np.float32)
    Xs = _normalize_cols(X) * np.sqrt(n_samples)
    return Xs.astype(np.float32), y, sup
