"""Synthetic data of the paper's App. I.2 protocol, numpy only.

Copies of the D1 regression, D1 experimental-design, D2 clinical
surrogate, D3 classification and D4 gene surrogate generators of
``repro/data/synthetic.py``: the same seed gives byte-identical arrays
(the tests check it).  D2 and D4 are statistical surrogates of the
paper's third-party datasets, with their dimensions and correlation
structure; D4's label is binarized.  ``make_lm_tokens`` is the LM
substrate's Zipf token stream.
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


def make_d2_clinical(seed: int = 1, n_samples: int = 2000,
                     n_features: int = 385):
    """Surrogate of the clinical dataset (385 image-derived features):
    11 blocks of one-factor correlated features (cov 0.3 … 0.75), a
    sparse Gaussian β (about 15 % nonzero) and noise 0.5.  Returns
    (X (d, n) f32 with unit, zero-mean columns, y (d,) f32)."""
    rng = np.random.default_rng(seed)
    blocks = 11
    per = n_features // blocks + 1
    cols = []
    for b in range(blocks):
        rho = 0.3 + 0.5 * (b / blocks)
        cols.append(_correlated_normal(rng, n_samples, per, rho))
    X = np.concatenate(cols, axis=1)[:, :n_features]
    beta = rng.normal(size=n_features) * (rng.uniform(size=n_features) < 0.15)
    y = X @ beta + 0.5 * rng.normal(size=n_samples)
    return _normalize_cols(X).astype(np.float32), y.astype(np.float32)


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


def make_d4_gene(seed: int = 3, n_samples: int = 2000,
                 n_features: int = 2500, active_frac: float = 0.08):
    """Surrogate of the gene dataset: sparse binary presence/absence
    features, a binary label driven by 60 causal genes.  Returns (X
    (d, n) f32 standardized columns, y (d,) f32 in {0, 1}, the causal
    indices)."""
    rng = np.random.default_rng(seed)
    X = (rng.uniform(size=(n_samples, n_features)) < active_frac).astype(
        np.float32)
    causal = rng.choice(n_features, size=60, replace=False)
    w = rng.uniform(1.0, 3.0, size=60) * rng.choice([-1, 1], size=60)
    logits = X[:, causal] @ w - (X[:, causal] @ w).mean()
    y = (logits > 0).astype(np.float32)
    Xs = X - X.mean(axis=0, keepdims=True)
    Xs = Xs / np.maximum(Xs.std(axis=0, keepdims=True), 1e-6)
    return Xs.astype(np.float32), y, causal


def make_lm_tokens(seed: int, n_tokens: int, vocab_size: int,
                   zipf_a: float = 1.2):
    """Zipf-distributed synthetic token stream (int32, ranks mod the
    vocabulary) for the LM substrate."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=n_tokens)
    return (ranks % vocab_size).astype(np.int32)
