"""Sampling and expectation estimators for adaptive sampling, by lane.

Ports ``repro/core/estimators.py``.  Where the JAX reference vmaps over
guess lanes, these functions take one key per lane (a list) and a mask
with a leading lane axis.  Every draw goes through the key interface of
``core.random`` — no global RNG — so a test can feed the reference's
noise.
"""

from __future__ import annotations

import torch


def gumbel_noise(key, n: int, device) -> torch.Tensor:
    """(n,) i.i.d. Gumbel noise — the one noise layout every Gumbel-top-k
    sampler draws from."""
    return key.gumbel(n, device)


def top_k(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, ties broken by the lower index (as
    ``jax.lax.top_k``): a stable descending sort.  ``torch.topk`` on
    CUDA promises no order among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_set_from_mask(keys, mask: torch.Tensor, m: int):
    """Per lane, uniformly sample ≤ m distinct elements of the alive mask.

    keys: one key per lane; mask: (G, n) bool.  Gumbel-top-k restricted to
    the alive entries (−inf elsewhere).  Returns (idx, valid): int64
    (G, m) indices and bool (G, m) slot validity (invalid slots occur when
    fewer than m elements are alive).
    """
    n = mask.shape[-1]
    noise = torch.stack([gumbel_noise(k, n, mask.device) for k in keys])
    scores = torch.where(mask, noise, torch.full_like(noise, -torch.inf))
    vals, idx = top_k(scores, m)
    return idx, torch.isfinite(vals)


def sample_set_batch(keys, mask: torch.Tensor, m: int, n_samples: int):
    """(G, n_samples, m) independent uniform set samples per lane: lane g
    splits its key into ``n_samples`` sample keys."""
    subkeys = [k.split(n_samples) for k in keys]
    per_sample = [sample_set_from_mask([ks[s] for ks in subkeys], mask, m)
                  for s in range(n_samples)]
    idx = torch.stack([p[0] for p in per_sample], dim=1)
    valid = torch.stack([p[1] for p in per_sample], dim=1)
    return idx, valid


def trimmed_mean(vals: torch.Tensor, trim_frac: float = 0.0, dim: int = 0):
    """Symmetric trimmed mean along ``dim`` (static trim count); 0 is the
    plain mean."""
    m = vals.shape[dim]
    t = int(m * trim_frac)
    if t == 0:
        return torch.mean(vals, dim=dim)
    svals = torch.sort(vals, dim=dim).values
    return torch.mean(svals.narrow(dim, t, m - 2 * t), dim=dim)


def masked_argmax(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """argmax of ``values`` restricted to ``mask`` along the last axis
    (the first index among equal maxima)."""
    neg = torch.finfo(values.dtype).min
    return torch.argmax(torch.where(mask, values, torch.full_like(values, neg)),
                        dim=-1)
