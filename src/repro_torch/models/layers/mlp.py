"""Dense MLP: gated (SwiGLU/GeGLU) or plain.

A transliteration of ``repro/models/layers/mlp.py``.  GELU is the tanh
approximation, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.layers import normal


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_apply(params, x, cfg):
    h = x @ params["w1"]
    if cfg.gated_mlp:
        h = _act(cfg.activation, h) * (x @ params["w3"])
    else:
        h = _act(cfg.activation, h)
    return h @ params["w2"]


def init_mlp(gen, cfg, dtype):
    """Random weights with the JAX init's shapes and scales, drawn from
    the ``torch.Generator`` ``gen`` on its device."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": normal(gen, (d, f), d ** -0.5, dtype),
         "w2": normal(gen, (f, d), f ** -0.5, dtype)}
    if cfg.gated_mlp:
        p["w3"] = normal(gen, (d, f), d ** -0.5, dtype)
    return p
