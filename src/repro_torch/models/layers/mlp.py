"""Dense MLP: gated (SwiGLU/GeGLU) or plain.

A transliteration of ``repro/models/layers/mlp.py``.  GELU is the tanh
approximation, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.layers import normal
from repro_torch.sharding.tensor_parallel import model_group, partial_matmul


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_apply(params, x, cfg):
    """x (B, S, D) → (B, S, D).  Under tensor parallelism
    (``sharding/tensor_parallel.py``) the rank holds its columns of d_ff
    in ``w1``/``w3`` and its rows in ``w2``, and the partial products
    are summed over ``model`` in f32."""
    grp = model_group(cfg)
    if grp is not None and grp.layout.mlp:
        x = grp.enter(x)
    else:
        grp = None
    h = x @ params["w1"]
    if cfg.gated_mlp:
        h = _act(cfg.activation, h) * (x @ params["w3"])
    else:
        h = _act(cfg.activation, h)
    if grp is not None:
        return grp.reduce(partial_matmul(h, params["w2"]), h.dtype)
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
