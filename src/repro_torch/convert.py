"""Carry objectives and states across from numpy.

The parity tests start the JAX reference and the port from the same
state: they export the reference's objective inputs and state fields as
numpy arrays and rebuild them here.  A state without a leading lane axis
becomes a one-lane state; with one (regression: Q (G, d, k), count (G,),
resid (G, d), sel_mask (G, n), value (G,); A-optimality: M, L (G, d, d),
W (G, d, n), sel_mask (G, n), value (G,); classification: sel_idx,
sel_k, w (G, kcap), eta (G, d), sel_mask (G, n), value (G,)) it becomes
a G-lane state.

``model_params_from_numpy`` carries an LM's parameters across: the
reference's pytree (``embed``, ``lm_head``, ``final_norm``, ``blocks``,
one subtree per pattern position stacked over super-blocks, and where
the arch has them ``img_proj``, ``enc_blocks`` stacked over encoder
layers and ``enc_final_norm``) as numpy arrays becomes the port's dict
with one entry per layer in ``layers`` (and in ``enc_layers``).
``train_state_from_numpy`` does the same for the reference's whole
``TrainState``: the parameters, AdamW's step, f32 master, m and v, and
the compression's error feedback.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.objectives.a_optimal import (
    AOptimalityObjective,
    AOptState,
)
from repro_torch.core.objectives.classification import (
    ClassificationObjective,
    ClassificationState,
)
from repro_torch.core.objectives.regression import (
    RegressionObjective,
    RegressionState,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.models.transformer import check_supported, dtype_of


def objective_from_numpy(X, y, kmax: int, *, span_tol: float = 1e-6,
                         jitter: float = 1e-8, precision: str | None = None,
                         device=None) -> RegressionObjective:
    """The port's objective over the numpy X (d, n) and y (d,)."""
    return RegressionObjective(np.array(X, np.float32),
                               np.array(y, np.float32), kmax,
                               span_tol=span_tol, jitter=jitter,
                               precision=precision, device=device)


def _lane_fields(lanes: bool, device):
    """A converter of one numpy field to a tensor on ``device`` whose
    leading lane axis is added (of size 1) unless ``lanes``."""
    dev = resolve_device(device)

    def t(x, dtype, nd):
        x = torch.as_tensor(np.array(x, copy=True)).to(dtype=dtype, device=dev)
        return x if lanes else x.reshape((1,) + tuple(x.shape[:nd]))

    return t


def state_from_numpy(Q, count, resid, sel_mask, value, *,
                     device=None) -> RegressionState:
    """The port's RegressionState from numpy fields (lane axis optional)."""
    t = _lane_fields(np.ndim(Q) == 3, device)
    return RegressionState(
        Q=t(Q, torch.float32, 2),
        count=t(count, torch.int32, 0),
        resid=t(resid, torch.float32, 1),
        sel_mask=t(sel_mask, torch.bool, 1),
        value=t(value, torch.float32, 0),
    )


def aopt_objective_from_numpy(X, kmax: int, *, beta2: float = 1.0,
                              sigma2: float = 1.0,
                              precision: str | None = None,
                              device=None) -> AOptimalityObjective:
    """The port's A-optimality objective over the numpy X (d, n)."""
    return AOptimalityObjective(np.array(X, np.float32), kmax, beta2=beta2,
                                sigma2=sigma2, precision=precision,
                                device=device)


def aopt_state_from_numpy(M, L, W, sel_mask, value, *,
                          device=None) -> AOptState:
    """The port's AOptState from numpy fields (lane axis optional)."""
    t = _lane_fields(np.ndim(M) == 3, device)
    return AOptState(
        M=t(M, torch.float32, 2),
        L=t(L, torch.float32, 2),
        W=t(W, torch.float32, 2),
        sel_mask=t(sel_mask, torch.bool, 1),
        value=t(value, torch.float32, 0),
    )


def classification_objective_from_numpy(
        X, y, kmax: int, *, newton_steps: int = 6,
        newton_gain_steps: int = 3, gain_mode: str = "newton1d",
        ridge: float = 1e-4, gain_eps: float = 1e-9,
        precision: str | None = None,
        device=None) -> ClassificationObjective:
    """The port's classification objective over the numpy X (d, n) and
    labels y (d,)."""
    return ClassificationObjective(
        np.array(X, np.float32), np.array(y, np.float32), kmax,
        newton_steps=newton_steps, newton_gain_steps=newton_gain_steps,
        gain_mode=gain_mode, ridge=ridge, gain_eps=gain_eps,
        precision=precision, device=device)


def classification_state_from_numpy(sel_idx, sel_k, w, eta, sel_mask, value,
                                    *, device=None) -> ClassificationState:
    """The port's ClassificationState from numpy fields (lane axis
    optional)."""
    t = _lane_fields(np.ndim(eta) == 2, device)
    return ClassificationState(
        sel_idx=t(sel_idx, torch.int64, 1),
        sel_k=t(sel_k, torch.bool, 1),
        w=t(w, torch.float32, 1),
        eta=t(eta, torch.float32, 1),
        sel_mask=t(sel_mask, torch.bool, 1),
        value=t(value, torch.float32, 0),
    )


def model_params_from_numpy(cfg, params_np, device=None) -> dict:
    """The port's LM parameters from the reference's pytree of numpy
    arrays: ``blocks[j]`` holds pattern position j, each leaf with a
    leading super-block axis; layer i is ``blocks[i % period]`` at
    super-block ``i // period``.  The encoder's ``enc_blocks`` (one tree
    stacked over its layers) becomes the list ``enc_layers``; every other
    leaf (``embed``, ``lm_head``, the final norms, ``img_proj``) is
    carried over as it is.  Every leaf goes to ``device`` in
    ``cfg.param_dtype``."""
    return _split_params(cfg, params_np, dtype_of(cfg.param_dtype),
                         resolve_device(device))


def _split_params(cfg, params_np, dtype, dev) -> dict:
    """``model_params_from_numpy`` for a tree of the parameters'
    structure, every leaf in ``dtype`` on ``dev``."""
    check_supported(cfg)

    def tree(x, pick=None):
        if isinstance(x, dict):
            return {k: tree(v, pick) for k, v in x.items()}
        a = np.asarray(x).astype(np.float32)
        a = a[pick] if pick is not None else a
        return torch.from_numpy(np.array(a, copy=True)).to(dtype=dtype,
                                                            device=dev)

    blocks = params_np["blocks"]
    period = cfg.pattern_period
    if len(blocks) != period:
        raise ValueError(f"{cfg.name}: {len(blocks)} pattern positions in "
                         f"blocks, the config's pattern has {period}")
    out = {k: tree(v) for k, v in params_np.items()
           if k not in ("blocks", "enc_blocks")}
    out["layers"] = [tree(blocks[i % period], i // period)
                     for i in range(cfg.n_layers)]
    if "enc_blocks" in params_np:
        out["enc_layers"] = [tree(params_np["enc_blocks"], i)
                             for i in range(cfg.encoder.n_layers)]
    return out


def train_state_from_numpy(cfg, state_np, device=None):
    """The port's ``TrainState`` from the reference's, as numpy arrays:
    any object with ``params``, ``opt`` (``step``, ``master``, ``m``,
    ``v``) and ``error_fb`` (an empty tuple, or a tree of the
    parameters' structure).  The parameters come in ``cfg.param_dtype``,
    everything else in f32 (the step in int32); every tree stacked over
    super-blocks is split per layer, as ``model_params_from_numpy``
    does."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    dev = resolve_device(device)
    f32 = lambda t: _split_params(cfg, t, torch.float32, dev)
    opt = state_np.opt
    ef = state_np.error_fb
    return TrainState(
        params=_split_params(cfg, state_np.params,
                             dtype_of(cfg.param_dtype), dev),
        opt=AdamWState(
            step=torch.tensor(np.asarray(opt.step, np.int32)).to(dev),
            master=f32(opt.master), m=f32(opt.m), v=f32(opt.v)),
        error_fb=f32(ef) if isinstance(ef, dict) else ())
