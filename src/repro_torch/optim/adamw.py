"""AdamW with an f32 master copy of the parameters.

A port of the single-device half of ``repro/optim/adamw.py``.  State per
parameter leaf: f32 master, f32 m, f32 v, and one step count; the new
parameters are the master cast to ``param_dtype``.  The reference's
formula and weight decay apply to every leaf.  Plain tensor functions
over the parameter tree, not ``torch.optim``: the state is a tree of
tensors that ``repro_torch.ckpt`` saves and restores as it is.  The
state is replicated on every rank of a data-parallel mesh, as in the
reference's training, unless the train step runs ZeRO-1
(``train.step.make_train_step(..., grad_specs=)``): there each rank's
master, m and v hold its part of every leaf, the update is elementwise,
and the global gradient norm is given (``gnorm``), summed from the
parts over the mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    master: Any          # f32 params
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Step 0, an f32 copy of ``params`` and zero moments (f32 params
    are copied too, so the master never aliases them)."""
    f32 = lambda x: x.detach().to(torch.float32, copy=True)
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree_map(f32, params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(grads) -> torch.Tensor:
    """√(Σ ‖g‖²) over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """(grads · min(1, max_norm / max(‖g‖, 1e-9)) in f32, ‖g‖); ``gn``,
    where given, is ‖g‖ (of a tree of which ``grads`` is a part)."""
    if gn is None:
        gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def adamw_update(grads, state: AdamWState, lr, tcfg,
                 param_dtype=torch.bfloat16, gnorm=None):
    """One AdamW step.  Returns (new params in ``param_dtype``, new
    state, {"grad_norm"}).  ``lr``: a scalar tensor (the schedule's) or
    a float; ``tcfg``: a ``TrainConfig`` (beta1, beta2, weight_decay,
    grad_clip); ``gnorm``: the global gradient norm, where ``grads`` and
    the state are a rank's parts (ZeRO-1), else taken from ``grads``."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, gnorm)
    step = state.step + 1
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    new_m, new_v, new_p = [], [], []
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state.m),
                            tree_leaves(state.v), tree_leaves(state.master)):
        mu = b1 * mu + (1.0 - b1) * g
        nu = b2 * nu + (1.0 - b2) * g * g
        mhat = mu / c1
        nhat = nu / c2
        p = p - lr * (mhat / (torch.sqrt(nhat) + 1e-8)
                      + tcfg.weight_decay * p)
        new_m.append(mu)
        new_v.append(nu)
        new_p.append(p)
    master = tree_unflatten(state.master, new_p)
    new_state = AdamWState(step=step, master=master,
                           m=tree_unflatten(state.m, new_m),
                           v=tree_unflatten(state.v, new_v))
    params = tree_map(lambda p: p.to(param_dtype), master)
    return params, new_state, {"grad_norm": gnorm}
