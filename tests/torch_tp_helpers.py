"""Rank functions and shared pieces of the port's tensor-parallel files
(``tests/test_torch_tp_*.py``).

Spawned ranks import the module that holds their function by name, so
these live here, with JAX out of the top level.  The reduced configs
below reach every branch of ``sharding/tensor_parallel.py`` on a
``model`` axis of 2:

  * ``smollm``: 3 heads over 1 KV head, which 2 does not divide: the
    contracting path, and a linear cache split by slots;
  * ``danube``: 4 heads over 2 KV heads: the head path, the KV cache
    split by heads, its sliding-window ring;
  * ``danube_slots``: danube's ring at 3 over 1 heads: the contracting
    path and a ring split by slots;
  * ``qwen``: the head path with the q, k, v biases;
  * ``llama4``: 4 experts over ``model`` (expert parallel);
  * ``grok_dff``: 3 experts, which 2 does not divide: d_ff inside every
    expert;
  * ``odd_vocab``: a vocabulary of 255 rows (no padding): the embedding
    and the head replicated;
  * ``smollm_whole_cache``: ``smollm`` served from an odd prompt, whose
    linear cache (prompt + 64 slots) 2 does not divide: the cache whole
    on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AXES = ("data", "model")

CASES = {
    "smollm": ("smollm-135m", {"attn": dict(n_heads=3, n_kv_heads=1)}),
    "danube": ("h2o-danube-1.8b", {}),
    "danube_slots": ("h2o-danube-1.8b", {"attn": dict(n_heads=3,
                                                       n_kv_heads=1)}),
    "qwen": ("qwen2.5-14b", {}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
    "grok_dff": ("grok-1-314b", {"moe": dict(n_experts=3)}),
    "odd_vocab": ("smollm-135m", {"top": dict(vocab_size=255,
                                              vocab_pad_multiple=1)}),
    "smollm_whole_cache": ("smollm-135m", {"attn": dict(n_heads=3,
                                                         n_kv_heads=1)}),
}


def config(name: str, reduced):
    """The case's config from ``reduced`` (the port's or the reference's
    ``get_reduced_config``): the same overrides on either package's
    dataclasses."""
    arch, over = CASES[name]
    cfg = reduced(arch, **over.get("top", {}))
    kw = {}
    for field in ("attn", "moe"):
        if field in over:
            kw[field] = dataclasses.replace(getattr(cfg, field),
                                            **over[field])
    return dataclasses.replace(cfg, **kw) if kw else cfg


def port_config(name: str):
    from repro_torch.configs import get_reduced_config

    return config(name, get_reduced_config)


def tp_mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, AXES, device="cpu")


def tp_context(mesh):
    from repro_torch.sharding import activation_sharding_ctx

    return activation_sharding_ctx(("data",), mesh=mesh,
                                   tensor_parallel=True)


def local_params(name, params_np, mesh):
    """(model, this rank's shards of the case's numpy weights, the
    placements)."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.sharding.tensor_parallel import shard_params
    from repro_torch.train.step import tp_param_specs

    cfg = port_config(name)
    model = build_model(cfg)
    specs = tp_param_specs(model, mesh)
    whole = model_params_from_numpy(cfg, params_np, "cpu")
    return model, shard_params(whole, specs, mesh), specs


def loss_rank(shape, names, params_np, batches):
    """Per case: this rank's loss, metrics and gradient shards on its
    rows (``shard_batch``) under the tensor-parallel context of a mesh
    of ``shape``, the loss, metrics and gradients summed over the batch
    axes (the train step's order); and the rank's ``model`` coordinate
    and layout."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.sharding.tensor_parallel import model_group
    from repro_torch.train.step import all_reduce_buckets, loss_and_grads
    from repro_torch.tree import tree_leaves, tree_unflatten

    mesh = tp_mesh(shape)
    out = {}
    for name in names:
        model, local, _ = local_params(name, params_np[name], mesh)
        rows = shard_batch({k: torch.from_numpy(v)
                            for k, v in batches[name].items()}, mesh)
        with tp_context(mesh):
            loss, met, grads = loss_and_grads(model, local, rows)
            layout = model_group(model.cfg).layout
        vals = mesh.psum(torch.stack([loss, met["lm_loss"],
                                      met["aux_loss"]]), "data")
        leaves = all_reduce_buckets([g.to(torch.float32)
                                     for g in tree_leaves(grads)],
                                    mesh, ("data",))
        out[name] = {"loss": vals.tolist(),
                     "grads": tree_unflatten(grads, leaves),
                     "index": mesh.index("model"),
                     "layout": dataclasses.asdict(layout)}
    return out


def faulty_loss_rank(pnp, batch):
    """``loss_rank`` of danube at (1, 2) with a planted fault: the entry
    to the split weights passes its gradient through without the sum
    over ``model``."""
    from repro_torch.sharding import tensor_parallel as tp

    tp.ModelGroup.enter = lambda self, x: x
    return loss_rank((1, 2), ["danube"], {"danube": pnp},
                     {"danube": batch})["danube"]


def serve_rank(shape, names, params_np, tokens, steps, fault=None):
    """Per case: greedy tokens of a prefill and ``steps`` − 1 decode
    steps on this rank's rows under the tensor-parallel context, with
    the whole logits of each step, and the type name and shapes of layer
    0's cache after the prefill.  ``fault`` names a case served once
    more, last, under ``plant_merge_fault`` (its result under
    ``"fault"``)."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.lm_serve import sample_token

    mesh = tp_mesh(shape)
    out = {}
    for name in names:
        model, local, _ = local_params(name, params_np[name], mesh)
        rows = shard_batch({"tokens": torch.from_numpy(tokens[name])}, mesh)
        logits_all, toks = [], []
        with tp_context(mesh), torch.no_grad():
            logits, cache = model.prefill(local, rows)
            c0 = cache["layers"][0]
            kind = (type(c0).__name__, tuple(c0.k.shape),
                    tuple(c0.positions.shape))
            pos0 = cache["step_offset"]
            tok = sample_token(logits, None)
            for i in range(steps):
                logits_all.append(logits)
                toks.append(tok)
                if i == steps - 1:
                    break
                logits, cache = model.decode_step(local, cache, tok[:, None],
                                                  pos0 + i)
                tok = sample_token(logits, None)
        out[name] = {"tokens": torch.stack(toks, 1),
                     "logits": torch.stack(logits_all, 1), "cache": kind}
    if fault is not None:
        plant_merge_fault()
        out["fault"] = serve_rank(shape, [fault], params_np, tokens,
                                  steps)[fault]
    return out


def plant_merge_fault():
    """The decode's merge of the ranks' slots rescaling each rank's part
    by its own maxima, not by their maximum."""
    from repro_torch.models.layers import attention

    def merge(m, l, acc, grp):
        return grp.psum(acc) / grp.psum(l)[..., None]

    attention.merge_partials = merge


def slice_shard(tree, specs, size: int, index: int):
    """The ``index``-th of ``size`` shards of a tree of whole leaves by
    the placements' ``model`` entries (``shard_params`` without a
    mesh)."""
    from repro_torch.sharding.tensor_parallel import tree_map_shards

    return tree_map_shards(tree, specs, size, index)


def step_rank(shape, cases, states, batches_np, steps):
    """Per case (name, tcfg kwargs, zero1): ``steps`` tensor-parallel
    train steps (``make_train_step(mesh=, tensor_parallel=True)``, with
    ``grad_specs=zero1_specs(...)`` where ``zero1``) on a mesh of
    ``shape`` from the reference's initial state (numpy, plain dicts)
    on this rank's rows.  Returns the metrics of every step, the state
    gathered whole after every step (rank 0 only) and the parameter
    bytes the rank holds with their share under the placements."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.models import build_model
    from repro_torch.sharding import batch_axes_for_mesh, zero1_specs
    from repro_torch.train.step import (
        gather_train_state,
        make_train_step,
        shard_train_state,
        tp_param_specs,
    )
    from repro_torch.utils.tree import tree_bytes
    from torch_train_helpers import port_state

    mesh = tp_mesh(shape)
    axes = batch_axes_for_mesh(mesh)
    out = {}
    for name, kw, zero1 in cases:
        cfg = port_config(name)
        model = build_model(cfg)
        tcfg = TrainConfig(**kw)
        state = port_state(cfg, states[name])
        pspecs = tp_param_specs(model, mesh)
        gspecs = (zero1_specs(pspecs, state.params, mesh, axes, cfg)
                  if zero1 else None)
        st = shard_train_state(state, mesh, gspecs, cfg, param_specs=pspecs)
        held = tree_bytes(st.params)
        share = placed_bytes(state.params, pspecs, mesh)
        step = make_train_step(model, tcfg, mesh=mesh, grad_specs=gspecs,
                               tensor_parallel=True)
        mets, gathered = [], []
        for b in batches_np[name][:steps]:
            local = shard_batch({k: torch.from_numpy(v)
                                 for k, v in b.items()}, mesh)
            st, m = step(st, local)
            mets.append({k: float(v) for k, v in m.items()})
            g = gather_train_state(st, mesh, gspecs, cfg,
                                   param_specs=pspecs)
            gathered.append(g if mesh.rank == 0 else None)
        out[f"{name}/{'zero1' if zero1 else 'rep'}"] = {
            "metrics": mets, "gathered": gathered, "held": held,
            "share": share}
    return out


def padded_tokens(cfg, b: int, s: int, seed: int = 3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)



def fed_step_rank(shape, arch, kw, runs, zero1, fault=None):
    """Compressed steps on a mesh of ``shape`` whose gradients are fed,
    not taken, for each (scheme, initial state, fed gradients) of
    ``runs``: step i's are the fed ``[i]`` (the reference's whole
    gradients, numpy trees in the port's per-layer layout) — on the rank
    at batch coordinate 0 its ``model`` shard of them, zeros on the
    others, so that their sum over the batch axes is the fed gradient
    exactly.  ``kw``: a ``TrainConfig``'s; ZeRO-1 where ``zero1``; tensor
    parallel where ``model`` holds several ranks.  Returns per scheme
    the state gathered whole after every step (rank 0 only) and the
    metrics; ``fault`` names a scheme run once more, last, with each
    part's threshold or scale from its own entries alone (under
    ``"fault"``)."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.optim import compression
    from repro_torch.sharding import batch_axes_for_mesh, zero1_specs
    from repro_torch.sharding.tensor_parallel import shard_params
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import (
        gather_train_state,
        make_train_step,
        shard_train_state,
        tp_param_specs,
    )
    from repro_torch.tree import tree_map
    from torch_train_helpers import port_state

    mesh = tp_mesh(shape)
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    tp = mesh.size("model") > 1
    pspecs = tp_param_specs(model, mesh)
    first = mesh.index("data") == 0
    zero = torch.zeros(())

    def run(scheme, state_np, fed):
        state = port_state(cfg, state_np)
        gspecs = (zero1_specs(pspecs, state.params, mesh,
                              batch_axes_for_mesh(mesh), cfg)
                  if zero1 else None)
        st = shard_train_state(state, mesh, gspecs, cfg,
                               param_specs=pspecs if tp else None)
        step = make_train_step(
            model, TrainConfig(**kw, grad_compression=scheme), mesh=mesh,
            grad_specs=gspecs, tensor_parallel=tp)
        out = {"gathered": [], "metrics": []}
        for g_np in fed:
            g = tree_map(torch.from_numpy, g_np)
            if tp:
                g = shard_params(g, pspecs, mesh)
            if not first:
                g = tree_map(torch.zeros_like, g)
            fixed = (zero, {"lm_loss": zero, "aux_loss": zero}, g)
            step_mod.loss_and_grads = lambda *a, fixed=fixed: fixed
            st, m = step(st, {"tokens": torch.zeros((1, 2),
                                                    dtype=torch.int32)})
            out["metrics"].append({k: float(v) for k, v in m.items()})
            w = gather_train_state(st, mesh, gspecs, cfg,
                                   param_specs=pspecs if tp else None)
            out["gathered"].append(w if mesh.rank == 0 else None)
        return out

    res = {scheme: run(scheme, init, fed) for scheme, init, fed in runs}
    if fault is not None:
        compression.Holders.all_gather = lambda self, x: x
        compression.Holders.pmax = lambda self, x: x
        res["fault"] = run(*next(r for r in runs if r[0] == fault))
    return res
