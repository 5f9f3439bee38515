"""Rank functions and shared pieces of the port's sharded-training files
(``tests/test_torch_moe_groups.py``, ``test_torch_train_sharded.py``,
``test_torch_train_loop_sharded.py``, ``test_torch_train_zero1.py``).

Spawned ranks import the module that holds their function by name, so
these live here, with JAX out of the top level (``JaxKey`` imports it in
its methods).  The reference's states reach the ranks as plain numpy
trees (dicts, lists and tuples; no class of the JAX package).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import threading
import types

import numpy as np

from torch_dist_helpers import JaxKey

AXES = ("data", "model")


def plain_state(state) -> dict:
    """A reference ``TrainState`` (of numpy leaves) as plain dicts."""
    opt = state.opt
    return {"params": state.params,
            "opt": {"step": opt.step, "master": opt.master, "m": opt.m,
                    "v": opt.v},
            "error_fb": state.error_fb}


def port_state(cfg, plain: dict):
    """The port's ``TrainState`` on the CPU from ``plain_state``'s
    tree."""
    from repro_torch.convert import train_state_from_numpy

    ns = types.SimpleNamespace(
        params=plain["params"], opt=types.SimpleNamespace(**plain["opt"]),
        error_fb=plain["error_fb"])
    return train_state_from_numpy(cfg, ns, "cpu")


def batches(vocab: int, n: int, b: int = 8, s: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


@contextlib.contextmanager
def port_flags(**kw):
    from repro_torch.sharding import reset_flags, set_flags

    set_flags(**kw)
    try:
        yield
    finally:
        reset_flags()


def state_digest(state) -> tuple:
    """A host digest of a state's bits (every rank must hold the same)."""
    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(state):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the MoE layer on a mesh
# ---------------------------------------------------------------------------

def moe_rank(cases, params_np, x_np, w_np):
    """Each case (arch, moe_groups, fault): this rank's rows of x through
    ``moe_apply`` under the data-parallel context of a (2, 2) mesh; the
    gradient of Σ(out · w) over its rows plus its share of the aux loss
    with respect to the layer's weights and its rows.  ``fault``
    "alone" dispatches as if the rank's rows were the whole batch (the
    other ranks' counts left out)."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.sharding import activation_sharding_ctx

    mesh = make_mesh((2, 2), AXES, device="cpu")
    r, size = mesh.index("data"), mesh.size("data")
    out = {}
    for arch, groups, fault in cases:
        cfg = get_reduced_config(arch)
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in params_np[arch].items()}
        rows = x_np[arch].shape[0] // size
        x = torch.from_numpy(x_np[arch][r * rows:(r + 1) * rows].copy())
        x.requires_grad_(True)
        w = torch.from_numpy(w_np[arch][r * rows:(r + 1) * rows].copy())
        dispatch = tmoe._dispatch_group
        if fault == "alone":
            tmoe._dispatch_group = (lambda *a, **kw: dispatch(*a[:5]))
        try:
            with port_flags(moe_groups=groups), \
                    activation_sharding_ctx(("data",), mesh=mesh):
                y, aux = tmoe.moe_apply(p, x, cfg)
                loss = torch.sum(y * w) + aux / size
                grads = torch.autograd.grad(loss, list(p.values()) + [x])
        finally:
            tmoe._dispatch_group = dispatch
        out[arch, groups, fault] = {
            "out": y.detach().numpy(), "aux": float(aux),
            "grads": {k: g.numpy() for k, g in zip(p, grads)},
            "x_grad": grads[-1].numpy()}
    return out


# ---------------------------------------------------------------------------
# the train step on a mesh
# ---------------------------------------------------------------------------

def step_rank(cases, states, steps):
    """Each case (name, arch, tcfg kwargs, moe_groups, fault): ``steps``
    steps of ``make_train_step(mesh=)`` on a (2, 2) mesh from the
    reference's initial state, on ``batches(...)``'s global batches cut
    by ``shard_batch``.  Returns per case the metrics of every step, the
    state after every step (rank 0 only) and a digest of the last state
    (every rank).  ``fault`` "drop" sums only the first data rank's
    gradient."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod

    mesh = make_mesh((2, 2), AXES, device="cpu")
    out = {}
    for name, arch, kw, groups, fault in cases:
        cfg = get_reduced_config(arch)
        tcfg = TrainConfig(**kw)
        state = port_state(cfg, states[arch])
        reduce = step_mod.all_reduce_buckets
        if fault == "drop":
            step_mod.all_reduce_buckets = lambda leaves, m, axes: reduce(
                [g * float(m.index(axes) == 0) for g in leaves], m, axes)
        try:
            with port_flags(moe_groups=groups):
                step = step_mod.make_train_step(build_model(cfg), tcfg,
                                                mesh=mesh)
                mets, kept = [], []
                for batch in batches(cfg.vocab_size, steps):
                    local = shard_batch(batch, mesh,
                                        microbatches=tcfg.microbatches)
                    state, m = step(state, local)
                    mets.append({k: float(v) for k, v in m.items()})
                    kept.append(state if mesh.rank == 0 else None)
        finally:
            step_mod.all_reduce_buckets = reduce
        out[name] = {"metrics": mets, "states": kept,
                     "digest": state_digest(state),
                     "allreduce_calls": len(step.allreduce_seconds)}
    return out


def zero1_rank(cases, states, steps):
    """Each case (name, arch, tcfg kwargs, moe_groups, fault): ``steps``
    ZeRO-1 steps (``make_train_step(mesh=, grad_specs=zero1_specs(...))``)
    on a (world, 1) mesh from the reference's initial state, beside the
    replicated data-parallel step from the same state on the same rows.
    Returns per case the ZeRO-1 metrics of every step, after every step
    the gathered ZeRO-1 state and the replicated step's state (rank 0
    only), the optimizer bytes this rank holds and its share under the
    placements (f32 master, m and v: three times the master's placed
    bytes, ``launch.dryrun.placed_bytes``), and every rank's reduce-
    scatter and all-gather call counts."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.dryrun import _zero1_stack, placed_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import (
        batch_axes_for_mesh,
        param_partition_specs,
        zero1_layout,
        zero1_specs,
    )
    from repro_torch.train.step import (
        gather_train_state,
        make_train_step,
        shard_train_state,
    )
    from repro_torch.utils.tree import tree_bytes

    mesh = make_mesh((dist.get_world_size(), 1), AXES, device="cpu")
    axes = batch_axes_for_mesh(mesh)
    out = {}
    for name, arch, kw, groups, _ in cases:
        cfg = get_reduced_config(arch)
        tcfg = TrainConfig(**kw)
        model = build_model(cfg)
        state = port_state(cfg, states[arch])
        specs = zero1_specs(param_partition_specs(state.params, cfg, mesh),
                            state.params, mesh, axes, cfg)
        layout = zero1_layout(specs, state.params, mesh, axes, cfg)
        share = 3 * placed_bytes(state.opt.master, specs, mesh,
                                 _zero1_stack(layout, mesh))
        z = shard_train_state(state, mesh, specs, cfg)
        held = tree_bytes((z.opt.master, z.opt.m, z.opt.v))
        with port_flags(moe_groups=groups):
            zstep = make_train_step(model, tcfg, mesh=mesh, grad_specs=specs)
            rstep = make_train_step(model, tcfg, mesh=mesh)
            mets, gathered, replicated = [], [], []
            r = state
            for batch in batches(cfg.vocab_size, steps):
                local = shard_batch(batch, mesh,
                                    microbatches=tcfg.microbatches)
                z, m = zstep(z, local)
                r, _ = rstep(r, local)
                mets.append({k: float(v) for k, v in m.items()})
                g = gather_train_state(z, mesh, specs, cfg)
                gathered.append(g if mesh.rank == 0 else None)
                replicated.append(r if mesh.rank == 0 else None)
        out[name] = {"metrics": mets, "gathered": gathered,
                     "replicated": replicated, "held": held, "share": share,
                     "calls": (len(zstep.reduce_scatter_seconds),
                               len(zstep.all_gather_seconds))}
    return out


# The reference's initial states (to ``path`` + ".init") and its steps of
# each case on make_mesh((2, 2)) under activation_sharding_ctx (to
# ``path``), run by ``torch_dist_helpers.start_reference`` on forced host
# devices.
STEP_REFERENCE = """
import os
import pickle
import torch_train_helpers as T
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import TrainConfig, get_reduced_config
from repro.models import build_model
from repro.sharding import activation_sharding_ctx
from repro.sharding.flags import reset_flags, set_flags
from repro.train.step import init_train_state, make_train_step

mesh = make_mesh((2, 2), ("data", "model"))
init = {{}}
for arch in {archs!r}:
    st = init_train_state(build_model(get_reduced_config(arch)),
                          jax.random.PRNGKey(0), TrainConfig(**{kw!r}))
    init[arch] = T.plain_state(jax.tree_util.tree_map(np.asarray, st))
with open({path!r} + ".tmp", "wb") as f:
    pickle.dump(init, f)
os.replace({path!r} + ".tmp", {path!r} + ".init")
out = {{}}
for name, arch, kw, groups, _ in {cases!r}:
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    tcfg = TrainConfig(**kw)
    set_flags(moe_groups=groups)
    state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
    mets, states = [], []
    with mesh, activation_sharding_ctx(("data",), model_size=2):
        step = jax.jit(make_train_step(model, tcfg))
        for b in T.batches(cfg.vocab_size, {steps}):
            b = jax.device_put({{k: jnp.asarray(v) for k, v in b.items()}},
                               NamedSharding(mesh, P("data", None)))
            state, m = step(state, b)
            mets.append({{k: float(v) for k, v in m.items()}})
            states.append(T.plain_state(jax.tree_util.tree_map(
                np.asarray, state)))
    runs = {{"metrics": mets, "states": states}}
    reset_flags()
    out[name] = runs
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print(json.dumps({{"ok": True}}))
"""


def run_step_cases(cases, steps, kw, path):
    """The port's ``step_rank`` on four gloo ranks beside the reference's
    ``STEP_REFERENCE`` subprocess: the subprocess writes the reference's
    initial states (``path`` + ".init") first, the ranks start from them
    while it runs its steps (pickled to ``path``).  Returns (per-rank
    results, the reference's runs by case)."""
    import pickle
    import time

    import torch_dist_helpers as H

    proc = H.start_reference(STEP_REFERENCE.format(
        cases=[c for c in cases if c[4] is None], steps=steps, path=path,
        archs=sorted({c[1] for c in cases}), kw=kw))
    deadline = time.monotonic() + H.REFERENCE_TIMEOUT_S
    while not os.path.exists(path + ".init"):
        if proc.poll() is not None or time.monotonic() > deadline:
            H.finish_reference(proc)
            raise RuntimeError("the reference wrote no initial state")
        time.sleep(0.1)
    with open(path + ".init", "rb") as f:
        states = pickle.load(f)
    launched: dict = {}

    def launch():
        try:
            launched["ranks"] = H.launch(step_rank, 4, cases, states, steps)
        except BaseException as e:       # noqa: BLE001 — raised below
            launched["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    single = reference_single([c for c in cases if c[4] is None], steps)
    thread.join()
    H.finish_reference(proc)
    if "error" in launched:
        raise launched["error"]
    with open(path, "rb") as f:
        mesh = pickle.load(f)
    return launched["ranks"], {name: {"single": single[name],
                                      "mesh": mesh[name]}
                               for name in single}


def reference_single(cases, steps) -> dict:
    """The reference's train step on one device, in this process, for
    each case: {"metrics", "states"} per case (JAX imported here)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import TrainConfig, get_reduced_config
    from repro.models import build_model
    from repro.sharding.flags import reset_flags, set_flags
    from repro.train.step import init_train_state, make_train_step

    out = {}
    for name, arch, kw, groups, _ in cases:
        cfg = get_reduced_config(arch)
        model = build_model(cfg)
        tcfg = TrainConfig(**kw)
        set_flags(moe_groups=groups)
        try:
            state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
            step = jax.jit(make_train_step(model, tcfg))
            mets, states = [], []
            for b in batches(cfg.vocab_size, steps):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                mets.append({k: float(v) for k, v in m.items()})
                states.append(plain_state(jax.tree_util.tree_map(
                    np.asarray, state)))
        finally:
            reset_flags()
        out[name] = {"metrics": mets, "states": states}
    return out


def _max_err(got, want, scale=None):
    import torch

    from repro_torch.tree import tree_leaves

    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    err = max(float(np.abs(np.asarray(g, np.float32)
                           - w.to(torch.float32).numpy()).max())
              for g, w in zip(gl, wl))
    if scale is None:
        scale = max(float(w.abs().max()) for w in wl)
    return err / scale


def state_errors(got, want, lr):
    """got: the port's state as numpy (a rank's result); want: the
    reference's as a port tree."""
    return {"params": _max_err(got.params, want.params, lr),
            "master": _max_err(got.opt.master, want.opt.master, lr),
            "m": _max_err(got.opt.m, want.opt.m),
            "v": _max_err(got.opt.v, want.opt.v)}


def check_case(name, arch, ranks, ref, steps, metric_rtol, lr_rtol):
    """The largest state errors of case ``name`` over its steps, after
    every metric is held to ``metric_rtol`` (the learning rate to
    ``lr_rtol``) against both reference runs."""
    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config(arch)
    got = ranks[0][name]
    digests = {r[name]["digest"] for r in ranks}
    assert len(digests) == 1, "the ranks' states differ"
    assert got["allreduce_calls"] == steps
    worst = {}
    for mode in ("single", "mesh"):
        want = ref[name][mode]
        for i in range(steps):
            jm, tm = want["metrics"][i], got["metrics"][i]
            for k in ("loss", "lm_loss", "grad_norm", "aux_loss"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=metric_rtol,
                                           atol=1e-12)
            np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=lr_rtol)
            errs = state_errors(got["states"][i],
                                port_state(cfg, want["states"][i]),
                                jm["lr"] or 1.0)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


# ---------------------------------------------------------------------------
# the training loop on a mesh
# ---------------------------------------------------------------------------

LOOP_ARCH = "smollm-135m"
LOOP = dict(total_steps=4, learning_rate=1e-3, warmup_steps=1,
            checkpoint_every=2)
SELECT = dict(algo="dash", feature_mode="grad", embed_dim_cap=32,
              n_samples=4)
BATCH, SEQ, EVERY, FACTOR = 4, 32, 2, 3
FAIL_AT = 3
RESUME_FROM = 2


def loop_tokens(vocab):
    from repro_torch.data import make_lm_tokens

    return make_lm_tokens(1, 60_000, vocab)


def _loop(mesh, state0, seed, ckpt, inject=None):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import BatchSelector, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import train_loop

    cfg = get_reduced_config(LOOP_ARCH)
    with TokenPipeline(loop_tokens(cfg.vocab_size), batch=BATCH,
                       seq=SEQ) as pipe:
        res = train_loop(build_model(cfg), TrainConfig(**LOOP), pipe,
                         mesh=mesh, ckpt_dir=ckpt,
                         selector=BatchSelector(BATCH, **SELECT),
                         selection_every=EVERY, selection_pool_factor=FACTOR,
                         failure_injector=inject,
                         init_state=port_state(cfg, state0),
                         sel_key=JaxKey.seed(seed))
    return {"losses": res.losses, "selections": res.selections,
            "restarts": res.restarts, "steps_run": res.steps_run,
            "selection_seconds": len(res.selection_seconds),
            "digest": state_digest(res.state)}


def loop_rank(state0, seed, root):
    """Three runs on four ranks: the uninterrupted run on (2, 2), the
    same run killed at step FAIL_AT and resumed, and a world-2 (1, 2)
    mesh of ranks 0 and 1 resuming from the first run's checkpoints cut
    back to step RESUME_FROM."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import FailureInjector

    mesh = make_mesh((2, 2), AXES, device="cpu")
    out = {"clean": _loop(mesh, state0, seed, os.path.join(root, "clean"))}
    out["killed"] = _loop(mesh, state0, seed, os.path.join(root, "killed"),
                          FailureInjector(fail_at=(FAIL_AT,)))
    cut = os.path.join(root, "cut")
    if mesh.is_writer:
        shutil.copytree(os.path.join(root, "clean"), cut)
        for name in os.listdir(cut):
            if name.startswith("step_") and int(name[5:]) > RESUME_FROM:
                shutil.rmtree(os.path.join(cut, name))
    mesh.barrier()
    small = make_mesh((1, 2), AXES, ranks=[0, 1], device="cpu")
    if small.member:
        out["world2"] = _loop(small, state0, seed, cut)
    return out
