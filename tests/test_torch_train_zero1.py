"""The port's ZeRO-1 train step (``make_train_step(mesh=, grad_specs=)``)
against the JAX reference and the port's replicated data-parallel step,
on the CPU.

Gloo ranks on a (data W, model 1) mesh, W = 2 and 4, run 3 steps from
the reference's initial state on seeded 8 × 32-token batches, each rank
on its rows (``shard_batch``): the reduced smollm-135m at one and two
microbatches and the reduced grok-1 (the MoE).  At W = 2 the reduced
models' 2-layer stacks go over the data axis (each rank holds one
layer's optimizer state whole); at W = 4 every leaf is cut along a
dimension.  Held against:

  * the reference's train step on one device (``reference_single``) on
    the same state and batches, within ``tests/test_torch_train_sharded
    .py``'s tolerances: metrics METRIC_RTOL 2e-6, the learning rate
    LR_RTOL 1e-6, m 1e-5 and v 2e-5 of their largest entries, the master
    and the parameters STEP_TOL of the learning rate (1e-3 for smollm,
    5e-3 for the MoE, as there);
  * the port's replicated step (``make_train_step(mesh=)``) from the
    same state on the same rows, after every step: the ZeRO-1 state put
    back together (``gather_train_state``) within GATHER_TOL (each
    tree's largest difference over its largest entry; the parameters
    and master in units of the learning rate): 1e-4 on those, 2e-6 on m
    and v.  The two steps sum the same gradients in other flat buffers
    (at 4 gloo ranks an element's sum order follows its place in the
    buffer) and the ZeRO-1 step takes the global norm from the parts'
    sums: the gradients and the clip factor part in their last bits,
    and Adam's g/√v carries that to the parameters.  Readings on the
    CPU: 0 at W = 2 on smollm (both orders agree there), at most
    3.1e-5 (parameters), 5.0e-7 (m) and 8.7e-7 (v) elsewhere.  Equality
    bit for bit is checked where the batch axes hold one rank
    (``test_world1_is_the_single_device_step``);
  * each rank's optimizer bytes equal to its share under the placements
    (three times the f32 master's placed bytes).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
import torch_train_helpers as T  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402

STEPS = 3
KW = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1)
CASES = [("smollm", "smollm-135m", dict(KW), 0, None),
         ("smollm_mb2", "smollm-135m", dict(KW, microbatches=2), 0, None),
         ("grok", "grok-1-314b", dict(KW), 0, None)]
WORLDS = (2, 4)
METRIC_RTOL = 2e-6
LR_RTOL = 1e-6
STATE_TOL = {"m": 1e-5, "v": 2e-5}
STEP_TOL = {"smollm-135m": 1e-3, "grok-1-314b": 5e-3}
GATHER_TOL = {"params": 1e-4, "master": 1e-4, "m": 2e-6, "v": 2e-6}


def _initial_states():
    import jax

    from repro.configs import TrainConfig, get_reduced_config as jcfg
    from repro.models import build_model
    from repro.train.step import init_train_state

    return {arch: T.plain_state(jax.tree_util.tree_map(
        np.asarray, init_train_state(build_model(jcfg(arch)),
                                     jax.random.PRNGKey(0),
                                     TrainConfig(**KW))))
            for arch in sorted({c[1] for c in CASES})}


@pytest.fixture(scope="module")
def runs():
    states = _initial_states()
    got: dict = {}

    def launch(w):
        try:
            got[w] = H.launch(T.zero1_rank, w, CASES, states, STEPS)
        except BaseException as e:        # noqa: BLE001 — raised below
            got["error"] = e

    threads = [threading.Thread(target=launch, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    single = T.reference_single(CASES, STEPS)
    for t in threads:
        t.join()
    if "error" in got:
        raise got["error"]
    return got, single


def _case_ids():
    return [f"{c[0]}-w{w}" for w in WORLDS for c in CASES]


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in CASES], ids=_case_ids())
def test_zero1_step_matches_jax(runs, world, case):
    got, single = runs
    name, arch = case[0], case[1]
    cfg = get_reduced_config(arch)
    mine = got[world][0][name]
    want = single[name]
    for i in range(STEPS):
        jm, tm = want["metrics"][i], mine["metrics"][i]
        for k in ("loss", "lm_loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                       atol=1e-12)
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=LR_RTOL)
        errs = T.state_errors(mine["gathered"][i],
                              T.port_state(cfg, want["states"][i]),
                              jm["lr"] or 1.0)
        for k, tol in STATE_TOL.items():
            assert errs[k] <= tol, (i, errs)
        assert max(errs["params"], errs["master"]) <= STEP_TOL[arch], \
            (i, errs)


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in CASES], ids=_case_ids())
def test_gathered_state_matches_the_replicated_step(runs, world, case):
    got, single = runs
    mine = got[world][0][case[0]]
    for i in range(STEPS):
        lr = single[case[0]]["metrics"][i]["lr"] or 1.0
        g, r = mine["gathered"][i], mine["replicated"][i]
        errs = {"params": T._max_err(g.params, _port(r.params), lr),
                "master": T._max_err(g.opt.master, _port(r.opt.master), lr),
                "m": T._max_err(g.opt.m, _port(r.opt.m)),
                "v": T._max_err(g.opt.v, _port(r.opt.v))}
        for k, tol in GATHER_TOL.items():
            assert errs[k] <= tol, (i, errs)


def _port(tree):
    """A rank's numpy tree as tensors."""
    from repro_torch.tree import tree_map

    return tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_share_of_the_optimizer_state(runs, world):
    got, _ = runs
    for rank in got[world]:
        for name, res in rank.items():
            assert res["held"] == res["share"], (name, res["held"],
                                                 res["share"])
            assert res["calls"] == (STEPS, STEPS)
    if world == 2:
        # the stack of 2 layers over 2 ranks: one layer's state whole each
        from repro_torch.tree import tree_leaves

        layer = T.port_state(get_reduced_config("smollm-135m"),
                             _initial_states()["smollm-135m"]).params
        one = 3 * 4 * sum(x.numel() for x in tree_leaves(layer["layers"][0]))
        assert all(r["smollm"]["held"] >= one for r in got[2])


def test_world1_is_the_single_device_step():
    """Where the batch axes hold one rank every part is a whole leaf and
    the ZeRO-1 step is the single-device step, bit for bit."""
    res = H.launch(_world1, 1)[0]
    assert res["same"], res


def _world1(compression="none"):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import (
        batch_axes_for_mesh,
        param_partition_specs,
        zero1_specs,
    )
    from repro_torch.train.step import (
        init_train_state,
        make_train_step,
        shard_train_state,
    )
    from repro_torch.tree import tree_leaves

    cfg = get_reduced_config("smollm-135m")
    model = build_model(cfg)
    tcfg = TrainConfig(**KW, grad_compression=compression)
    mesh = make_mesh((1, 1), T.AXES, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    specs = zero1_specs(param_partition_specs(state.params, cfg, mesh),
                        state.params, mesh, batch_axes_for_mesh(mesh), cfg)
    z = shard_train_state(state, mesh, specs, cfg)
    zstep = make_train_step(model, tcfg, mesh=mesh, grad_specs=specs)
    step = make_train_step(model, tcfg)
    same = True
    for batch in T.batches(cfg.vocab_size, STEPS):
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        z, mz = zstep(z, b)
        state, ms = step(state, b)
        same &= all(torch.equal(a, c) for a, c in zip(
            tree_leaves((z, mz)), tree_leaves((state, ms))))
    return {"same": bool(same)}


def test_compression_and_a_missing_mesh_are_refused():
    """A missing mesh is refused; gradient compression under ZeRO-1 is
    not (it runs, ``tests/test_torch_tp_compression.py`` holds it to the
    reference): a step of each scheme at world 1 is the single-device
    compressed step, bit for bit."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_step

    model = build_model(get_reduced_config("smollm-135m"))
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(model, TrainConfig(), grad_specs={})
    res = H.launch(_world1_compressed, 1, ("int8", "topk"))[0]
    assert all(res.values()), res


def _world1_compressed(schemes):
    return {comp: _world1(comp)["same"] for comp in schemes}
