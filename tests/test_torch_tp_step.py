"""The port's tensor-parallel train step against the JAX reference and
the port's single-device step, on the CPU.

Gloo ranks on meshes (data 1, model 2) and (data 2, model 2) run 3 steps
of ``make_train_step(mesh=, tensor_parallel=True)`` and of its ZeRO-1
form (``grad_specs=zero1_specs(...)``) from the reference's initial
state, each rank on its shards (``shard_train_state(...,
param_specs=)``) and its rows of seeded 8 × 32-token batches, for the
reduced smollm of ``tests/torch_tp_helpers.py`` (the contracting path)
and the reduced llama4-maverick (the head path, experts over
``model``).  The state gathered whole after each step
(``gather_train_state``) is held against the reference's single-device
step on the same state and batches, within
``tests/test_torch_train_zero1.py``'s gates against the reference: the
metrics METRIC_RTOL 2e-6, the learning rate LR_RTOL 1e-6, m 1e-5 and v
2e-5 of their largest entries, the master and the parameters STEP_TOL of
the learning rate (1e-3 for smollm, 5e-3 for the MoE).  Readings on the
CPU: at most 2.4e-7 (metrics), 1.5e-6 (m), 1.7e-6 (v),
2.0e-4 (smollm's parameters) and 1.7e-4 (llama4's).  (That file's GATHER_TOL, 1e-4 of the learning rate, holds
its ZeRO-1 step to the port's data-parallel step on the same gradients;
here the gradients themselves are summed over ``model`` in another
order than one device's, and Adam's first steps, g/√v, carry that to
the parameters: against the port's single-device step they read up to
1.4e-4 of the learning rate.)

Each rank's parameter bytes equal its share under the placements.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_helpers as H  # noqa: E402
import torch_tp_helpers as P  # noqa: E402
import torch_train_helpers as T  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_train_zero1 import (  # noqa: E402
    LR_RTOL,
    METRIC_RTOL,
    STATE_TOL,
)

STEPS = 3
KW = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1)
NAMES = ["smollm", "llama4"]
STEP_TOL = {"smollm": 1e-3, "llama4": 5e-3}
SHAPES = [(1, 2), (2, 2)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return tree_map(torch.from_numpy, tree)


def _reference(name):
    """(initial state as plain numpy, batches, the reference's metrics
    and states per step)."""
    jcfg = P.config(name, jax_reduced_config)
    jm = jax_build_model(jcfg)
    jt = JaxTrainConfig(**KW)
    jstate = jax_init_state(jm, jax.random.PRNGKey(0), jt)
    init = T.plain_state(_np_tree(jstate))
    cfg = P.port_config(name)
    jstep = jax.jit(jax_make_step(jm, jt))
    batches = T.batches(cfg.vocab_size, STEPS)
    mets, states = [], []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in m.items()})
        states.append(T.port_state(cfg, T.plain_state(_np_tree(jstate))))
    return init, batches, mets, states


@pytest.fixture(scope="module")
def runs():
    refs = {n: _reference(n) for n in NAMES}
    states = {n: r[0] for n, r in refs.items()}
    batches = {n: r[1] for n, r in refs.items()}
    cases = [(n, KW, z) for n in NAMES for z in (False, True)]
    got: dict = {}

    def launch(shape):
        try:
            got[shape] = H.launch(P.step_rank, shape[0] * shape[1], shape,
                                  cases, states, batches, STEPS)
        except BaseException as e:        # noqa: BLE001 — raised below
            got["error"] = e

    threads = [threading.Thread(target=launch, args=(s,)) for s in SHAPES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if "error" in got:
        raise got["error"]
    return got, refs


CASES = [(s, n, z) for s in SHAPES for n in NAMES for z in ("rep", "zero1")]


@pytest.mark.parametrize("shape,name,kind", CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-{z}" for s, n, z in CASES])
def test_tp_step_matches_jax(runs, shape, name,
                                                        kind):
    got, refs = runs
    mine = got[shape][0][f"{name}/{kind}"]
    _, _, mets, states = refs[name]
    for i in range(STEPS):
        jm, tm = mets[i], mine["metrics"][i]
        for k in ("loss", "lm_loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                       atol=1e-12)
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=LR_RTOL)
        lr = jm["lr"] or 1.0
        g = _port(mine["gathered"][i])
        errs = T.state_errors(g, states[i], lr)
        for k, tol in STATE_TOL.items():
            assert errs[k] <= tol, (i, errs)
        assert max(errs["params"], errs["master"]) <= STEP_TOL[name], \
            (i, errs)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
def test_each_rank_holds_its_share_of_the_parameters(runs, shape):
    got, _ = runs
    for rank in got[shape]:
        for key, res in rank.items():
            assert res["held"] == res["share"], (key, res["held"],
                                                 res["share"])
