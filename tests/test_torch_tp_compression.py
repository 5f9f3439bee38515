"""Gradient compression under ZeRO-1 and under tensor parallelism,
against the JAX reference's compressed step, on the CPU.

A rank that holds a part of a leaf (its ZeRO-1 part over the batch
axes, its shard over ``model``) compresses it with the whole leaf's
top-k threshold or int8 scale (``optim.compression.compress_parts``):
the holders' top-k magnitudes or largest magnitude, gathered.  The
compressor's decisions are discrete, so both packages are fed the same
gradients (as ``tests/test_torch_train_step_compression.py`` does): the
reference's gradients along its own trajectory of three steps of the
reduced smollm-135m (4 × 32 tokens), put on the rank at batch
coordinate 0 (its ``model`` shard of them) and zeros on the others, so
that their sum over the batch axes is exact.  The port's
``make_train_step(mesh=, grad_specs=zero1_specs(...))`` at (data W,
model 1), W = 2 (the reduced model's 2-layer stacks over the data
axis: a rank's part of a stacked leaf is one layer whole or nothing)
and 4 (every leaf cut along a dimension), and ``make_train_step(mesh=,
tensor_parallel=True)`` and its ZeRO-1 form at (data 1, model 2), with
``topk`` and ``int8``, run on them; the state gathered whole after each
step is held against the reference's compression and AdamW on the same
gradients (``jax_step_on``) within
``tests/test_torch_train_step.py``'s same-gradient gates:
SAME_GRADS_TOL 5e-6 of the largest entry on m, v and the error
feedback, SAME_GRADS_STEP_TOL 1e-4 of the learning rate on the
parameters and the master, METRIC_RTOL 2e-6 on the grad norm.  Readings
on the CPU over every mesh: the error feedback 0 (the decisions are the
reference's, bit for bit), m 1.0e-6, v 2.0e-6, the parameters 3.1e-5
of the learning rate, the grad norm 1.3e-6 (the sums of squares in
another order).  A planted fault (each ZeRO-1 part's top-k threshold
from its own entries alone, at world 4) reads 1.0 on the error
feedback.
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
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch.mesh import to_numpy  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _split_params,
    train_state_from_numpy,
)
from test_torch_train_step import (  # noqa: E402
    METRIC_RTOL,
    SAME_GRADS_STEP_TOL,
    SAME_GRADS_TOL,
    jax_step_on,
    state_errors,
)

ARCH = "smollm-135m"
STEPS = 3
KW = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1)
SCHEMES = ["topk", "int8"]
# (mesh shape, ZeRO-1)
MESHES = [((2, 1), True), ((4, 1), True), ((1, 2), False), ((1, 2), True)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """A rank's numpy tree as tensors."""
    return tree_map(torch.from_numpy, tree)


def _reference(scheme):
    """(the initial state as plain numpy, the fed gradients per step in
    the port's layout, the reference's states and metrics per step)."""
    jt = JaxTrainConfig(**KW, grad_compression=scheme)
    jm = jax_build_model(jax_reduced_config(ARCH))
    jstate = jax_init_state(jm, jax.random.PRNGKey(0), jt)
    init = T.plain_state(_np_tree(jstate))
    cfg = get_reduced_config(ARCH)
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    fed, states, mets = [], [], []
    for batch in T.batches(cfg.vocab_size, STEPS, b=4):
        g = jgrad(jstate.params, {"tokens": jnp.asarray(batch["tokens"])})
        fed.append(to_numpy(_split_params(
            cfg, _np_tree(g), torch.float32, torch.device("cpu"))))
        jstate, m = jax_step_on(jstate, g, jt)
        states.append(train_state_from_numpy(cfg, _np_tree(jstate), "cpu"))
        mets.append({k: float(v) for k, v in m.items()})
    return init, fed, states, mets


@pytest.fixture(scope="module")
def runs():
    refs = {s: _reference(s) for s in SCHEMES}
    got: dict = {}

    def launch(shape, zero1):
        runs = [(s, refs[s][0], refs[s][1]) for s in SCHEMES]
        try:
            got[(shape, zero1)] = H.launch(
                P.fed_step_rank, shape[0] * shape[1], shape, ARCH, KW, runs,
                zero1, "topk" if shape == (4, 1) else None)[0]
        except BaseException as e:        # noqa: BLE001 — raised below
            got["error"] = e

    threads = [threading.Thread(target=launch, args=(sh, z))
               for sh, z in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if "error" in got:
        raise got["error"]
    return got, refs


def _ids():
    return [f"{s}-{sh[0]}x{sh[1]}{'-zero1' if z else ''}"
            for sh, z in MESHES for s in SCHEMES]


@pytest.mark.parametrize("shape,zero1,scheme",
                         [(sh, z, s) for sh, z in MESHES for s in SCHEMES],
                         ids=_ids())
def test_compressed_step_matches_jax(runs, shape, zero1, scheme):
    got, refs = runs
    mine = got[(shape, zero1)][scheme]
    _, _, states, mets = refs[scheme]
    for i in range(STEPS):
        np.testing.assert_allclose(mine["metrics"][i]["grad_norm"],
                                   mets[i]["grad_norm"], rtol=METRIC_RTOL)
        errs = state_errors(_port(mine["gathered"][i]), states[i],
                            mets[i]["lr"] or 1.0)
        for k in ("m", "v", "error_fb"):
            assert errs[k] <= SAME_GRADS_TOL, (i, k, errs)
        for k in ("params", "master"):
            assert errs[k] <= SAME_GRADS_STEP_TOL, (i, k, errs)


def test_each_parts_own_threshold_reads_above_the_gates(runs):
    """The planted fault: top-k on a ZeRO-1 part's own entries (its
    threshold not gathered) at world 4."""
    got, refs = runs
    _, _, states, mets = refs["topk"]
    mine = got[((4, 1), True)]["fault"]
    errs = state_errors(_port(mine["gathered"][0]), states[0],
                        mets[0]["lr"] or 1.0)
    assert errs["error_fb"] > 100 * SAME_GRADS_TOL, errs
