"""The port's tensor parallelism over ``model``: the training loss and its
gradients against the JAX reference's single-device
``jax.value_and_grad(model.loss)``, on the CPU (the dense cases here,
the MoE's in ``tests/test_torch_tp_loss_moe.py``).

Gloo ranks on meshes (data 1, model 2) and (data 2, model 2) run the
reduced configs of ``tests/torch_tp_helpers.py`` (the contracting and
head paths, the q/k/v biases, a vocabulary split and one left whole;
the MoE's experts over ``model`` and its d_ff split), each rank on its
shards of the reference's perturbed init and on its rows of a seeded 4 ×
32-token batch; the loss, the metrics and the gradients are summed over
the batch axes as the train step sums them.  Held against the reference:

  * LOSS_RTOL 1e-5 — the loss and ``lm_loss``, relative; readings on the
    CPU at most 1.6e-7 (grok_dff);
  * AUX_TOL 1e-6 — the MoE's load-balance loss (≈ 2e-2), absolute, as
    ``tests/test_torch_train_loss.py``;
  * GRAD_TOL 1e-4 — each rank's gradient shard against the matching
    slice of the reference's gradient, the largest difference over the
    norm of the reference's whole leaf; readings at most 8.4e-7 (dense)
    and 1.7e-6 (llama4).  A planted fault (the backward's sum over
    ``model`` of the entry to the split weights dropped, so each rank
    keeps its own part of dx) reads 3.4e-1 on danube.

The layouts each case takes are checked too, so that every branch runs.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402

import torch_dist_helpers as H  # noqa: E402
import torch_tp_helpers as P  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.convert import _split_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_lm import _perturb  # noqa: E402

LOSS_RTOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
NAMES = ["smollm", "danube", "qwen", "odd_vocab"]
SHAPES = [(1, 2), (2, 2)]
LAYOUTS = {"smollm": ("contract", True, None, True),
           "danube": ("heads", True, None, True),
           "qwen": ("heads", True, None, True),
           "llama4": ("heads", False, "experts", True),
           "grok_dff": ("heads", False, "dff", True),
           "odd_vocab": ("heads", True, None, False)}


def _reference(name):
    jcfg = P.config(name, jax_reduced_config)
    jm = jax_build_model(jcfg)
    pnp = _perturb(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 0)
    batch = {"tokens": P.padded_tokens(jcfg, 4, 32)}
    (loss, met), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree_util.tree_map(jax.numpy.asarray, pnp),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    grads = _split_params(jcfg, jax.tree_util.tree_map(np.asarray, g),
                          torch.float32, torch.device("cpu"))
    return pnp, batch, {"loss": float(loss), "lm_loss":
                        float(met["lm_loss"]),
                        "aux_loss": float(met["aux_loss"]), "grads": grads}


def run_cases(names):
    """(per mesh shape the ranks' ``loss_rank`` results, per case the
    reference's numpy weights, batch and results)."""
    refs = {n: _reference(n) for n in names}
    params = {n: r[0] for n, r in refs.items()}
    batches = {n: r[1] for n, r in refs.items()}
    got: dict = {}

    def launch(shape):
        try:
            got[shape] = H.launch(P.loss_rank, shape[0] * shape[1], shape,
                                  names, params, batches)
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


@pytest.fixture(scope="module")
def runs():
    return run_cases(NAMES)


def _grad_errors(name, rank, want):
    """Per leaf: the rank's shard against the slice of the reference's
    whole leaf, over that leaf's norm."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.train.step import tp_param_specs

    model = build_model(P.port_config(name))
    specs = tp_param_specs(model, ShapeMesh((1, 2), P.AXES))
    ref = P.slice_shard(want, specs, 2, rank["index"])
    mine = tree_leaves(rank["grads"])
    whole = tree_leaves(want)
    return [float(np.abs(np.asarray(g) - r.numpy()).max())
            / max(float(w.norm()), 1e-30)
            for g, r, w in zip(mine, tree_leaves(ref), whole)]


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradient_shards_match_jax(runs, shape, name):
    check(runs, shape, name)


def check(runs, shape, name):
    got, refs = runs
    w = refs[name][2]
    for rank in got[shape]:
        r = rank[name]
        assert tuple(r["layout"].values()) == LAYOUTS[name]
        loss, lm, aux = r["loss"]
        np.testing.assert_allclose(loss, w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(lm, w["lm_loss"], rtol=LOSS_RTOL)
        assert abs(aux - w["aux_loss"]) <= AUX_TOL
        errs = _grad_errors(name, r, w["grads"])
        assert max(errs) <= GRAD_TOL, max(errs)


def test_planted_fault_reads_above_the_gradient_gate(runs):
    """The head path's entry without its backward sum over ``model``:
    each rank keeps its own heads' part of the input's gradient, and
    the gradients of every layer below the last part from the
    reference's."""
    pnp, batch, want = runs[1]["danube"]
    rank = H.launch(P.faulty_loss_rank, 2, pnp, batch)[0]
    assert max(_grad_errors("danube", rank, want["grads"])) > 1e3 * GRAD_TOL
