"""The port's training loss, its gradients and ``input_specs`` against
the JAX reference on the CPU: the dense archs here; the MoE archs
in ``tests/test_torch_train_loss_moe.py``, the encoder-decoder and the
image prefix in ``tests/test_torch_train_loss_encdec.py``, the RG-LRU
hybrid in ``tests/test_torch_train_loss_rglru.py`` and xlstm-125m in
``tests/test_torch_train_loss_xlstm.py`` (the reference's compiles of
the loss gradients take most of the time, so the files are cut small).

The same seeded numpy inputs go through ``jax.value_and_grad(
model.loss)`` and the port's ``Model.loss`` with ``torch.autograd``;
weights are the JAX init's with the norm scales and biases moved off
their init values (``tests/test_torch_lm.py``'s ``_models``), carried
across by ``model_params_from_numpy``; the reference's gradients are
split per layer by the same code.  Batch 2 × 32, with the arch's image
embeddings or encoder frames.

Tolerances, from readings on the CPU:
  * LOSS_RTOL 2e-6 — the loss (≈ 6): the reference's and the port's
    differ by at most 9.5e-7 (1.6e-7 relative) over every arch; a
    planted fault (the last position not masked out) reads 1e-3 and
    more;
  * GRAD_TOL 1e-5 — every gradient entry, relative to the largest
    gradient entry of the model: at most 3.0e-6 (recurrentgemma) and
    1.2e-6 for the others; the planted fault (one of the 64 tokens
    changed) reads above 1e-2;
  * XLSTM_GRAD_TOL 5e-4 — the same for xlstm-125m, whose mLSTM passes
    rounding on amplified (its logits' own tolerance,
    ``tests/test_torch_encdec_vlm.py``): reading 1.5e-4;
  * AUX_TOL 1e-6 — the MoE's load-balance loss (≈ 2e-2), absolute.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import ALL_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_config,
    get_reduced_config,
    list_archs,
)
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _split_params,
    model_params_from_numpy,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_encdec_vlm import _batch, _jb  # noqa: E402
from test_torch_lm import _models, _perturb  # noqa: E402

LOSS_RTOL = 2e-6
GRAD_TOL = 1e-5
XLSTM_GRAD_TOL = 5e-4
AUX_TOL = 1e-6
ARCHS = ["smollm-135m", "h2o-danube-1.8b", "olmo-1b", "qwen2.5-14b"]
CPU = torch.device("cpu")


def grad_tol(arch):
    return XLSTM_GRAD_TOL if arch == "xlstm-125m" else GRAD_TOL


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_loss_and_grads(jm, jp, batch):
    """(loss, metrics, gradients split per layer as f32 tensors) of the
    reference."""
    (loss, met), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _jb(batch))
    grads = _split_params(jm.cfg, jax.tree_util.tree_map(np.asarray, g),
                          torch.float32, CPU)
    return float(loss), {k: float(v) for k, v in met.items()}, grads


def grad_error(got, want) -> float:
    """Largest |got − want| over every entry, over the largest |want|."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    scale = max(float(w.abs().max()) for w in wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
    return max(float((g.to(torch.float32) - w).abs().max())
               for g, w in zip(gl, wl)) / scale


def models(arch, **overrides):
    """``tests/test_torch_lm.py``'s ``_models`` (the reduced arch on the
    same perturbed JAX init) with config overrides on both sides."""
    if not overrides:
        return _models(arch)
    jcfg = jax_reduced_config(arch, **overrides)
    jm = jax_build_model(jcfg)
    pnp = _perturb(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 0)
    cfg = get_reduced_config(arch, **overrides)
    return (jm, jax.tree_util.tree_map(jnp.asarray, pnp), build_model(cfg),
            model_params_from_numpy(cfg, pnp, "cpu"))


def check_loss_and_grads(arch, **overrides):
    jm, jp, tm, tp = models(arch, **overrides)
    batch = _batch(tm.cfg, 2, 32)
    jl, jmet, jg = jax_loss_and_grads(jm, jp, batch)
    loss, met, g = loss_and_grads(tm, tp, _tb(batch))
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["lm_loss"]), jmet["lm_loss"],
                               rtol=LOSS_RTOL)
    assert abs(float(met["aux_loss"]) - jmet["aux_loss"]) <= AUX_TOL
    err = grad_error(g, jg)
    assert err <= grad_tol(arch), err
    return tm, tp, batch, jl, jg


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_planted_faults_read_above_the_tolerances():
    """The last position left in the mask moves the loss past
    LOSS_RTOL; one token changed moves the gradients past GRAD_TOL."""
    tm, tp, batch, jl, jg = check_loss_and_grads("smollm-135m")
    fault = _loss_without_mask(tm, tp, _tb(batch))
    assert abs(fault - jl) / jl > 100 * LOSS_RTOL
    moved = {k: v.copy() for k, v in batch.items()}
    moved["tokens"][0, 5] = (moved["tokens"][0, 5] + 1) % tm.cfg.vocab_size
    _, _, g = loss_and_grads(tm, tp, _tb(moved))
    assert grad_error(g, jg) > 100 * GRAD_TOL


def _loss_without_mask(model, params, batch) -> float:
    """``Model.loss`` with the wrapped last position counted."""
    with torch.no_grad():
        x, _ = model._inputs(params, batch)
        h, _, _ = model._backbone(params, x, impl="full")
        lf = model._logits(params, h).to(torch.float32)
        labels = torch.roll(batch["tokens"].long(), -1, dims=1)
        nll = torch.logsumexp(lf, -1) - torch.gather(
            lf, -1, labels[..., None])[..., 0]
        return float(nll.mean())


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch):
    """Every ShapeConfig kind of the published config: the same inputs
    with the reference's shapes and dtypes, as meta tensors; a decode
    cache's layer i against pattern position i % period of the
    reference's cache, without its super-block axis."""
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch))
    assert [s.name for s in ALL_SHAPES] == [s.name for s in JAX_SHAPES]
    for shape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
        want = jm.input_specs(jshape)
        got = tm.input_specs(shape)
        assert set(got) == set(want)
        for name in ("tokens", "pos", "img_embeds", "enc_frames"):
            if name in want:
                assert got[name].device.type == "meta"
                assert tuple(got[name].shape) == want[name].shape
                assert _dtype_name(got[name]) == np.dtype(
                    want[name].dtype).name
        if "cache" not in want:
            continue
        jc, tc = want["cache"], got["cache"]
        assert set(tc) == set(jc)
        period = len(jc["layers"])
        assert len(tc["layers"]) == tm.cfg.n_layers
        for i, c in enumerate(tc["layers"]):
            w = jc["layers"][i % period]
            assert type(c).__name__ == type(w).__name__
            for f, leaf in c._asdict().items():
                wl = getattr(w, f)
                assert tuple(leaf.shape) == wl.shape[1:], (i, f)
                assert _dtype_name(leaf) == np.dtype(wl.dtype).name
        for name in ("step_offset", "enc_out"):
            if name in jc:
                assert tuple(tc[name].shape) == jc[name].shape
                assert _dtype_name(tc[name]) == np.dtype(jc[name].dtype).name
