"""The port's optimizer pieces and data pipeline against the JAX
reference on the CPU, on random trees and seeded token streams.

  * ``cosine_schedule`` over steps 0 … total + 2 (warmup, decay, past
    the end): rtol LR_RTOL 1e-6 (an f32 cosine each);
  * ``adamw_update``, four steps from ``adamw_init`` on random trees of
    gradients (one step clipped by the global norm), with f32 and bf16
    ``param_dtype``: the master, m and v to STATE_RTOL 1e-6 of each
    leaf's largest entry, the parameters the port's master cast, and
    equal to the reference's wherever the two masters cast to the same
    value, the grad norm to 1e-6;
  * both compression schemes with error feedback, ten steps: bitwise
    equal (the same f32 arithmetic, element by element);
  * ``make_lm_tokens``, ``TokenPipeline.batch_for_step`` and
    ``pool_for_step``, ``pool_from_callable``: bitwise equal (numpy
    copies); ``close()`` joins the prefetch thread.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

LR_RTOL = 1e-6
STATE_RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.normal(size=(16, 8))).astype(np.float32),
            "blocks": [(scale * rng.normal(size=(5,))).astype(np.float32),
                       {"a": (scale * rng.normal(size=(3, 4, 2))).astype(
                           np.float32)}],
            "b": (scale * rng.normal(size=(7,))).astype(np.float32)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float32)
        g = g.to(torch.float32).numpy()
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rtol * scale


def test_tree_leaves_follow_jax_order():
    t = _tree(np.random.default_rng(0))
    for g, w in zip(tree_leaves(_torch(t)), jax.tree_util.tree_leaves(t)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("warmup,total", [(3, 20), (0, 5), (1, 1)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(total + 3):
        want = float(jsched.cosine_schedule(
            jnp.asarray(step, jnp.int32), base_lr=3e-3,
            warmup_steps=warmup, total_steps=total))
        got = float(tsched.cosine_schedule(
            torch.tensor(step, dtype=torch.int32), base_lr=3e-3,
            warmup_steps=warmup, total_steps=total))
        np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=1e-12)


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_adamw_matches_jax(pdt):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jt = JaxTrainConfig(weight_decay=0.1, grad_clip=1.0)
    tt = TrainConfig(weight_decay=0.1, grad_clip=1.0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[pdt]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[pdt]
    js = jadamw.adamw_init(_jax(params))
    ts = tadamw.adamw_init(_torch(params))
    clipped = False
    for i in range(4):
        grads = _tree(rng, scale=0.05 if i % 2 else 0.5)
        lr = 1e-2 * (i + 1)
        jp, js, jm = jadamw.adamw_update(_jax(grads), js, jnp.float32(lr),
                                         jt, param_dtype=jdt)
        tp, ts, tm = tadamw.adamw_update(_torch(grads), ts,
                                         torch.tensor(lr), tt,
                                         param_dtype=tdt)
        clipped |= float(jm["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        for got, want in ((ts.master, js.master), (ts.m, js.m),
                          (ts.v, js.v)):
            _close(got, want, STATE_RTOL)
        for g, w, m, jmaster in zip(
                tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                tree_leaves(ts.master), jax.tree_util.tree_leaves(js.master)):
            assert g.dtype == tdt and torch.equal(g, m.to(tdt))
            same = m.to(tdt) == torch.tensor(np.asarray(jmaster)).to(tdt)
            w = torch.tensor(np.asarray(w, np.float32))
            assert same.float().mean() > 0.5
            assert torch.equal(g.to(torch.float32)[same], w[same])
    assert clipped


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_matches_jax_bitwise(scheme):
    rng = np.random.default_rng(2)
    shapes = _tree(rng)
    jef = jcomp.init_error_feedback(_jax(shapes))
    tef = tcomp.init_error_feedback(_torch(shapes))
    for _ in range(10):
        g = _tree(rng)
        jc, jef = jcomp.compress_gradients(_jax(g), jef, scheme,
                                           topk_ratio=0.1)
        tc, tef = tcomp.compress_gradients(_torch(g), tef, scheme,
                                           topk_ratio=0.1)
        jd = jcomp.decompress_gradients(jc, scheme)
        td = tcomp.decompress_gradients(tc, scheme)
        for got, want in ((td, jd), (tef, jef)):
            for a, b in zip(tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if scheme == "int8":
        leaf = tc["w"]
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == \
            torch.float32


def test_make_lm_tokens_matches_jax():
    for seed, n, v in ((0, 10_000, 256), (3, 4097, 49152)):
        np.testing.assert_array_equal(tsynth.make_lm_tokens(seed, n, v),
                                      jsynth.make_lm_tokens(seed, n, v))


def test_pipeline_matches_jax_and_close_joins():
    toks = tsynth.make_lm_tokens(1, 60_000, 256)
    with jpipe.TokenPipeline(toks, batch=4, seq=32) as jp, \
            tpipe.TokenPipeline(toks, batch=4, seq=32) as tp:
        for step in (0, 1, 7, 123):
            np.testing.assert_array_equal(tp.batch_for_step(step)["tokens"],
                                          jp.batch_for_step(step)["tokens"])
            pb, ids = tp.pool_for_step(step, 24)
            jb, jids = jp.pool_for_step(step, 24)
            np.testing.assert_array_equal(pb["tokens"], jb["tokens"])
            np.testing.assert_array_equal(ids, jids)
            assert ids.dtype == np.int64 and len(set(ids.tolist())) == 24
        first = next(iter(tp))
        np.testing.assert_array_equal(first["tokens"],
                                      jp.batch_for_step(0)["tokens"])
        thread = tp._thread
        assert thread.is_alive()
    assert not thread.is_alive()
    tp.close()                                      # idempotent
    assert not any(t is thread for t in threading.enumerate())


def test_pool_from_callable_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.integers(0, 100, (64, 8)).astype(np.int32)

    def source(step):
        return {"tokens": table[[step % 64, (step * 7) % 64]]}

    for step in (0, 5):
        pb, ids = tpipe.pool_from_callable(source, step, 3)
        jb, jids = jpipe.pool_from_callable(source, step, 3)
        np.testing.assert_array_equal(pb["tokens"], jb["tokens"])
        np.testing.assert_array_equal(ids, jids)
