"""The port's RG-LRU block against the JAX reference, on the CPU.

The same seeded numpy weights and inputs go through
``repro.models.layers.rglru`` and ``repro_torch.models.layers.rglru`` on
the reduced recurrentgemma config (d_model 64, width 64, conv width 4).

Tolerances:
  * TOL 1e-5 (rtol and atol) — the conv, the gates and one decode step:
    the same f32 formulas, products over d ≤ 64 in another order;
  * SCAN_TOL 2e-5 (rtol and atol) — prefill outputs and final states:
    the port's scan (Hillis–Steele) and ``jax.lax.associative_scan``
    apply the same associative combine in another order, so h differs by
    a few ulps of its running sums (|h| of order 1, S ≤ 300), and those
    pass through the output projection.
The scan alone is held to a sequential float64 recurrence at SCAN_TOL.
The perf flags ``rglru_chunk`` (the chunked scan, against the
reference's chunked scan and the port's whole scan, at SCAN_TOL; its
gradient through the per-chunk checkpoints against the whole scan's at
SCAN_TOL) and ``rglru_block_gates`` (the init's shapes; the reduced
recurrentgemma's prefill logits against the reference's with both flags
set, at LOGIT_TOL 1e-4, the LM tests' tolerance) run in both packages.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import rglru as jr  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models.layers import rglru as tr  # noqa: E402

TOL = 1e-5
SCAN_TOL = 2e-5
LOGIT_TOL = 1e-4
ARCH = "recurrentgemma-2b"
_jax_apply = jax.jit(jr.rglru_apply, static_argnums=2)
_jax_decode = jax.jit(jr.rglru_decode_step, static_argnums=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _params(cfg, seed=0, block_gates=False):
    """Seeded numpy weights with the JAX init's shapes and scales; the
    zero-initialised biases moved off zero so they count."""
    rng = np.random.default_rng(seed)
    d, w, cw = cfg.d_model, cfg.recurrent.width, cfg.recurrent.conv_width
    gate = ((16, w // 16, w // 16), (w // 16) ** -0.5) if block_gates \
        else ((w, w), w ** -0.5)
    p = {"w_in": rng.normal(size=(d, w)) * d ** -0.5,
         "w_gate": rng.normal(size=(d, w)) * d ** -0.5,
         "conv": rng.normal(size=(cw, w)) * cw ** -0.5,
         "w_a": rng.normal(size=gate[0]) * gate[1],
         "b_a": rng.normal(size=w) * 0.1,
         "w_i": rng.normal(size=gate[0]) * gate[1],
         "b_i": rng.normal(size=w) * 0.1,
         "lam": np.linspace(0.0, 2.0, w),
         "w_out": rng.normal(size=(w, d)) * w ** -0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    w, cw = cfg.recurrent.width, cfg.recurrent.conv_width
    return (rng.normal(size=(b, w)).astype(np.float32),
            rng.normal(size=(b, cw - 1, w)).astype(np.float32))


def test_causal_conv_and_gates_match_jax():
    cfg = get_reduced_config(ARCH)
    jp, tp = _both(_params(cfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, cfg.recurrent.width)).astype(np.float32)
    want = jr._causal_conv(jnp.asarray(x), jp["conv"])
    got = tr._causal_conv(_t(x), tp["conv"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    ja, jb = jr._gates(jp, jnp.asarray(x), cfg.recurrent.c_exponent)
    ta, tb = tr._gates(tp, _t(x), cfg.recurrent.c_exponent)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=TOL, atol=TOL)


def test_block_local_gate_matmul_matches_jax():
    cfg = get_reduced_config(ARCH)
    jp, tp = _both(_params(cfg, block_gates=True))
    x = np.random.default_rng(2).normal(
        size=(2, 5, cfg.recurrent.width)).astype(np.float32)
    want = jr._gate_matmul(jnp.asarray(x), jp["w_a"])
    got = tr._gate_matmul(_t(x), tp["w_a"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 300])
def test_linear_scan_matches_a_sequential_float64_recurrence(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 8))
    b = rng.normal(size=(2, s, 8))
    h = np.zeros((2, 8))
    want = np.empty_like(b)
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        want[:, i] = h
    got = tr.linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 3, 40, 300])
def test_rglru_apply_matches_jax(s, with_state):
    """Prefill output and final state (h, conv tail), from zero or from
    an incoming state; S below the conv width pads the tail."""
    cfg = get_reduced_config(ARCH)
    jcfg = jax_reduced_config(ARCH)
    jp, tp = _both(_params(cfg))
    x = np.random.default_rng(3).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if with_state:
        h0, conv0 = _state(cfg, 2, 4)
        jst = jr.RGLRUState(jnp.asarray(h0), jnp.asarray(conv0))
        tst = tr.RGLRUState(_t(h0), _t(conv0))
    want, wst = _jax_apply(jp, jnp.asarray(x), jcfg, jst)
    got, gst = tr.rglru_apply(tp, _t(x), cfg, state=tst)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(gst.h.numpy(), _np(wst.h), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_array_equal(gst.conv.numpy(), _np(wst.conv))


@pytest.mark.parametrize("steps", [1, 5])
def test_rglru_decode_steps_match_jax_and_prefill(steps):
    """Decode steps from an incoming state equal the reference's; from
    the prefill of S tokens they continue it as prefilling S + steps
    does."""
    cfg = get_reduced_config(ARCH)
    jcfg = jax_reduced_config(ARCH)
    jp, tp = _both(_params(cfg, seed=5))
    rng = np.random.default_rng(6)
    h0, conv0 = _state(cfg, 3, 7)
    jst = jr.RGLRUState(jnp.asarray(h0), jnp.asarray(conv0))
    tst = tr.RGLRUState(_t(h0), _t(conv0))
    x = rng.normal(size=(3, 20 + steps, cfg.d_model)).astype(np.float32)
    for i in range(steps):
        xi = x[:, i:i + 1]
        want, jst = _jax_decode(jp, jnp.asarray(xi), jcfg, jst)
        got, tst = tr.rglru_decode_step(tp, _t(xi), cfg, tst)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tst.h.numpy(), _np(jst.h), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tst.conv.numpy(), _np(jst.conv))
    full, _ = tr.rglru_apply(tp, _t(x), cfg)
    _, st = tr.rglru_apply(tp, _t(x[:, :20]), cfg)
    for i in range(steps):
        out, st = tr.rglru_decode_step(tp, _t(x[:, 20 + i:21 + i]), cfg, st)
        np.testing.assert_allclose(out[:, 0].numpy(),
                                   full[:, 20 + i].numpy(), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_init_rglru_state_and_weights_match_jax_shapes():
    cfg = get_reduced_config(ARCH)
    jcfg = jax_reduced_config(ARCH)
    jst = jr.init_rglru_state(3, jcfg, jnp.float32)
    tst = tr.init_rglru_state(3, cfg, torch.float32)
    for g, w in zip(tst, jst):
        assert tuple(g.shape) == w.shape and not bool(g.any())
    want = jr.init_rglru(jax.random.PRNGKey(0), jcfg, jnp.float32)
    got = tr.init_rglru(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
    np.testing.assert_allclose(got["lam"].numpy(), _np(want["lam"]),
                               rtol=1e-6, atol=1e-6)


class _flags:
    """The same perf flags set in both packages for the block."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        from repro.sharding import flags as jflags
        from repro_torch.sharding import flags as tflags

        jflags.set_flags(**self.kw)
        tflags.set_flags(**self.kw)

    def __exit__(self, *exc):
        from repro.sharding import flags as jflags
        from repro_torch.sharding import flags as tflags

        jflags.reset_flags()
        tflags.reset_flags()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(300, 64), (128, 32), (40, 40)])
def test_chunked_scan_matches_jax_and_the_whole_scan(s, chunk, with_state):
    """``rglru_chunk``: a ragged last chunk (300 = 4·64 + 44), whole
    chunks, and S not above the chunk (the whole scan)."""
    cfg = get_reduced_config(ARCH)
    jcfg = jax_reduced_config(ARCH)
    jp, tp = _both(_params(cfg, seed=8))
    x = np.random.default_rng(9).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if with_state:
        h0, conv0 = _state(cfg, 2, 10)
        jst = jr.RGLRUState(jnp.asarray(h0), jnp.asarray(conv0))
        tst = tr.RGLRUState(_t(h0), _t(conv0))
    whole, whole_st = tr.rglru_apply(tp, _t(x), cfg, state=tst)
    with _flags(rglru_chunk=chunk):
        # a fresh jit: the flag is read while tracing
        want, wst = jax.jit(jr.rglru_apply, static_argnums=2)(
            jp, jnp.asarray(x), jcfg, jst)
        got, gst = tr.rglru_apply(tp, _t(x), cfg, state=tst)
    for a, b in ((got, _np(want)), (gst.h, _np(wst.h)),
                 (got, whole.numpy()), (gst.h, whole_st.h.numpy())):
        np.testing.assert_allclose(a.numpy(), b, rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_chunked_scan_gradient_matches_the_whole_scan():
    """Under autograd each chunk runs under ``torch.utils.checkpoint``:
    the gradients of Σ out·w with respect to x and the weights equal the
    whole scan's."""
    cfg = get_reduced_config(ARCH)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 150, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 150, cfg.d_model)).astype(np.float32)

    def grads():
        p = {k: _t(v).requires_grad_(True)
             for k, v in _params(cfg, seed=12).items()}
        xt = _t(x).requires_grad_(True)
        out, _ = tr.rglru_apply(p, xt, cfg)
        return torch.autograd.grad(torch.sum(out * _t(w)),
                                   [xt] + list(p.values()))

    whole = grads()
    with _flags(rglru_chunk=32):
        chunked = grads()
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_block_gate_init_matches_jax_shapes():
    """``rglru_block_gates``: 16 blocks of (W/16)² for w_a and w_i, the
    scale (W/16)^-1/2; a width 16 does not divide keeps full gates."""
    cfg = get_reduced_config(ARCH)
    jcfg = jax_reduced_config(ARCH)
    with _flags(rglru_block_gates=True):
        want = jr.init_rglru(jax.random.PRNGKey(0), jcfg, jnp.float32)
        got = tr.init_rglru(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
        odd = tr.init_rglru(torch.Generator().manual_seed(0),
                            get_reduced_config(ARCH, recurrent=type(
                                cfg.recurrent)(width=40)), torch.float32)
    w = cfg.recurrent.width
    for name in ("w_a", "w_i"):
        assert tuple(got[name].shape) == want[name].shape \
            == (16, w // 16, w // 16)
        assert odd[name].shape == (40, 40)
        # N(0, 1/bw): the sample's spread within a factor of 2
        assert 0.5 < float(got[name].std()) * (w // 16) ** 0.5 < 2.0
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_reduced_recurrentgemma_logits_with_both_flags_match_jax():
    """One 13-layer period of the reduced recurrentgemma, block-local
    gates drawn by the reference's init and chunks of 16 positions: the
    port's prefill logits on the converted weights against the
    reference's."""
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import build_model

    with _flags(rglru_block_gates=True, rglru_chunk=16):
        jcfg = jax_reduced_config(ARCH, n_layers=13)
        cfg = get_reduced_config(ARCH, n_layers=13)
        jm = jax_build_model(jcfg)
        pnp = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(1)))
        tok = np.random.default_rng(13).integers(
            0, cfg.vocab_size, (2, 40), dtype=np.int32)
        want, _ = jax.jit(jm.prefill)(
            jax.tree_util.tree_map(jnp.asarray, pnp),
            {"tokens": jnp.asarray(tok)})
        tp = model_params_from_numpy(cfg, pnp, "cpu")
        assert tuple(tp["layers"][0]["rglru"]["w_a"].shape) == (16, 4, 4)
        got, _ = build_model(cfg).prefill(tp, {"tokens":
                                               torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
