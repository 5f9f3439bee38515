"""The port's xLSTM blocks against the JAX reference, on the CPU.

The same seeded numpy weights, inputs and states go through
``repro.models.layers.xlstm`` and ``repro_torch.models.layers.xlstm`` on
the reduced xlstm-125m config (d_model 64, 2 heads of 16, chunk 16).  The
reduced model as a whole is held to the reference in
``tests/test_torch_encdec_vlm.py``, beside whisper and internvl2.

Tolerances:
  * TOL 1e-5 (rtol and atol) — the sLSTM scan, one decode step of either
    core, and the blocks' outputs: the same f32 formulas, products over
    d ≤ 64 in another order;
  * CHUNK_TOL 2e-5 (rtol and atol) — the mLSTM chunkwise outputs and
    carried state: each chunk's W × W products and the chunk-end sum
    Σ_s w_s v_s k_sᵀ run in another summation order, and h divides by
    max(|nᵀq|, e^{−m}), which can sit well below |C q| (outputs of order
    1–8 from unit inputs), so those ulps come out a few times larger;
    the chunkwise form against the step-by-step recurrence likewise.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import xlstm as jx  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models.layers import xlstm as tx  # noqa: E402

TOL = 1e-5
CHUNK_TOL = 2e-5
ARCH = "xlstm-125m"
_jax_chunkwise = jax.jit(jx.mlstm_chunkwise, static_argnums=2)
_jax_mdecode = jax.jit(jx.mlstm_decode_step, static_argnums=2)
_jax_slstm = jax.jit(jx.slstm_scan, static_argnums=2)
_jax_block = jax.jit(jx.xlstm_block_apply, static_argnums=(0, 3),
                     static_argnames="decode")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol, atol=tol)


def _cfgs():
    return get_reduced_config(ARCH), jax_reduced_config(ARCH)


def _params(kind, cfg, seed=0):
    """Seeded numpy weights with the JAX init's shapes and scales."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    H, dh = cfg.xlstm.n_heads, cfg.xlstm.head_dim
    inner = H * dh
    p = {"w_up": rng.normal(size=(d, d + inner)) * d ** -0.5,
         "w_down": rng.normal(size=(inner, d)) * inner ** -0.5}
    if kind == "mlstm":
        for name in ("wq", "wk", "wv"):
            p[name] = rng.normal(size=(d, inner)) * d ** -0.5
        p["wi"] = rng.normal(size=(d, H)) * d ** -0.5
        p["wf"] = rng.normal(size=(d, H)) * d ** -0.5 + 2.0
    else:
        p["w_gates"] = rng.normal(size=(d, 4 * inner)) * d ** -0.5
        p["r_gates"] = rng.normal(size=(H, dh, 4, dh)) * dh ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


def _state(kind, cfg, b, seed):
    """A nonzero incoming state (numpy), or the zero one for seed None."""
    H, dh = cfg.xlstm.n_heads, cfg.xlstm.head_dim
    if kind == "mlstm":
        shapes = ((b, H, dh, dh), (b, H, dh), (b, H))
        cls = (jx.MLSTMState, tx.MLSTMState)
    else:
        shapes = ((b, H, dh),) * 4
        cls = (jx.SLSTMState, tx.SLSTMState)
    if seed is None:
        arrays = [np.zeros(s, np.float32) for s in shapes]
    else:
        rng = np.random.default_rng(seed)
        arrays = [(0.5 * rng.normal(size=s)).astype(np.float32)
                  for s in shapes]
        if kind == "slstm":            # the normaliser n stays positive
            arrays[2] = np.abs(arrays[2]) + 0.5
    return (cls[0](*(jnp.asarray(a) for a in arrays)),
            cls[1](*(_t(a) for a in arrays)))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [32, 37, 5])
def test_mlstm_chunkwise_matches_jax(s, with_state):
    """S = 32 (two full chunks of 16), S = 37 (padded to 48 with
    state-neutral steps) and S = 5 (one chunk of 5), from the zero state
    and from a nonzero carried state: outputs and final (C, n, m)."""
    cfg, jcfg = _cfgs()
    jp, tp = _params("mlstm", cfg)
    a = _x(cfg, 2, s, 1)
    jst, tst = _state("mlstm", cfg, 2, 2 if with_state else None)
    want, wst = _jax_chunkwise(jp, jnp.asarray(a), jcfg.xlstm, jst)
    got, gst = tx.mlstm_chunkwise(tp, _t(a), cfg.xlstm, tst)
    _close(got, want, CHUNK_TOL)
    for g, w in zip(gst, wst):
        assert g.dtype == torch.float32
        _close(g, w, CHUNK_TOL)


def test_mlstm_padding_is_state_neutral():
    """The carried state of S = 37 (padded to 48) equals that of the
    same 37 steps run as chunks of 37 without padding."""
    cfg, _ = _cfgs()
    _, tp = _params("mlstm", cfg, seed=3)
    a = _t(_x(cfg, 2, 37, 4))
    _, st = _state("mlstm", cfg, 2, 5)
    _, padded = tx.mlstm_chunkwise(tp, a, cfg.xlstm, st)
    whole = dataclasses.replace(cfg.xlstm, chunk_size=37)
    _, unpadded = tx.mlstm_chunkwise(tp, a, whole, st)
    for g, w in zip(padded, unpadded):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=CHUNK_TOL,
                                   atol=CHUNK_TOL)


@pytest.mark.parametrize("steps", [1, 4])
def test_mlstm_decode_steps_match_jax(steps):
    cfg, jcfg = _cfgs()
    jp, tp = _params("mlstm", cfg, seed=6)
    jst, tst = _state("mlstm", cfg, 3, 7)
    a = _x(cfg, 3, steps, 8)
    for i in range(steps):
        want, jst = _jax_mdecode(jp, jnp.asarray(a[:, i:i + 1]), jcfg.xlstm,
                                 jst)
        got, tst = tx.mlstm_decode_step(tp, _t(a[:, i:i + 1]), cfg.xlstm, tst)
        _close(got, want, TOL)
        for g, w in zip(tst, jst):
            _close(g, w, TOL)


@pytest.mark.parametrize("s", [16, 37])
def test_mlstm_chunkwise_equals_the_recurrence(s):
    """The chunkwise form (outputs and carried state) against running
    ``mlstm_decode_step`` step by step from the same nonzero state."""
    cfg, _ = _cfgs()
    _, tp = _params("mlstm", cfg, seed=9)
    _, st = _state("mlstm", cfg, 2, 10)
    a = _t(_x(cfg, 2, s, 11))
    got, gst = tx.mlstm_chunkwise(tp, a, cfg.xlstm, st)
    outs = []
    for i in range(s):
        o, st = tx.mlstm_decode_step(tp, a[:, i:i + 1], cfg.xlstm, st)
        outs.append(o)
    np.testing.assert_allclose(got.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)
    for g, w in zip(gst, st):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=CHUNK_TOL,
                                   atol=CHUNK_TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 13, 40])
def test_slstm_scan_matches_jax(s, with_state):
    cfg, jcfg = _cfgs()
    jp, tp = _params("slstm", cfg, seed=12)
    a = _x(cfg, 2, s, 13)
    jst, tst = _state("slstm", cfg, 2, 14 if with_state else None)
    want, wst = _jax_slstm(jp, jnp.asarray(a), jcfg.xlstm, jst)
    got, gst = tx.slstm_scan(tp, _t(a), cfg.xlstm, tst)
    _close(got, want, TOL)
    for g, w in zip(gst, wst):
        _close(g, w, TOL)


def test_slstm_decode_continues_the_scan():
    """Decode steps after a scan of S tokens continue the scan of
    S + steps (the gate projection runs at M = 1 against M = S, another
    GEMM, so to TOL)."""
    cfg, _ = _cfgs()
    _, tp = _params("slstm", cfg, seed=15)
    a = _t(_x(cfg, 2, 24, 16))
    full, fst = tx.slstm_scan(tp, a, cfg.xlstm, _state("slstm", cfg, 2,
                                                       None)[1])
    _, st = tx.slstm_scan(tp, a[:, :20], cfg.xlstm,
                          _state("slstm", cfg, 2, None)[1])
    for i in range(20, 24):
        out, st = tx.slstm_decode_step(tp, a[:, i:i + 1], cfg.xlstm, st)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL, atol=TOL)
    for g, w in zip(st, fst):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# blocks, state and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("decode", [False, True])
def test_xlstm_block_matches_jax(kind, decode):
    """The up-projection split (a: d_model 64, g: H·dh 32), the core and
    the down projection; output and final state."""
    cfg, jcfg = _cfgs()
    jp, tp = _params(kind, cfg, seed=17)
    a = _x(cfg, 2, 1 if decode else 37, 18)
    jst, tst = _state(kind, cfg, 2, 19)
    want, wst = _jax_block(kind, jp, jnp.asarray(a), jcfg, jst,
                           decode=decode)
    got, gst = tx.xlstm_block_apply(kind, tp, _t(a), cfg, tst, decode=decode)
    tol = CHUNK_TOL if kind == "mlstm" and not decode else TOL
    _close(got, want, tol)
    for g, w in zip(gst, wst):
        _close(g, w, tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_state_dtypes_follow_the_reference(kind):
    """In bf16 the final state is cast to the activation dtype, except
    mLSTM's m (f32); the zero state starts m at 0.0."""
    cfg, jcfg = _cfgs()
    jp, tp = _params(kind, cfg, seed=20)
    zero = tx.init_xlstm_state(kind, 2, cfg, torch.bfloat16)
    jzero = jx.init_xlstm_state(kind, 2, jcfg, jnp.bfloat16)
    for g, w in zip(zero, jzero):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    a = _x(cfg, 2, 5, 21)
    jp16 = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp16 = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    _, wst = _jax_block(kind, jp16, jnp.asarray(a, jnp.bfloat16), jcfg,
                        jzero, decode=False)
    _, gst = tx.xlstm_block_apply(kind, tp16, _t(a).to(torch.bfloat16), cfg,
                                  zero, decode=False)
    for g, w in zip(gst, wst):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_xlstm_block_matches_jax_shapes(kind):
    cfg, jcfg = _cfgs()
    want = jx.init_xlstm_block(jax.random.PRNGKey(0), kind, jcfg,
                               jnp.float32)
    got = tx.init_xlstm_block(torch.Generator().manual_seed(0), kind, cfg,
                              torch.float32)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
    if kind == "mlstm":   # forget logits open around +2
        assert abs(float(got["wf"].mean()) - 2.0) < 0.2

