"""The port's LM serving slice against the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX functions and the port's
counterparts.  Model weights are the JAX init's, with the norm scales
and QKV biases (zeros at init) moved off zero by seeded numpy noise so
that those paths count; they cross as numpy arrays through
``repro_torch.convert.model_params_from_numpy``.  The JAX flash kernel
runs as the JAX package's own tests run it: in Pallas interpret mode,
and through its plain reference (what ``_backbone(impl="pallas")``
reaches on the CPU).

Tolerances:
  * FLASH_TOL — the flash plain version against the Pallas kernel in
    interpret mode: the JAX test's own (rtol = atol = 2e-5 in f32, 2e-2
    in bf16, where both round scores or probabilities to bf16 at other
    points);
  * TOL 1e-5 (rtol and atol) — f32 layers and attention paths against
    their JAX functions: the same formulas in another summation order
    (reductions over d ≤ 64 and S ≤ 64, values of order 1);
  * LOGIT_TOL 1e-4 — prefill and decode logits and caches of two-layer
    reduced models (errors of a few ε_f32 pass through the MLP, the
    tied or untied head and the residual stream; logits of order 1);
  * CONSIST_TOL 2e-2 — the port's prefill→decode consistency, the JAX
    test's own (``tests/test_models.py``) for the same check.
Sampled tokens must be identical: greedy, and top-k with the reference's
noise replayed through ``JaxKey``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import list_archs as jax_list_archs  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas,
)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref,
)
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers.mlp import mlp_apply as jax_mlp_apply  # noqa: E402
from repro.models.layers.norms import apply_norm as jax_apply_norm  # noqa: E402
from repro.models.layers.rotary import apply_rope as jax_apply_rope  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro_torch import serve_lm  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
)
from repro_torch.lm_serve import generate, sample_token  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers.mlp import mlp_apply  # noqa: E402
from repro_torch.models.layers.norms import apply_norm  # noqa: E402
from repro_torch.models.layers.rotary import apply_rope  # noqa: E402

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
TOL = 1e-5
LOGIT_TOL = 1e-4
CONSIST_TOL = 2e-2
# The dense archs, then the MoE archs and the RG-LRU hybrid.  The reduced
# recurrentgemma has 26 layers, two periods of 13; the JAX compile of its
# 13-block scan body dominates this file, so every check but
# test_prefill_and_decode_match_jax (which holds the two super-blocks'
# parameters and caches) runs it at one period, SHALLOW, on both sides.
SHALLOW = {"recurrentgemma-2b": 13}
ARCHS = ["h2o-danube-1.8b", "smollm-135m", "olmo-1b", "qwen2.5-14b",
         "grok-1-314b", "llama4-maverick-400b-a17b", "recurrentgemma-2b"]
# The xLSTM, encoder-decoder and VLM archs: their model checks live in
# tests/test_torch_xlstm.py and tests/test_torch_encdec_vlm.py.
SLICE10_ARCHS = ["xlstm-125m", "whisper-base", "internvl2-2b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
_split = jax.jit(jax.random.split, static_argnums=1)


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32):
    ``gumbel`` draws ``jax.random.gumbel``, the noise of
    ``jax.random.categorical``."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def gumbel(self, n, device):
        g = jax.random.gumbel(jnp.asarray(self.key), (n,), jnp.float32)
        return torch.from_numpy(np.array(g)).to(device)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _qkv(rng, b, sq, skv, h, hkv, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# kernel 8's plain version
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # sq, skv, h, hkv, d — the JAX test's sweep, D 80, ragged
    (128, 128, 4, 4, 32), (130, 200, 4, 2, 32), (64, 256, 8, 1, 64),
    (100, 157, 8, 2, 80),
]
FLASH_MASKS = [  # causal, window, softcap — the JAX test's
    (True, 0, 0.0), (True, 48, 0.0), (False, 0, 0.0), (True, 0, 20.0),
]


# f32 over every shape and mask; bf16 (interpret mode is slow) on the
# ragged GQA shape and on head_dim 80; then the edges of the card
# kernel's geometry (tests/test_torch_gpu.py holds it to this plain
# version there): GQA groups of 3 and 5, a window that ends on a block
# boundary, and ragged lengths past 128.
FLASH_CASES = [("f32", s, m) for s in FLASH_SHAPES for m in FLASH_MASKS] + [
    ("bf16", s, m) for s in (FLASH_SHAPES[1], FLASH_SHAPES[3])
    for m in FLASH_MASKS] + [
    ("f32", (70, 90, 6, 2, 32), (True, 0, 0.0)),
    ("f32", (70, 90, 10, 2, 32), (True, 48, 0.0)),
    ("f32", (130, 130, 4, 2, 32), (True, 64, 0.0)),
    ("f32", (129, 257, 4, 1, 32), (False, 0, 0.0))]


@pytest.mark.parametrize("prec,shape,mask", FLASH_CASES)
def test_flash_ref_matches_pallas_interpret(prec, shape, mask):
    """The plain version against the Pallas kernel (interpret mode) on
    the same inputs, through the JAX wrapper's padding and transposes."""
    (sq, skv, h, hkv, d), (causal, window, cap) = shape, mask
    rng = np.random.default_rng(sq * 7 + skv + d)
    q, k, v = _qkv(rng, 2, sq, skv, h, hkv, d)
    jdt, tdt = DTYPES[prec]
    want = jax_flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=causal, window=window, softcap=cap, block_q=64, block_kv=64,
        interpret=True)
    got = flash_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              causal=causal, window=window, softcap=cap)
    tol = FLASH_TOL[prec]
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (1, 100, 99, 0), (1, 100, 99, 16), (7, 64, 57, 0)])
def test_flash_q_offset_matches_pallas(prec, sq, skv, q_offset, window):
    """Decode-shaped calls: a few query rows at the end of the keys."""
    rng = np.random.default_rng(q_offset)
    q, k, v = _qkv(rng, 1, sq, skv, 4, 2, 32)
    jdt, tdt = DTYPES[prec]
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(a, jdt), 1, 2) for a in (q, k, v))
    pad = 64 - sq
    jq = jnp.pad(jq, ((0, 0), (0, 0), (0, pad), (0, 0)))
    kv_pad = -skv % 64
    jk = jnp.pad(jk, ((0, 0), (0, 0), (0, kv_pad), (0, 0)))
    jv = jnp.pad(jv, ((0, 0), (0, 0), (0, kv_pad), (0, 0)))
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  block_q=64, block_kv=64, q_offset=q_offset,
                                  skv_actual=skv, interpret=True)
    want = jnp.swapaxes(want[:, :, :sq], 1, 2)
    got = flash_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              causal=True, window=window, q_offset=q_offset)
    tol = FLASH_TOL[prec]
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_ref_matches_jax_ref(causal, window, cap):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 70, 90, 6, 3, 80)
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, softcap=cap,
                         q_offset=3)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              window=window, softcap=cap, q_offset=3)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain route and counts no launch."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 33, 40, 4, 2, 16))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=8)
    want = flash_attention_ref(q, k, v, causal=True, window=8)
    assert torch.equal(got, want)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric"])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_norms_match_jax(kind, prec):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    params = {"rmsnorm": {"scale": rng.normal(size=48) * 0.1},
              "layernorm": {"scale": 1 + rng.normal(size=48) * 0.1,
                            "bias": rng.normal(size=48) * 0.1},
              "nonparametric": None}[kind]
    jdt, tdt = DTYPES[prec]
    jp = tp = None
    if params is not None:
        jp = {n: jnp.asarray(a, jnp.float32) for n, a in params.items()}
        tp = {n: _t(a) for n, a in params.items()}
    want = jax_apply_norm(kind, jp, jnp.asarray(x, jdt))
    got = apply_norm(kind, tp, _t(x, tdt))
    assert got.dtype == tdt
    tol = TOL if prec == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("theta,scaling", [(10000.0, 1.0), (1e6, 4.0)])
def test_apply_rope_matches_jax(theta, scaling):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 3, 80)).astype(np.float32)
    pos = np.array([0, 1, 2, 7, 63, 64, 500, 4095, 8191])
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, scaling)
    got = apply_rope(_t(x), torch.from_numpy(pos), theta, scaling)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=1e-4)
    # decode's per-row positions (B, 1)
    pb = np.array([[5], [4100]])
    want = jax_apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(pb), theta,
                          scaling)
    got = apply_rope(_t(x[:, :1]), torch.from_numpy(pb), theta, scaling)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=1e-4)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("gelu", True)])
def test_mlp_matches_jax(act, gated):
    cfg = dataclasses.replace(get_reduced_config("smollm-135m"),
                              activation=act, gated_mlp=gated)
    rng = np.random.default_rng(4)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": rng.normal(size=(d, f)) * d ** -0.5,
         "w2": rng.normal(size=(f, d)) * f ** -0.5,
         "w3": rng.normal(size=(d, f)) * d ** -0.5}
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    want = jax_mlp_apply({n: jnp.asarray(a, jnp.float32)
                          for n, a in p.items()}, jnp.asarray(x), cfg)
    got = mlp_apply({n: _t(a) for n, a in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


ATTN_CASES = [  # sq, skv, h, hkv, causal, window, softcap, q_offset
    (20, 20, 4, 2, True, 0, 0.0, 0), (33, 33, 4, 1, True, 8, 0.0, 0),
    (17, 40, 6, 3, False, 0, 30.0, 0), (9, 30, 4, 4, True, 12, 0.0, 21),
]


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("sq,skv,h,hkv,causal,window,cap,q_offset",
                         ATTN_CASES)
def test_prefill_attention_matches_jax(impl, sq, skv, h, hkv, causal, window,
                                       cap, q_offset):
    rng = np.random.default_rng(sq + skv)
    q, k, v = _qkv(rng, 2, sq, skv, h, hkv, 16)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    if impl == "chunked":   # chunks smaller than S, ragged last chunk
        kw.update(q_chunk=8, kv_chunk=16)
    jfn, tfn = ((jattn.full_attention, tattn.full_attention)
                if impl == "full" else
                (jattn.chunked_attention, tattn.chunked_attention))
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tfn(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 20.0)])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.default_rng(6)
    b, c, h, hkv, d = 3, 12, 4, 2, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    cpos = np.array([np.arange(c), np.r_[np.arange(8), [-1] * 4],
                     np.arange(20, 20 + c) % c + 8], np.int32)
    pos = np.array([11, 7, 19], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(cpos),
                                  jnp.asarray(pos), window=window,
                                  softcap=cap)
    got = tattn.decode_attention(_t(q), _t(kc), _t(vc),
                                 torch.from_numpy(cpos),
                                 torch.from_numpy(pos), window=window,
                                 softcap=cap)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_ring_cache_update_matches_jax_and_linear():
    """Ring and linear caches through both packages' ``cache_update``:
    the same slots and positions as the reference, and windowed decode
    over the ring equals decode over the linear cache."""
    rng = np.random.default_rng(7)
    b, hkv, dh, window, steps = 2, 2, 16, 8, 20
    jring = jattn.init_kv_cache(b, window, hkv, dh, jnp.float32)
    tring = tattn.init_kv_cache(b, window, hkv, dh, torch.float32)
    tlin = tattn.init_kv_cache(b, steps, hkv, dh, torch.float32)
    for t in range(steps):
        kn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        qn = rng.normal(size=(b, 1, 4, dh)).astype(np.float32)
        pos = np.full((b,), t, np.int32)
        jring = jattn.cache_update(jring, jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(pos))
        tpos = torch.from_numpy(pos)
        tring = tattn.cache_update(tring, _t(kn), _t(vn), tpos)
        tlin = tattn.cache_update(tlin, _t(kn), _t(vn), tpos)
        for a, want in zip(tring, jring):
            np.testing.assert_array_equal(a.numpy(), np.asarray(want))
        outs = [tattn.decode_attention(_t(qn), c.k, c.v, c.positions, tpos,
                                       window=window, softcap=0.0)
                for c in (tring, tlin)]
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# configs and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + SLICE10_ARCHS)
def test_configs_equal_the_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))
    assert (dataclasses.asdict(get_reduced_config(arch))
            == dataclasses.asdict(jax_reduced_config(arch)))


@pytest.mark.parametrize("arch", jax_list_archs())
def test_every_reference_arch_builds(arch):
    """Every arch of the reference's registry builds, at published and
    reduced width, with the reference's block kinds."""
    for cfg in (get_config(arch), get_reduced_config(arch)):
        model = build_model(cfg)
        assert model.cfg == cfg
        assert [model.kind(i) for i in range(cfg.n_layers)] == [
            cfg.block_pattern[i % cfg.pattern_period]
            for i in range(cfg.n_layers)]
    assert sorted(list_archs()) == sorted(jax_list_archs())


def test_unknown_block_kinds_are_refused():
    cfg = get_reduced_config("smollm-135m")
    with pytest.raises(ValueError, match="unknown block kind"):
        build_model(dataclasses.replace(cfg, block_pattern=("attn", "mamba"),
                                        n_layers=2))


def _perturb(params_np, seed):
    """The JAX init's tree with norm scales, norm biases and QKV biases
    (zeros or ones at init) moved by seeded noise."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("scale", "bias", "bq", "bk", "bv"):
            return a + (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params_np)


def _models(arch, seed=0, shallow=True):
    """(JAX model, JAX params, port model, port params) of the reduced
    arch on the same weights (``SHALLOW`` layers deep when ``shallow``)."""
    kw = ({"n_layers": SHALLOW[arch]} if shallow and arch in SHALLOW
          else {})
    jcfg = jax_reduced_config(arch, **kw)
    jm = jax_build_model(jcfg)
    pnp = _perturb(jax.tree_util.tree_map(np.asarray,
                                          jm.init(jax.random.PRNGKey(seed))),
                   seed)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    cfg = get_reduced_config(arch, **kw)
    return jm, jp, build_model(cfg), model_params_from_numpy(cfg, pnp, "cpu")


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _assert_caches(tcache, jcache, tol=LOGIT_TOL):
    """Layer i's cache (KV or RG-LRU state) against pattern position
    i % period of the reference's, at super-block i // period; slot
    positions exactly."""
    jl = jcache["layers"]
    period = len(jl)
    np.testing.assert_array_equal(tcache["step_offset"].numpy(),
                                  np.asarray(jcache["step_offset"]))
    for i, c in enumerate(tcache["layers"]):
        want = jl[i % period]
        assert type(c).__name__ == type(want).__name__
        for name, got in c._asdict().items():
            w = np.asarray(getattr(want, name)[i // period])
            if name == "positions":
                np.testing.assert_array_equal(got.numpy(), w)
            else:
                np.testing.assert_allclose(got.numpy(), _np(w), rtol=tol,
                                           atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [16, 48])
def test_prefill_and_decode_match_jax(arch, s):
    """Prefill logits and caches, then three decode steps' logits and
    caches.  At s = 48 danube's window-32 cache is a ring (prefill keeps
    the last 32 positions), the others' linear caches hold s + 64;
    recurrentgemma's 26 layers, two super-blocks of its 13-kind period."""
    jm, jp, tm, tp = _models(arch, shallow=False)
    tok = _tokens(tm.cfg, 2, s)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _assert_caches(tcache, jcache)
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        nxt = _tokens(tm.cfg, 2, 1, seed=10 + i)
        pos = np.full((2,), s + i, np.int32)
        jlog, jcache = jdec(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    _assert_caches(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jimpl,timpl", [("pallas", "kernel"),
                                         ("full", "kernel"),
                                         ("chunked", "chunked")])
def test_backbone_impls_match_jax(arch, jimpl, timpl):
    """``_backbone`` per attention path: the port's ``kernel`` (its plain
    version on the CPU, the port's ``full``) against the reference's
    ``pallas`` (its plain reference on the CPU) and ``full``, and
    ``chunked`` against the reference's."""
    jm, jp, tm, tp = _models(arch)
    x = np.random.default_rng(8).normal(
        size=(2, 40, tm.cfg.d_model)).astype(np.float32)
    jx, _, _ = jm._backbone(jp, jnp.asarray(x), impl=jimpl,
                            collect_cache=False)
    tx, _, _ = tm._backbone(tp, _t(x), impl=timpl)
    np.testing.assert_allclose(tx.numpy(), _np(jx), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_long_prefill_takes_chunked_path_and_matches_jax():
    """Above 1024 tokens both packages prefill through ``chunked`` on the
    CPU; danube's ring cache keeps the last 32 positions."""
    jm, jp, tm, tp = _models("h2o-danube-1.8b")
    tok = _tokens(tm.cfg, 1, 1030)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _assert_caches(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's prefill → decode consistency (``tests/test_models.py``):
    decoding token s−1 from the cache of s−1 tokens gives the last logits
    of prefilling all s; at s = 48 danube's and recurrentgemma's caches
    are rings.  An MoE's capacity cut depends on how many tokens a call
    routes (the reference leaves the MoE archs out of this check), so
    they run at a capacity factor of E, where no assignment is dropped."""
    _, _, tm, tp = _models(arch)
    if tm.cfg.moe is not None:
        moe = dataclasses.replace(tm.cfg.moe,
                                  capacity_factor=float(tm.cfg.moe.n_experts))
        tm = build_model(dataclasses.replace(tm.cfg, moe=moe))
    s = 48
    tok = torch.from_numpy(_tokens(tm.cfg, 1, s))
    want, _ = tm.prefill(tp, {"tokens": tok})
    _, cache = tm.prefill(tp, {"tokens": tok[:, :-1]})
    got, _ = tm.decode_step(tp, cache, tok[:, -1:],
                            torch.full((1,), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CONSIST_TOL,
                               atol=CONSIST_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 40)])
def test_generate_matches_jax(arch, temperature, top_k):
    """Greedy tokens identical; top-k tokens identical with the
    reference's noise (``JaxKey`` over its default key, PRNGKey(0))."""
    jm, jp, tm, tp = _models(arch)
    tok = _tokens(tm.cfg, 2, 40)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(tok)}, 8,
                        temperature=temperature, top_k=top_k)
    got = generate(tm, tp, {"tokens": torch.from_numpy(tok)}, 8,
                   JaxKey(jax.random.PRNGKey(0)), temperature=temperature,
                   top_k=top_k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_token_top_k_filter():
    """Only the top k logits can be drawn, over the padded vocab."""
    logits = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    draws = {int(t) for s in range(40) for t in sample_token(
        logits, JaxKey(jax.random.PRNGKey(s)), temperature=1.0, top_k=3)}
    assert draws <= {9, 10, 11, 21, 22, 23}
    assert sample_token(logits, None).tolist() == [11, 11]


class _StubLM:
    V = 11

    def prefill(self, params, batch):
        b = batch["tokens"].shape[0]
        logits = torch.arange(self.V, dtype=torch.float32).repeat(b, 1)
        return logits, {"step_offset": torch.zeros((), dtype=torch.int32)}

    def decode_step(self, params, cache, tokens, pos):
        return self.prefill(params, {"tokens": tokens})[0], cache


@pytest.mark.parametrize("deadline", [None, 2.5])
def test_generate_deadline_bounds_decode_loop(deadline):
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    out = generate(_StubLM(), {}, {"tokens": torch.zeros((2, 3))}, 6,
                   deadline_s=deadline, clock=clock, device="cpu")
    # t0 = 1; checks at t = 2, 3, 4: the third trips after 2 decode steps
    assert out.shape == ((2, 6) if deadline is None else (2, 3))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, generate and serve_lm raise unless asked for the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(_StubLM(), {}, {"tokens": torch.zeros((1, 2))}, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(verbose=False)


@pytest.mark.parametrize("arch,n_layers", [("grok-1-314b", 1),
                                           ("recurrentgemma-2b", 13)])
def test_serve_lm_cuts_depth(arch, n_layers):
    """``n_layers`` cuts the depth and keeps the widths; a depth that is
    not a multiple of the pattern period is refused."""
    out = serve_lm.main(arch, batch=2, prompt_len=40, new_tokens=3,
                        n_layers=n_layers, device="cpu", verbose=False)
    assert out["cfg"].n_layers == n_layers == len(out["params"]["layers"])
    assert out["cfg"].d_model == get_reduced_config(arch).d_model
    assert out["tokens"].shape == (2, 3)
    with pytest.raises(ValueError, match="period"):
        serve_lm.main(arch, n_layers=n_layers + 1 if n_layers > 1 else 0,
                      device="cpu", verbose=False)


def test_serve_lm_cpu_entry_point():
    out = serve_lm.main(device="cpu", new_tokens=6, verbose=False)
    cfg = out["cfg"]
    assert out["tokens"].shape == (4, 6)
    assert out["tokens"].dtype == torch.int32
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.padded_vocab
    assert out["prefill_s"] > 0 and out["decode_s_per_token"] > 0
