"""The port's encoder-decoder (whisper-base) and image-token prefix
(internvl2-2b) against the JAX reference on the CPU, and the three archs
of the port's slice 10 (with xlstm-125m) as whole reduced models.

The same seeded numpy inputs go through the JAX functions and the port's
counterparts; model weights are the JAX init's with the norm scales and
biases moved off their init values (``tests/test_torch_lm.py``'s
``_models``), carried across by ``model_params_from_numpy``.

Tolerances (``tests/test_torch_lm.py``'s):
  * TOL 1e-5 (rtol and atol) — the cross-attention and the image
    projection: the same f32 formulas in another summation order;
  * LOGIT_TOL 1e-4 — the encoder's output (two layers of attention and
    MLP), prefill and decode logits and caches of the reduced models;
  * XLSTM_TOL 5e-4 — the same for the reduced xlstm-125m (8 layers):
    its mLSTM divides by max(|nᵀq|, e^{−m}) and each layer passes
    rounding on 2–3× amplified, so the reference's own logits move by
    up to 4.5e-4 when its weights get half an ulp of seeded noise
    (measured on the CPU over the 8 decode steps below); the port, whose
    products sum in another order, lands within 2.2e-4 of them.
Greedy tokens must be identical; top-k tokens too, with the reference's
noise replayed through ``JaxKey``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import transformer as jtransformer  # noqa: E402
from repro.train.serve import generate as jax_generate  # noqa: E402
from repro_torch import serve_lm  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.lm_serve import generate  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from test_torch_lm import (  # noqa: E402
    CONSIST_TOL,
    LOGIT_TOL,
    TOL,
    JaxKey,
    _assert_caches,
    _models,
    _np,
    _t,
    _tokens,
)

ARCHS = ["xlstm-125m", "whisper-base", "internvl2-2b"]
XLSTM_TOL = 5e-4


def _logit_tol(arch):
    return XLSTM_TOL if arch == "xlstm-125m" else LOGIT_TOL


def _batch(cfg, b, s, seed=3):
    """Tokens, and the image embeddings or encoder frames the arch
    takes (numpy)."""
    rng = np.random.default_rng(seed + 100)
    batch = {"tokens": _tokens(cfg, b, s, seed)}
    if cfg.vision is not None:
        batch["img_embeds"] = rng.normal(size=(
            b, cfg.vision.n_img_tokens, cfg.vision.embed_dim)).astype(
                np.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = rng.normal(size=(
            b, cfg.encoder.src_len, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# whisper: the encoder, cross-attention and the cache's enc_out
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    """Two encoder layers (RoPE'd bidirectional attention, MLP) and the
    final norm over 16 frames."""
    jm, jp, tm, tp = _models("whisper-base")
    frames = _batch(tm.cfg, 2, 4)["enc_frames"]
    want = jax.jit(jm._encode)(jp, jnp.asarray(frames))
    got = tm._encode(tp, _t(frames))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_encoder_attention_is_bidirectional():
    """A change to the last frame reaches the first frame's output."""
    _, _, tm, tp = _models("whisper-base")
    frames = _t(_batch(tm.cfg, 1, 4)["enc_frames"])
    base = tm._encode(tp, frames)
    frames[:, -1] = torch.flip(frames[:, -1], dims=[-1])
    assert float((tm._encode(tp, frames) - base)[:, 0].abs().max()) > 1e-3


@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attn_matches_jax(sq):
    """No RoPE, non-causal, Sq ≠ Skv (decode's Sq = 1 too); layer 0's
    weights."""
    jm, jp, tm, tp = _models("whisper-base")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, sq, tm.cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, tm.cfg.encoder.src_len,
                           tm.cfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0])
    want = jtransformer._apply_cross_attn(jlayer, jnp.asarray(x),
                                          jnp.asarray(enc), jm.cfg)
    got = transformer._apply_cross_attn(tp["layers"][0], _t(x), _t(enc),
                                        tm.cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_prefill_cache_holds_enc_out_and_step_offset():
    """prefill stores the encoder's output and S in the cache; init_cache
    holds a zero enc_out of (B, src_len, D)."""
    jm, jp, tm, tp = _models("whisper-base")
    batch = _batch(tm.cfg, 2, 9)
    _, jcache = jax.jit(jm.prefill)(jp, _jb(batch))
    _, tcache = tm.prefill(tp, _tb(batch))
    np.testing.assert_allclose(tcache["enc_out"].numpy(),
                               _np(jcache["enc_out"]), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert tcache["step_offset"].tolist() == [9, 9]
    zero = tm.init_cache(3, 20)["enc_out"]
    jzero = jm.init_cache(3, 20)["enc_out"]
    assert tuple(zero.shape) == jzero.shape and not bool(zero.any())


def test_decode_reads_enc_out_from_the_cache():
    """A decode step with the cache's enc_out zeroed gives other logits
    (the cross-attention reads it at every step)."""
    _, _, tm, tp = _models("whisper-base")
    batch = _tb(_batch(tm.cfg, 2, 9))
    _, cache = tm.prefill(tp, batch)
    tok = batch["tokens"][:, :1]
    pos = cache["step_offset"]
    clone = {"layers": [type(c)(*(t.clone() for t in c))
                        for c in cache["layers"]],
             "step_offset": pos, "enc_out": torch.zeros_like(
                 cache["enc_out"])}
    got, _ = tm.decode_step(tp, cache, tok, pos)
    zeroed, _ = tm.decode_step(tp, clone, tok, pos)
    assert float((got - zeroed).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# internvl2: the image-token prefix
# ---------------------------------------------------------------------------

def test_image_prefix_matches_jax():
    """img_embeds @ img_proj in front of the text embeddings: the
    cache's positions count the prefix (step_offset = S + 4, linear
    caches of S + 4 + 64 slots), and the logits need it."""
    jm, jp, tm, tp = _models("internvl2-2b")
    batch = _batch(tm.cfg, 2, 11)
    x, enc = tm._inputs(tp, _tb(batch))
    img = batch["img_embeds"] @ _np(jp["img_proj"])
    assert enc is None and tuple(x.shape) == (2, 4 + 11, tm.cfg.d_model)
    np.testing.assert_allclose(x[:, :4].numpy(), img, rtol=TOL, atol=TOL)
    jlog, jcache = jax.jit(jm.prefill)(jp, _jb(batch))
    tlog, tcache = tm.prefill(tp, _tb(batch))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _assert_caches(tcache, jcache)
    assert tcache["step_offset"].tolist() == [15, 15]
    assert tcache["layers"][0].k.shape[1] == 15 + 64
    blank = dict(_tb(batch), img_embeds=torch.zeros(2, 4, 64))
    assert float((tm.prefill(tp, blank)[0] - tlog).abs().max()) > 1e-3


def test_long_prefill_counts_the_prefix(monkeypatch):
    """On the CPU the prefix counts toward the 1024 positions past which
    both packages prefill through ``chunked``: 1021 tokens + 4 image
    tokens take it, and match the reference."""
    jm, jp, tm, tp = _models("internvl2-2b")
    calls = []
    real = tattn.chunked_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "chunked_attention", spy)
    batch = _batch(tm.cfg, 1, 1021)
    jlog, _ = jax.jit(jm.prefill)(jp, _jb(batch))
    tlog, _ = tm.prefill(tp, _tb(batch))
    assert calls == [1025] * tm.cfg.n_layers
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the three archs as reduced models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and caches (xLSTM states, KV caches, enc_out), then
    8 decode steps' logits, and the caches after them."""
    jm, jp, tm, tp = _models(arch)
    tol = _logit_tol(arch)
    batch = _batch(tm.cfg, 2, 37)
    jlog, jcache = jax.jit(jm.prefill)(jp, _jb(batch))
    tlog, tcache = tm.prefill(tp, _tb(batch))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=tol, atol=tol)
    _assert_caches(tcache, jcache, tol)
    jdec = jax.jit(jm.decode_step)
    s0 = int(tcache["step_offset"][0])
    for i in range(8):
        nxt = _tokens(tm.cfg, 2, 1, seed=10 + i)
        pos = np.full((2,), s0 + i, np.int32)
        jlog, jcache = jdec(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=tol,
                                   atol=tol)
    _assert_caches(tcache, jcache, tol)
    if tm.cfg.is_encdec:
        np.testing.assert_allclose(tcache["enc_out"].numpy(),
                                   _np(jcache["enc_out"]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Decoding token S − 1 from the cache of S − 1 tokens gives the last
    logits of prefilling all S (``tests/test_torch_lm.py``'s check, its
    tolerance CONSIST_TOL): the xLSTM states, the encoder's output and
    the image prefix carried through the cache."""
    _, _, tm, tp = _models(arch)
    batch = _tb(_batch(tm.cfg, 1, 40))
    want, _ = tm.prefill(tp, batch)
    _, cache = tm.prefill(tp, dict(batch, tokens=batch["tokens"][:, :-1]))
    got, _ = tm.decode_step(tp, cache, batch["tokens"][:, -1:],
                            cache["step_offset"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CONSIST_TOL,
                               atol=CONSIST_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 40)])
def test_generate_matches_jax(arch, temperature, top_k):
    """The whole batch (image embeddings, encoder frames) passes through
    ``generate``; tokens identical."""
    jm, jp, tm, tp = _models(arch)
    batch = _batch(tm.cfg, 2, 40)
    want = jax_generate(jm, jp, _jb(batch), 8, temperature=temperature,
                        top_k=top_k)
    got = generate(tm, tp, _tb(batch), 8, JaxKey(jax.random.PRNGKey(0)),
                   temperature=temperature, top_k=top_k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    """Every leaf of the reference's tree lands in the port's params, its
    values exactly (stacked blocks and enc_blocks split per layer), and
    the port's own init has the same tree of shapes."""
    jm, jp, tm, tp = _models(arch)
    pnp = jax.tree_util.tree_map(np.asarray, jp)
    period = jm.cfg.pattern_period
    n_ref = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(pnp)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        n_ref += leaf.size
        if keys[0] == "blocks":
            for s in range(leaf.shape[0]):
                got = tp["layers"][s * period + keys[1]]
                for k in keys[2:]:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(), leaf[s])
        elif keys[0] == "enc_blocks":
            for s in range(leaf.shape[0]):
                got = tp["enc_layers"][s]
                for k in keys[1:]:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(), leaf[s])
        else:
            got = tp
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), leaf)
    flat = jax.tree_util.tree_leaves(tp)
    assert sum(t.numel() for t in flat) == n_ref
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), (own, tp))
    assert shapes[0] == shapes[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_cpu_entry_point(arch):
    """``serve_lm`` draws the image embeddings or encoder frames the
    arch takes and returns the whole batch."""
    out = serve_lm.main(arch, batch=2, prompt_len=12, new_tokens=4,
                        device="cpu", verbose=False)
    cfg, batch = out["cfg"], out["batch"]
    assert out["tokens"].shape == (2, 4)
    assert torch.equal(batch["tokens"], out["prompt"])
    assert ("img_embeds" in batch) == (cfg.vision is not None)
    assert ("enc_frames" in batch) == cfg.is_encdec
    if cfg.vision is not None:
        assert tuple(batch["img_embeds"].shape) == (
            2, cfg.vision.n_img_tokens, cfg.vision.embed_dim)
    if cfg.is_encdec:
        assert tuple(batch["enc_frames"].shape) == (
            2, cfg.encoder.src_len, cfg.d_model)
    assert build_model(get_reduced_config(arch)).cfg == cfg
