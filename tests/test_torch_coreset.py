"""The port's coreset objective and feature extraction against the JAX
reference, on the CPU.

The same seeded numpy inputs go through both packages.  The random
projection is drawn through the key: ``JaxKey.normal`` replays the
reference's ``jax.random.normal`` draw, so both packages project with
the same R bit for bit.  LM weights are the JAX init's, moved across
with ``repro_torch.convert.model_params_from_numpy``.

Tolerances:
  * PROJ_TOL 1e-6 (rtol and atol) — the prepared columns: the same
    R, then one f32 product over feat_dim ≤ 160 and a row norm, summed
    in another order by XLA and by PyTorch (entries of order 0.1–1);
    without the projection only the row norm's order differs;
  * LOGIT_TOL 1e-4 — pooled features of two-layer reduced models,
    ``tests/test_torch_lm.py``'s tolerance for their logits;
  * VAL_RTOL 1e-5 — A-optimal values and DASH values.
"""

import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.core.objectives import coreset as jcoreset  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import EncoderConfig, VisionConfig  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core import SeedKey  # noqa: E402
from repro_torch.core.distributed import pad_ground_set  # noqa: E402
from repro_torch.core.objectives import coreset as tcoreset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

jdash = importlib.import_module("repro.core.dash")
tdash = importlib.import_module("repro_torch.core.dash")

PROJ_TOL = 1e-6
LOGIT_TOL = 1e-4
VAL_RTOL = 1e-5

_split = jax.jit(jax.random.split, static_argnums=1)
_gumbel = jax.jit(jest.gumbel_noise, static_argnums=1)


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32),
    with ``normal`` for the random projection."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def gumbel(self, n, device):
        return torch.from_numpy(np.array(_gumbel(self.key, n))).to(device)

    def normal(self, shape, device):
        z = np.array(jax.random.normal(self.key, tuple(shape)))
        return torch.from_numpy(z).to(device)


def _feats(pool=50, dim=160, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(pool, dim)) * rng.uniform(0.1, 5.0, (pool, 1))
            ).astype(np.float32)


def test_key_normal_replays_reference():
    key = jax.random.PRNGKey(4)
    got = JaxKey(key).normal((7, 3), "cpu").numpy()
    np.testing.assert_array_equal(got, np.array(jax.random.normal(key, (7, 3))))
    a, b = SeedKey(9).normal((5, 4), "cpu"), SeedKey(9).normal((5, 4), "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, SeedKey(10).normal((5, 4), "cpu"))


@pytest.mark.parametrize("dim,cap", [(160, 64), (40, 64)])
def test_prepare_feature_columns_matches(dim, cap):
    """With the projection (feat_dim 160 > cap 64) and without (40)."""
    feats = _feats(dim=dim)
    key = jax.random.PRNGKey(3)
    want = np.array(jcoreset.prepare_feature_columns(
        jnp.asarray(feats), dim_cap=cap, key=key))
    got = tcoreset.prepare_feature_columns(feats, dim_cap=cap,
                                           key=JaxKey(key)).numpy()
    assert got.shape == want.shape == (min(dim, cap), 50)
    np.testing.assert_allclose(got, want, rtol=PROJ_TOL, atol=PROJ_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-6)


def test_from_features_pads_and_keeps_n_real():
    feats = _feats(pool=50)
    key = jax.random.PRNGKey(3)
    want = jcoreset.CoresetObjective.from_features(
        jnp.asarray(feats), 8, dim_cap=32, key=key, pad_multiple=16)
    got = tcoreset.CoresetObjective.from_features(
        feats, 8, dim_cap=32, key=JaxKey(key), pad_multiple=16,
        device="cpu")
    assert (got.n, got.n_real, got.d) == (want.n, want.n_real, want.d) \
        == (64, 50, 32)
    np.testing.assert_allclose(got.X.numpy(), np.array(want.X),
                               rtol=PROJ_TOL, atol=PROJ_TOL)
    assert not got.X[:, 50:].any()
    Xp, n = pad_ground_set(torch.ones((2, 48)), 16)
    assert n == 48 and Xp.shape == (2, 48)
    plain = tcoreset.CoresetObjective(got.X[:, :50], 8, device="cpu")
    assert plain.n_real == plain.n == 50


def test_coreset_dash_matches_reference():
    """DASH on a coreset objective (the filter engine of A-optimality)
    guess by guess, and its value against the explicit-inverse oracle."""
    feats = _feats(pool=80)
    key = jax.random.PRNGKey(5)
    jobj = jcoreset.CoresetObjective.from_features(
        jnp.asarray(feats), 10, dim_cap=16, key=key)
    tobj = tcoreset.CoresetObjective.from_features(
        feats, 10, dim_cap=16, key=JaxKey(key), device="cpu")
    kw = dict(eps=0.25, alpha=0.6, n_samples=4, n_guesses=3,
              return_lattice=True)
    _, wl = jdash.dash_auto(jobj, 10, key, **kw)
    best, gl = tdash.dash_auto(tobj, 10, JaxKey(key), device="cpu", **kw)
    for g in range(3):
        assert (np.flatnonzero(gl.sel_mask[g].numpy()).tolist()
                == np.flatnonzero(np.array(wl.sel_mask[g])).tolist()), g
        np.testing.assert_allclose(float(gl.value[g]), float(wl.value[g]),
                                   rtol=VAL_RTOL)
    idx = np.flatnonzero(best.sel_mask.numpy())
    np.testing.assert_allclose(float(tobj.brute_value(idx)),
                               float(best.value), rtol=1e-4)


# ---------------------------------------------------------------------------
# coreset_features on the reduced dense archs
# ---------------------------------------------------------------------------

def _models(arch, seed=0):
    """(JAX model, JAX params, port model, port params) on the same
    weights."""
    jm = jax_build_model(jax_reduced_config(arch))
    pnp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    cfg = get_reduced_config(arch)
    return (jm, jax.tree_util.tree_map(jnp.asarray, pnp), build_model(cfg),
            model_params_from_numpy(cfg, pnp, "cpu"))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "smollm-135m"])
@pytest.mark.parametrize("mode", ["embed", "hidden", "grad"])
def test_coreset_features_match(arch, mode):
    """All three modes on a reduced untied (danube) and tied (smollm)
    arch: batch 3, 40 tokens (past danube's reduced window of 32)."""
    jm, jp, tm, tp = _models(arch)
    tok = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (3, 40),
                                            dtype=np.int32)
    want = np.array(jcoreset.coreset_features(
        jm, jp, {"tokens": jnp.asarray(tok)}, mode=mode), np.float32)
    got = tcoreset.coreset_features(tm, tp, {"tokens": torch.from_numpy(tok)},
                                    mode=mode)
    assert got.dtype == torch.float32 and got.shape == (3, tm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_coreset_features_refuses():
    _, _, tm, tp = _models("smollm-135m")
    tok = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="mode"):
        tcoreset.coreset_features(tm, tp, tok, mode="logits")
    for extra in ({"vision": VisionConfig(n_img_tokens=4, embed_dim=64)},
                  {"encoder": EncoderConfig(n_layers=1, src_len=8, d_ff=64)}):
        stub = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg,
                                                               **extra))
        with pytest.raises(NotImplementedError, match="embed"):
            tcoreset.coreset_features(stub, tp, tok, mode="grad")
        emb = tcoreset.coreset_features(stub, tp, tok, mode="embed")
        assert emb.shape == (1, tm.cfg.d_model)
