"""The port's DASH, greedy and baselines against the JAX reference.

The port never imports JAX, so its randomness comes through a key
object.  ``JaxKey`` below wraps ``jax.random.split`` and the reference's
``gumbel_noise``: handed to the port, it replays the reference's exact
noise, and the two trajectories can be compared decision by decision.
Tolerances: 1e-4 on values (f32 sums in another order; DASH compares raw
f32 estimates against thresholds).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import functools  # noqa: E402
import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import estimators as jest  # noqa: E402
from repro.core import selection_loop as jloop  # noqa: E402
from repro.core.baselines import random_select as jax_random_select  # noqa: E402
from repro.core.baselines import top_k_select as jax_top_k_select  # noqa: E402
from repro.core.greedy import greedy as jax_greedy  # noqa: E402
from repro.core.objectives import RegressionObjective as JaxRegression  # noqa: E402
from repro_torch.convert import objective_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core import baselines, estimators as test_  # noqa: E402
from repro_torch.core import selection_loop as tloop  # noqa: E402
from repro_torch.core.greedy import greedy  # noqa: E402
from repro_torch.data.synthetic import make_d1_regression  # noqa: E402

# The packages export functions named like these modules.
jdash = importlib.import_module("repro.core.dash")
tdash = importlib.import_module("repro_torch.core.dash")

VAL_TOL = 1e-4
_split = jax.jit(jax.random.split, static_argnums=1)
_gumbel = jax.jit(jest.gumbel_noise, static_argnums=1)


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32)."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def gumbel(self, n, device):
        return torch.from_numpy(np.array(_gumbel(self.key, n))).to(device)


@functools.lru_cache(maxsize=None)
def _d1(d=600, n=200, support=40):
    return make_d1_regression(seed=0, n_samples=d, n_features=n,
                              support=support)


def _pair(k=40, **kw):
    X, y, _ = _d1(**kw)
    return (JaxRegression(jnp.asarray(X), jnp.asarray(y), kmax=k),
            objective_from_numpy(X, y, k, device="cpu"))


def _np(x):
    return np.array(x)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def test_sample_set_from_mask_matches():
    rng = np.random.default_rng(0)
    masks = rng.uniform(size=(3, 50)) < np.array([[0.5], [0.05], [1.0]])
    keys = _np(jax.random.split(jax.random.PRNGKey(3), 3))
    idx, valid = test_.sample_set_from_mask(
        [JaxKey(k) for k in keys], torch.from_numpy(masks), 6)
    for g in range(3):
        wi, wv = jest.sample_set_from_mask(keys[g], jnp.asarray(masks[g]), 6)
        np.testing.assert_array_equal(valid[g].numpy(), _np(wv))
        np.testing.assert_array_equal(idx[g].numpy()[_np(wv)], _np(wi)[_np(wv)])


def test_sample_set_batch_trimmed_mean_argmax():
    mask = np.random.default_rng(1).uniform(size=(1, 80)) < 0.6
    key = jax.random.PRNGKey(8)
    idx, valid = test_.sample_set_batch([JaxKey(key)], torch.from_numpy(mask),
                                        5, 7)
    wi, wv = jest.sample_set_batch(key, jnp.asarray(mask[0]), 5, 7)
    np.testing.assert_array_equal(idx[0].numpy(), _np(wi))
    np.testing.assert_array_equal(valid[0].numpy(), _np(wv))
    vals = np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32)
    for frac in (0.0, 0.2):
        np.testing.assert_allclose(
            test_.trimmed_mean(torch.from_numpy(vals), frac).numpy(),
            _np(jest.trimmed_mean(jnp.asarray(vals), frac)), rtol=1e-6)
    v = np.array([1.0, 3.0, 3.0, 2.0], np.float32)
    m = np.array([True, False, True, True])
    assert int(test_.masked_argmax(torch.from_numpy(v), torch.from_numpy(m))) \
        == int(jest.masked_argmax(jnp.asarray(v), jnp.asarray(m))) == 2


# ---------------------------------------------------------------------------
# one round from the same carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sel,alpha", [([], 0.6), ([2, 50, 101], 0.9)])
def test_round_body_matches(sel, alpha):
    jobj, tobj = _pair(k=20, d=200, n=120)
    cfg = jloop.DashConfig(k=20, eps=0.25, alpha=alpha,
                           n_samples=6).resolve(jobj.n)
    st = jobj.init()
    if sel:
        st = jobj.add_set(st, jnp.asarray(sel, jnp.int32),
                          jnp.ones(len(sel), bool))
    alive = ~st.sel_mask
    opt = float(jnp.max(jobj.gains(jobj.init()))) * 6.0
    key = jax.random.PRNGKey(5)
    want = jloop.make_round_body(jdash._single_device_hooks(jobj, cfg), cfg)(
        0, jloop.initial_carry(cfg, key, st, alive), opt, alpha)

    tcfg = tloop.DashConfig(k=20, eps=0.25, alpha=alpha,
                            n_samples=6).resolve(tobj.n)
    tst = state_from_numpy(*(_np(f) for f in st), device="cpu")
    carry0 = tloop.initial_carry(tcfg, [JaxKey(key)], tst,
                                 torch.from_numpy(_np(alive))[None])
    got = tloop.make_round_body(tdash._single_device_hooks(tobj, tcfg), tcfg)(
        0, carry0, torch.tensor([opt]), torch.tensor([alpha]))

    np.testing.assert_array_equal(got.alive[0].numpy(), _np(want.alive))
    np.testing.assert_array_equal(got.state.sel_mask[0].numpy(),
                                  _np(want.state.sel_mask))
    assert int(got.count[0]) == int(want.count)
    assert int(got.trace.filter_iters[0, 0]) == int(want.trace.filter_iters[0])
    np.testing.assert_array_equal(got.key[0].key, _np(want.key))
    np.testing.assert_allclose(got.state.value[0].numpy(),
                               _np(want.state.value), rtol=VAL_TOL)
    np.testing.assert_allclose(got.state.Q[0].numpy(), _np(want.state.Q),
                               atol=1e-5)
    np.testing.assert_allclose(got.trace.est_set_gain[0, 0].numpy(),
                               _np(want.trace.est_set_gain[0]),
                               rtol=VAL_TOL, atol=1e-7)


# ---------------------------------------------------------------------------
# whole runs on the quickstart's D1 (600 × 200, k = 40)
# ---------------------------------------------------------------------------

def _sets(mask):
    return set(np.flatnonzero(np.asarray(mask)).tolist())


def test_dash_single_guess_matches():
    jobj, tobj = _pair()
    cfg_kw = dict(k=40, eps=0.25, alpha=0.6, n_samples=8)
    opt = float(jnp.max(jobj.gains(jobj.init()))) * 8.0
    key = jax.random.PRNGKey(0)
    want = jdash.dash(jobj, jloop.DashConfig(**cfg_kw), key, opt)
    got = tdash.dash(tobj, tloop.DashConfig(**cfg_kw), JaxKey(key), opt,
                     device="cpu")
    assert _sets(got.sel_mask) == _sets(want.sel_mask)
    np.testing.assert_array_equal(got.trace.filter_iters.numpy(),
                                  _np(want.trace.filter_iters))
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=VAL_TOL, atol=VAL_TOL)


def test_dash_auto_lattice_matches_per_guess():
    """G = 6 guess lanes in lockstep against the reference's batched
    lattice, compared guess by guess."""
    jobj, tobj = _pair()
    kw = dict(eps=0.25, alpha=0.6, n_samples=8, n_guesses=6,
              return_lattice=True)
    key = jax.random.PRNGKey(0)
    wbest, want = jdash.dash_auto(jobj, 40, key, **kw)
    gbest, got = tdash.dash_auto(tobj, 40, JaxKey(key), device="cpu", **kw)
    assert got.value.shape == (6,)
    for g in range(6):
        assert _sets(got.sel_mask[g]) == _sets(want.sel_mask[g]), g
        np.testing.assert_array_equal(got.trace.filter_iters[g].numpy(),
                                      _np(want.trace.filter_iters[g]))
        np.testing.assert_allclose(float(got.value[g]), float(want.value[g]),
                                   rtol=VAL_TOL, atol=VAL_TOL)
    assert _sets(gbest.sel_mask) == _sets(wbest.sel_mask)
    assert int(gbest.rounds) == int(wbest.rounds)


def test_greedy_and_top_k_identical_picks():
    jobj, tobj = _pair()
    want = jax_greedy(jobj, 40)
    got = greedy(tobj, 40, device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), _np(want.sel_idx))
    np.testing.assert_allclose(got.values.numpy(), _np(want.values),
                               rtol=VAL_TOL, atol=1e-6)
    wt = jax_top_k_select(jobj, 40)
    gt = baselines.top_k_select(tobj, 40, device="cpu")
    assert _sets(gt.sel_mask) == _sets(wt.sel_mask)
    np.testing.assert_allclose(float(gt.value), float(wt.value), rtol=VAL_TOL)


def test_random_select_identical_set():
    jobj, tobj = _pair()
    key = jax.random.PRNGKey(1)
    want = jax_random_select(jobj, 40, key)
    got = baselines.random_select(tobj, 40, JaxKey(key), device="cpu")
    assert _sets(got.sel_mask) == _sets(want.sel_mask)
    assert int(got.sel_count) == int(want.sel_count)
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=VAL_TOL)
