"""The port's regression objective against the JAX reference, on the CPU.

Both packages start from the same state: the JAX objective builds it,
its fields go across as numpy arrays through ``repro_torch.convert``.
Tolerances: 1e-5 rtol / 1e-6 atol on normalized gains and values (f32
sums taken in another order), 1e-5 on the orthonormal bases.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.objectives import RegressionObjective as JaxRegression  # noqa: E402
from repro.core.objectives.regression import (  # noqa: E402
    mgs_expand as jax_mgs_expand,
    mgs_extend as jax_mgs_extend,
)
from repro.data.synthetic import make_d1_regression as jax_make_d1  # noqa: E402
from repro_torch.convert import objective_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core.objectives.regression import mgs_expand, mgs_extend  # noqa: E402
from repro_torch.data.synthetic import make_d1_regression  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _pair(d=60, n=40, kmax=8, seed=0, precision=None):
    X, y, _ = make_d1_regression(seed=seed, n_samples=d, n_features=n,
                                 support=10)
    jobj = JaxRegression(jnp.asarray(X), jnp.asarray(y), kmax=kmax,
                         precision=precision)
    tobj = objective_from_numpy(X, y, kmax, precision=precision,
                                device="cpu")
    return jobj, tobj


def _state_pair(jobj, sel):
    st = jobj.init()
    if sel:
        st = jobj.add_set(st, jnp.asarray(sel, jnp.int32),
                          jnp.ones(len(sel), bool))
    return st, state_from_numpy(*(np.asarray(f) for f in st), device="cpu")


def _lanes(states):
    """Stack JAX states on a leading lane axis (numpy fields)."""
    return [np.stack([np.asarray(s[i]) for s in states]) for i in range(5)]


def test_make_d1_regression_byte_identical():
    for kw in ({}, dict(seed=3, n_samples=77, n_features=31, support=9)):
        a = jax_make_d1(**kw)
        b = make_d1_regression(**kw)
        for x, z in zip(a, b):
            assert x.dtype == z.dtype and x.shape == z.shape
            assert x.tobytes() == z.tobytes()


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("sel", [[], [3, 7, 11], [0, 1, 2, 5, 8, 13, 21, 34]])
def test_gains_and_subset(sel, precision):
    jobj, tobj = _pair(precision=precision)
    jst, tst = _state_pair(jobj, sel)
    _close(tobj.gains(tst)[0], jobj.gains(jst))
    idx = np.array([0, 3, 5, 7, 39, 20], np.int64)
    got = tobj.gains_subset(tst, torch.from_numpy(idx)[None])[0]
    _close(got, jobj.gains_subset(jst, jnp.asarray(idx, jnp.int32)))


@pytest.mark.parametrize("sel", [[], [4, 9]])
def test_set_gain(sel):
    jobj, tobj = _pair()
    jst, tst = _state_pair(jobj, sel)
    idx = np.array([[1, 4, 6, 30], [2, 2, 17, 0], [9, 10, 11, 12]])
    mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 1]], bool)
    want = [jobj.set_gain(jst, jnp.asarray(i, jnp.int32), jnp.asarray(v))
            for i, v in zip(idx, mask)]
    got = tobj.set_gain(tst, torch.from_numpy(idx)[None],
                        torch.from_numpy(mask)[None])
    assert got.shape == (1, 3)
    _close(got[0], np.stack(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sel,add", [
    ([], [5, 6, 7]),
    ([1, 2], [2, 30, 31]),       # an already-selected (in-span) column
    ([0, 1, 2, 3, 4, 5], [10, 11, 12, 13]),   # hits capacity kmax = 8
])
def test_add_set(sel, add):
    jobj, tobj = _pair()
    jst, tst = _state_pair(jobj, sel)
    mask = np.ones(len(add), bool)
    mask[-1] = False
    want = jobj.add_set(jst, jnp.asarray(add, jnp.int32), jnp.asarray(mask))
    got = tobj.add_set(tst, torch.tensor([add]), torch.from_numpy(mask)[None])
    _close(got.Q[0], want.Q)
    assert int(got.count[0]) == int(want.count)
    _close(got.resid[0], want.resid)
    np.testing.assert_array_equal(got.sel_mask[0].numpy(),
                                  np.asarray(want.sel_mask))
    _close(got.value[0], want.value)


@pytest.mark.parametrize("sel", [[3], [3, 7, 11], [0, 1, 2, 5, 8, 13, 21, 34]])
def test_brute_value_matches_reference(sel):
    """The lstsq oracle f(S) equals the reference's within 1e-5, and the
    MGS state's value of the same set."""
    jobj, tobj = _pair()
    want = float(jobj.brute_value(np.asarray(sel)))
    got = float(tobj.brute_value(sel))
    assert abs(got - want) <= 1e-5
    _, tst = _state_pair(jobj, sel)
    assert abs(float(tst.value[0]) - got) <= 1e-5


def _mgs_inputs(seed=9, d=24, k=6, count=3, m=5):
    rng = np.random.default_rng(seed)
    Q = np.zeros((d, k), np.float32)
    Q[:, :count] = np.linalg.qr(rng.normal(size=(d, count)))[0]
    resid = rng.normal(size=d).astype(np.float32)
    C = rng.normal(size=(d, m)).astype(np.float32)
    C[:, 1] = 2.0 * Q[:, 0] - Q[:, 2]        # in span: rejected
    C[:, 3] = 0.0                           # zero column: rejected
    return Q, np.int32(count), resid, C


@pytest.mark.parametrize("kmax,count", [(6, 3), (5, 3), (3, 3)])
def test_mgs_extend(kmax, count):
    """Rejected in-span and zero columns, and the at-capacity guard."""
    Q, _, resid, C = _mgs_inputs(count=count, k=kmax)
    want = jax_mgs_extend(jnp.asarray(Q), jnp.int32(count), jnp.asarray(resid),
                          jnp.asarray(C), kmax)
    got = mgs_extend(*(torch.from_numpy(np.asarray(a))[None]
                       for a in (Q, np.int32(count), resid, C)), kmax)
    _close(got[0][0], want[0], atol=1e-5)
    assert int(got[1][0]) == int(want[1])
    _close(got[2][0], want[2], atol=1e-5)
    if count == kmax:      # nothing accepted, last slot untouched
        np.testing.assert_array_equal(got[0][0].numpy(), Q)


@pytest.mark.parametrize("kmax", [7, 4, 3])
def test_mgs_expand(kmax):
    Q, count, resid, C = _mgs_inputs(k=kmax)
    want_D, want_r = jax_mgs_expand(jnp.asarray(Q), jnp.int32(count),
                                    jnp.asarray(resid), jnp.asarray(C), kmax)
    Ct = torch.from_numpy(np.stack([C, C[:, ::-1].copy()]))[None]   # (1, 2, d, m)
    D, r = mgs_expand(torch.from_numpy(Q)[None], torch.tensor([count]),
                      torch.from_numpy(resid)[None], Ct, kmax)
    assert D.shape == (1, 2, 24, 5)
    _close(D[0, 0], want_D, atol=1e-5)
    _close(r[0, 0], want_r, atol=1e-5)
    want_D1, want_r1 = jax_mgs_expand(jnp.asarray(Q), jnp.int32(count),
                                      jnp.asarray(resid),
                                      jnp.asarray(C[:, ::-1].copy()), kmax)
    _close(D[0, 1], want_D1, atol=1e-5)
    _close(r[0, 1], want_r1, atol=1e-5)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_filter_gains_batch_lanes(precision):
    """G = 3 lanes with different states, m = 4 samples each, against the
    reference's per-guess method under vmap."""
    jobj, tobj = _pair(kmax=10, precision=precision)
    sels = [[], [1, 5], [0, 2, 4, 6, 8, 10, 12]]
    jstates = [_state_pair(jobj, s)[0] for s in sels]
    tst = state_from_numpy(*_lanes(jstates), device="cpu")
    rng = np.random.default_rng(4)
    idx = np.stack([[rng.choice(40, 3, replace=False) for _ in range(4)]
                    for _ in range(3)])
    mask = rng.uniform(size=idx.shape) < 0.8
    jst = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jstates)
    want = jax.vmap(jobj.filter_gains_batch)(
        jst, jnp.asarray(idx, jnp.int32), jnp.asarray(mask))
    got = tobj.filter_gains_batch(tst, torch.from_numpy(idx),
                                  torch.from_numpy(mask))
    assert got.shape == (3, 4, 40)
    _close(got, want, rtol=1e-4, atol=1e-6)
    D, R = tobj.expand_basis(tst, torch.from_numpy(idx),
                             torch.from_numpy(mask))
    jD, jR = jax.vmap(jax.vmap(jobj.expand_basis, (None, 0, 0)))(
        jst, jnp.asarray(idx, jnp.int32), jnp.asarray(mask))
    _close(D, jD, atol=1e-5)
    _close(R, jR, atol=1e-5)


@pytest.mark.parametrize("sel", [[], [3, 9, 27]])
def test_engine_estimate_matches_per_sample_path(sel):
    """DASH's filter statistic through the filter engine equals the one
    built from the per-sample add_set + gains stack, over two lanes with
    different states."""
    import copy
    import importlib

    tdash = importlib.import_module("repro_torch.core.dash")
    from repro_torch.core.random import SeedKey

    jobj, tobj = _pair(kmax=10)
    per_sample = copy.copy(tobj)
    per_sample.filter_gains_batch = lambda st, idx, valid: torch.stack([
        tobj.gains(tobj.add_set(st, idx[:, s], valid[:, s]))
        for s in range(idx.shape[1])
    ], dim=1)
    tst = state_from_numpy(*_lanes([_state_pair(jobj, s)[0]
                                    for s in ([], sel)]), device="cpu")
    cfg = tdash.DashConfig(k=10, n_samples=6).resolve(tobj.n)
    alive = ~tst.sel_mask
    allowed = 10 - tst.count
    keys = [SeedKey(11), SeedKey(12)]
    got = tdash._estimate_elem_gains(tobj, tst, alive, 4, allowed, keys, cfg)
    want = tdash._estimate_elem_gains(per_sample, tst, alive, 4, allowed,
                                      keys, cfg)
    assert got.shape == (2, 40)
    _close(got, want, rtol=1e-4, atol=1e-6)
