"""The port's R², diversity objectives and per-sample filter path
against the JAX reference, on the CPU.

The same seeded numpy inputs go through both packages; the port's noise
comes through ``JaxKey``, which replays the reference's ``split`` and
Gumbel draws, so DASH runs compare decision for decision.

Tolerances:
  * VAL_RTOL 1e-5 relative, VAL_ATOL 1e-5 — values, gains and set gains
    (f32 sums in another order; R² values are at most 1, diversity sums
    of square roots of small integer counts);
  * the per-sample path against the filter engine at the reference's own
    (``tests/test_filter_gains.py``): regression rtol 1e-4 / atol 1e-5,
    A-optimality rtol 1e-5 / atol 1e-6, logistic rtol 1e-4 / atol 1e-5.

The reference's ``ClusterDiversity.set_gain`` scatters into ``idx``
where it means ``clusters[idx]`` (ROADMAP §3, reference caveats); the
port computes d(S ∪ R) − d(S).  The diversified DASH parity therefore
runs the reference's DASH and ``DiversifiedObjective`` over a
``ClusterDiversity`` whose ``set_gain`` is the corrected formula
(``_FixedDiversity`` below); everything else is the reference's.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import estimators as jest  # noqa: E402
from repro.core.greedy import greedy as jax_greedy  # noqa: E402
from repro.core.objectives import (  # noqa: E402
    AOptimalityObjective as JaxAOpt,
    ClusterDiversity as JaxClusterDiversity,
    DiversifiedObjective as JaxDiversified,
    DiversityObjective as JaxDiversity,
    R2Objective as JaxR2,
)
from repro_torch.core import (  # noqa: E402
    AOptimalityObjective,
    ClassificationObjective,
    ClusterDiversity,
    DashConfig,
    DiversifiedObjective,
    DiversityObjective,
    R2Objective,
    RegressionObjective,
    SeedKey,
    adaptive_sequencing,
    dash,
    fast,
    greedy,
    lazy_greedy,
)
from repro_torch.core.objectives.r2 import standardize  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_d1_design,
    make_d1_regression,
    make_d3_classification,
)

jdash = importlib.import_module("repro.core.dash")
tdash = importlib.import_module("repro_torch.core.dash")

VAL_RTOL, VAL_ATOL = 1e-5, 1e-5
ENGINE_TOL = {"regression": (1e-4, 1e-5), "aopt": (1e-5, 1e-6),
              "logistic": (1e-4, 1e-5)}

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

    def normal(self, shape, device):
        z = np.array(jax.random.normal(self.key, tuple(shape)))
        return torch.from_numpy(z).to(device)


def _np(x):
    return np.array(x)


def _sets(mask):
    return set(np.flatnonzero(np.asarray(mask)).tolist())


def _ones(m):
    return torch.ones((1, m), dtype=torch.bool)


# ---------------------------------------------------------------------------
# R²
# ---------------------------------------------------------------------------

def _r2_data(d=120, n=60, support=10):
    """Raw (unstandardized) D1 columns with an offset and scale per
    column, so that standardize has work to do."""
    X, y, _ = make_d1_regression(seed=3, n_samples=d, n_features=n,
                                 support=support)
    rng = np.random.default_rng(1)
    X = X * rng.uniform(0.5, 3.0, size=(1, n)) + rng.normal(size=(1, n))
    return X.astype(np.float32), (y + 2.0).astype(np.float32)


def test_r2_values_gains_and_brute():
    X, y = _r2_data()
    jobj, tobj = JaxR2(X, y, kmax=12), R2Objective(X, y, 12, device="cpu")
    Xs, ys = standardize(X, y)
    np.testing.assert_allclose(tobj.X.numpy(), _np(jobj.X), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), _np(jobj.y), rtol=1e-5, atol=1e-6)
    sel = [3, 17, 40, 8]
    jst = jobj.add_set(jobj.init(), jnp.asarray(sel), jnp.ones(4, bool))
    tst = tobj.add_set(tobj.init(), torch.tensor([sel]), _ones(4))
    np.testing.assert_allclose(float(tst.value[0]), float(jst.value),
                               rtol=VAL_RTOL)
    np.testing.assert_allclose(tobj.gains(tst)[0].numpy(), _np(jobj.gains(jst)),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    # Def. 14 by a direct solve equals the incremental value, in both.
    np.testing.assert_allclose(float(tobj.brute_r2(sel)),
                               float(jobj.brute_r2(jnp.asarray(sel))),
                               rtol=VAL_RTOL)
    np.testing.assert_allclose(float(tobj.brute_r2(sel)), float(tst.value[0]),
                               rtol=1e-4)
    assert 0.0 <= float(tst.value[0]) <= 1.0


def test_r2_greedy_and_dash_lattice_match():
    """Greedy picks, and a 4-guess DASH lattice guess by guess."""
    X, y = _r2_data()
    jobj, tobj = JaxR2(X, y, kmax=12), R2Objective(X, y, 12, device="cpu")
    want = jax_greedy(jobj, 12)
    got = greedy(tobj, 12, device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), _np(want.sel_idx))
    kw = dict(eps=0.25, alpha=0.6, n_samples=6, n_guesses=4,
              return_lattice=True)
    key = jax.random.PRNGKey(2)
    _, wl = jdash.dash_auto(jobj, 12, key, **kw)
    _, gl = tdash.dash_auto(tobj, 12, JaxKey(key), device="cpu", **kw)
    for g in range(4):
        assert _sets(gl.sel_mask[g]) == _sets(wl.sel_mask[g]), g
        np.testing.assert_array_equal(gl.trace.filter_iters[g].numpy(),
                                      _np(wl.trace.filter_iters[g]))
        np.testing.assert_allclose(float(gl.value[g]), float(wl.value[g]),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# cluster diversity
# ---------------------------------------------------------------------------

N_DIV, C_DIV = 40, 5


def _clusters():
    return np.random.default_rng(4).integers(0, C_DIV, N_DIV).astype(np.int32)


def _masks():
    rng = np.random.default_rng(5)
    return rng.uniform(size=(3, N_DIV)) < np.array([[0.0], [0.2], [0.6]])


def test_cluster_diversity_value_gains_gains_at():
    cl, masks = _clusters(), _masks()
    jd = JaxClusterDiversity(jnp.asarray(cl), C_DIV, weight=0.7)
    td = ClusterDiversity(cl, C_DIV, 0.7, device="cpu")
    tm = torch.from_numpy(masks)
    idx = np.random.default_rng(6).integers(0, N_DIV, (3, 9))
    got_v, got_g = td.value(tm).numpy(), td.gains(tm).numpy()
    got_c = td.counts(tm).numpy()
    got_at = td.gains_at(tm, torch.from_numpy(idx)).numpy()
    for g in range(3):
        m = jnp.asarray(masks[g])
        np.testing.assert_array_equal(got_c[g], _np(jd.counts(m)))
        np.testing.assert_allclose(got_v[g], float(jd.value(m)),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(got_g[g], _np(jd.gains(m)),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(got_at[g], _np(jd.gains_at(m, idx[g])),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)


def test_cluster_diversity_set_gain_is_value_difference():
    """set_gain(S, R) = d(S ∪ R) − d(S), per lane and sample, against the
    reference's ``value`` of the union; padded slots and elements of S
    add nothing."""
    cl, masks = _clusters(), _masks()
    jd = JaxClusterDiversity(jnp.asarray(cl), C_DIV, weight=0.7)
    td = ClusterDiversity(cl, C_DIV, 0.7, device="cpu")
    rng = np.random.default_rng(7)
    idx = np.stack([np.stack([rng.permutation(N_DIV)[:6] for _ in range(4)])
                    for _ in range(3)])                        # (3, 4, 6)
    valid = rng.uniform(size=idx.shape) < 0.8
    got = td.set_gain(torch.from_numpy(masks), torch.from_numpy(idx),
                      torch.from_numpy(valid)).numpy()
    assert got.shape == (3, 4)
    for g in range(3):
        for s in range(4):
            union = masks[g].copy()
            union[idx[g, s][valid[g, s]]] = True
            want = float(jd.value(jnp.asarray(union))) - float(
                jd.value(jnp.asarray(masks[g])))
            np.testing.assert_allclose(got[g, s], want, rtol=VAL_RTOL,
                                       atol=VAL_ATOL)


def test_reference_set_gain_caveat():
    """The reference's set_gain files element a under cluster a (and
    drops a ≥ C), not under clusters[a]: it departs from its own value
    difference, which the port's follows (see the module docstring)."""
    cl = _clusters()
    jd = JaxClusterDiversity(jnp.asarray(cl), C_DIV, weight=1.0)
    td = ClusterDiversity(cl, C_DIV, 1.0, device="cpu")
    empty = np.zeros(N_DIV, bool)
    idx = np.array([20, 30, 35])
    want = float(jd.value(jnp.asarray(np.isin(np.arange(N_DIV), idx))))
    ref = float(jd.set_gain(jnp.asarray(empty), jnp.asarray(idx),
                            jnp.ones(3, bool)))
    got = float(td.set_gain(torch.zeros((1, N_DIV), dtype=torch.bool),
                            torch.from_numpy(idx)[None], _ones(3))[0])
    assert ref == 0.0 and want > 0.0
    np.testing.assert_allclose(got, want, rtol=VAL_RTOL)


def test_diversity_objective_oracles_and_lazy_greedy():
    """DiversityObjective's state and oracles against the reference, and
    Minoux's invariant: lazy greedy equals greedy pick for pick, and
    both equal the reference's greedy."""
    cl = _clusters()
    jobj = JaxDiversity(jnp.asarray(cl), C_DIV, weight=0.5, kmax=12)
    tobj = DiversityObjective(cl, C_DIV, weight=0.5, kmax=12, device="cpu")
    sel = [1, 7, 7, 22]
    jst = jobj.add_set(jobj.init(), jnp.asarray(sel), jnp.ones(4, bool))
    tst = tobj.add_set(tobj.init(), torch.tensor([sel]), _ones(4))
    np.testing.assert_array_equal(tst.sel_mask[0].numpy(), _np(jst.sel_mask))
    np.testing.assert_allclose(float(tst.value[0]), float(jst.value),
                               rtol=VAL_RTOL)
    np.testing.assert_allclose(tobj.gains(tst)[0].numpy(), _np(jobj.gains(jst)),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    sub = np.array([[0, 1, 5, 22, 39]])
    np.testing.assert_allclose(
        tobj.gains_subset(tst, torch.from_numpy(sub))[0].numpy(),
        _np(jobj.gains_subset(jst, jnp.asarray(sub[0]))),
        rtol=VAL_RTOL, atol=VAL_ATOL)
    g = greedy(tobj, 12, device="cpu")
    lazy = lazy_greedy(tobj, 12, batch=4, device="cpu")
    np.testing.assert_array_equal(lazy.sel_idx.numpy(), g.sel_idx.numpy())
    np.testing.assert_array_equal(g.sel_idx.numpy(),
                                  _np(jax_greedy(jobj, 12).sel_idx))


class _FixedDiversity(JaxClusterDiversity):
    """The reference's ClusterDiversity with set_gain scattering into
    ``clusters[idx]``."""

    def set_gain(self, sel_mask, idx, mask):
        c = self.counts(sel_mask)
        add = jnp.zeros((self.n_clusters,)).at[self.clusters[idx]].add(
            (mask & ~sel_mask[idx]).astype(jnp.float32))
        return self.weight * jnp.sum(jnp.sqrt(c + add) - jnp.sqrt(c))


def test_diversified_dash_matches_per_guess():
    """DiversifiedObjective over A-optimal design: DASH's 4-guess lattice
    (the per-sample filter path) guess by guess against the reference."""
    X = make_d1_design(seed=0, n_samples=96, n_features=24)
    cl = np.random.default_rng(8).integers(0, 4, 96).astype(np.int32)
    jobj = JaxDiversified(JaxAOpt(jnp.asarray(X), kmax=10),
                          _FixedDiversity(jnp.asarray(cl), 4, weight=0.2))
    tobj = DiversifiedObjective(
        AOptimalityObjective(X, 10, device="cpu"),
        ClusterDiversity(cl, 4, 0.2, device="cpu"))
    st = tobj.add_set(tobj.init(), torch.tensor([[2, 50]]), _ones(2))
    jst = jobj.add_set(jobj.init(), jnp.asarray([2, 50]), jnp.ones(2, bool))
    np.testing.assert_allclose(float(tobj.value(st)[0]), float(jobj.value(jst)),
                               rtol=VAL_RTOL)
    kw = dict(eps=0.25, alpha=0.6, n_samples=4, n_guesses=4,
              return_lattice=True)
    key = jax.random.PRNGKey(1)
    _, wl = jdash.dash_auto(jobj, 10, key, **kw)
    _, gl = tdash.dash_auto(tobj, 10, JaxKey(key), device="cpu", **kw)
    assert int(np.sum(_np(wl.trace.filter_iters))) > 0   # the filter ran
    for g in range(4):
        assert _sets(gl.sel_mask[g]) == _sets(wl.sel_mask[g]), g
        np.testing.assert_array_equal(gl.trace.filter_iters[g].numpy(),
                                      _np(wl.trace.filter_iters[g]))
        np.testing.assert_allclose(float(gl.value[g]), float(wl.value[g]),
                                   rtol=VAL_RTOL, atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# the engine switch and the per-sample path
# ---------------------------------------------------------------------------

def _problem(name, engine=True):
    if name == "regression":
        X, y, _ = make_d1_regression(seed=0, n_samples=80, n_features=50,
                                     support=8)
        return RegressionObjective(X, y, 12, use_filter_engine=engine,
                                   device="cpu")
    if name == "aopt":
        X = make_d1_design(seed=0, n_samples=50, n_features=20)
        return AOptimalityObjective(X, 12, use_filter_engine=engine,
                                    device="cpu")
    X, y, _ = make_d3_classification(n_samples=80, n_features=50, support=8)
    return ClassificationObjective(X, y, 12, use_filter_engine=engine,
                                   device="cpu")


@pytest.mark.parametrize("name", ["regression", "aopt", "logistic"])
def test_per_sample_estimate_matches_engine(name):
    """_estimate_elem_gains through use_filter_engine=False (one
    gains(add_set(...)) per sample) against the engine, on 3 lanes with
    different states and the same keys."""
    on, off = _problem(name, True), _problem(name, False)
    st = on.add_set(on.init(3), torch.tensor([[0, 3, 9], [5, 5, 1],
                                              [7, 2, 4]]),
                    torch.tensor([[True, True, False], [True, True, True],
                                  [False, False, False]]))
    cfg = DashConfig(k=12, n_samples=5).resolve(on.n)
    alive = torch.ones((3, on.n), dtype=torch.bool)
    alive[1, ::3] = False
    allowed = torch.tensor([12, 3, 7])
    keys = SeedKey(11).split(3)
    want = tdash._estimate_elem_gains(on, st, alive, 4, allowed, keys, cfg)
    got = tdash._estimate_elem_gains(off, st, alive, 4, allowed, keys, cfg)
    rtol, atol = ENGINE_TOL[name]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["regression", "aopt", "logistic"])
def test_engine_switch_routes_every_algorithm(name, monkeypatch):
    """use_filter_engine=False sends DASH, FAST and adaptive sequencing
    through the per-sample path: a spy on filter_gains_batch counts no
    call, where the flag's default counts calls in each algorithm."""
    calls = {"n": 0}
    real = type(_problem(name)).filter_gains_batch

    def spy(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(type(_problem(name)), "filter_gains_batch", spy)
    for engine in (False, True):
        obj = _problem(name, engine)
        opt = float(torch.max(obj.gains(obj.init()))) * 6.0
        for run in (
            lambda: dash(obj, DashConfig(k=6, eps=0.25, alpha=1.0,
                                         n_samples=3), SeedKey(0), opt,
                         device="cpu"),
            lambda: fast(obj, 6, SeedKey(0), opt=opt, max_rounds=3,
                         device="cpu"),
            lambda: adaptive_sequencing(obj, 6, SeedKey(0), rounds=2,
                                        device="cpu"),
        ):
            calls["n"] = 0
            run()
            assert (calls["n"] > 0) == engine, (engine, run)
