"""The port's selection registry and §5 roster against the JAX reference.

Inputs: the reference registry test's regression problem
(``tests/test_algorithms.py::make_regression``: d 48, n 32, k 6) and
the three objectives of its baseline suite at scale 1
(``benchmarks/bench_selection.py::_baseline_datasets``), the same numpy
arrays in both packages.  The port's noise comes through ``JaxKey``,
which replays the reference's ``split``, ``fold_in`` and Gumbel draws.

Tolerances: randomized and host-driven algorithms pick the same
elements in the same order; values within VAL_RTOL 1e-5 relative plus
VAL_ATOL 1e-4 (f32 sums in another order; logistic values reach tens).
LASSO: the same support sizes and weights within W_ATOL 1e-4 (FISTA's
f32 iterations in another summation order); at λ_max itself the top
weight is a rounding residue either side of the 1e-8 support cut, so
support sizes are compared from the second λ on.  The sparse-eigenvalue
estimate draws its subsets by Gumbel-top-k where the reference calls
``jax.random.choice``: the eigenvalues of the same subsets agree within
EIG_RTOL 1e-4, and the whole estimate within GAMMA_RTOL 0.25 of the
reference's (32 random probes of a minimum over subsets).
"""

import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.bench_selection import _baseline_datasets  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.core import lasso as jlasso  # noqa: E402
from repro.core import spectral as jspectral  # noqa: E402
from repro.core.objectives import RegressionObjective as JaxRegression  # noqa: E402
from repro.core.objectives import normalize_columns  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AOptimalityObjective,
    AlgorithmSpec,
    ClassificationObjective,
    RegressionObjective,
    SeedKey,
    algorithm_cost,
    available_algorithms,
    dash_auto,
    fast,
    get_algorithm,
    lazy_greedy,
    register,
    select,
    select_batched,
    stochastic_greedy,
)
from repro_torch.core import lasso as tlasso  # noqa: E402
from repro_torch.core import spectral as tspectral  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402

# The packages export functions named like these modules.
jgreedy = importlib.import_module("repro.core.greedy")
tgreedy = importlib.import_module("repro_torch.core.greedy")
jdash = importlib.import_module("repro.core.dash")

VAL_RTOL, VAL_ATOL = 1e-5, 1e-4
W_ATOL = 1e-4
EIG_RTOL = 1e-4
GAMMA_RTOL = 0.25
ROSTER = ("dash", "greedy", "lazy_greedy", "stochastic_greedy", "topk",
          "fast", "adaptive_sequencing", "random")
NAMES = ("regression", "aopt", "logistic")

_split = jax.jit(jax.random.split, static_argnums=1)
_fold = jax.jit(jax.random.fold_in)
_gumbel = jax.jit(jest.gumbel_noise, static_argnums=1)


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32)."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def fold_in(self, i):
        return JaxKey(_fold(self.key, i))

    def gumbel(self, n, device):
        return torch.from_numpy(np.array(_gumbel(self.key, n))).to(device)


KEY = jax.random.PRNGKey(0)


def port_objective(jobj):
    """The port's objective over the reference objective's inputs."""
    X = np.array(jobj.X)
    if hasattr(jobj, "isig2"):
        return AOptimalityObjective(X, jobj.kmax, beta2=jobj.beta2,
                                    sigma2=1.0 / jobj.isig2, device="cpu")
    y = np.array(jobj.y)
    if hasattr(jobj, "newton_steps"):
        return ClassificationObjective(
            X, y, jobj.kmax, newton_steps=jobj.newton_steps,
            newton_gain_steps=jobj.newton_gain_steps, device="cpu")
    return RegressionObjective(X, y, jobj.kmax, device="cpu")


@functools.lru_cache(maxsize=None)
def reg_pair():
    """The reference registry test's regression problem (d 48, n 32)."""
    d, n, k = 48, 32, 6
    rng = np.random.default_rng(0)
    X0 = rng.normal(size=(d, n)) + 0.4 * rng.normal(size=(d, 1))
    X = np.array(normalize_columns(jnp.asarray(X0, jnp.float32)))
    w = np.zeros(n)
    w[:k] = rng.uniform(-2, 2, k)
    y = (X0 @ w + 0.1 * rng.normal(size=d)).astype(np.float32)
    jobj = JaxRegression(jnp.asarray(X), jnp.asarray(y), kmax=k)
    return jobj, RegressionObjective(X, y, k, device="cpu"), k


@functools.lru_cache(maxsize=None)
def problem(name):
    """(reference objective, port objective, k).  The design's unit-norm
    candidates all open at gain 1/2, an f32 tie that greedy-type picks
    break by rounding; its columns are scaled by seeded factors in
    [0.5, 1.5] here, so no pick is a tie."""
    for nm, make_obj, X, k_grid, _ in _baseline_datasets(1):
        if nm == name:
            if nm == "aopt":
                X = X * np.random.default_rng(9).uniform(
                    0.5, 1.5, size=(1, X.shape[1])).astype(np.float32)
            jobj = make_obj(jnp.asarray(X, jnp.float32))
            return jobj, port_objective(jobj), k_grid[-1]
    raise KeyError(name)


def _np(x):
    return np.array(x)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=VAL_RTOL,
                               atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_roster_matches_reference():
    assert available_algorithms() == jalg.available_algorithms()
    assert set(available_algorithms()) == set(ROSTER)
    # the same distributed twins (core/distributed.py)
    assert (available_algorithms(distributed=True)
            == jalg.available_algorithms(distributed=True))
    for name in ROSTER:
        spec, ref = get_algorithm(name), jalg.get_algorithm(name)
        assert spec.needs_key == ref.needs_key, name
        assert spec.summary == ref.summary, name


@pytest.mark.parametrize("algo", ROSTER)
def test_algorithm_cost_matches(algo):
    for n, k in ((1, 1), (32, 6), (100, 10), (8192, 128), (65536, 128)):
        assert algorithm_cost(algo, n, k) == jalg.algorithm_cost(algo, n, k)


def test_registry_errors():
    _, tobj, k = reg_pair()
    with pytest.raises(ValueError, match="unknown algorithm"):
        select("gredy", tobj, k, device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        register(AlgorithmSpec(name="greedy", single=lambda *a, **kw: None,
                               distributed=None, needs_key=False,
                               cost=lambda n, k: {}, summary=""))
    for bad in (0, -3):
        with pytest.raises(ValueError, match="positive integer"):
            select("greedy", tobj, bad, device="cpu")
    with pytest.raises(ValueError, match="named-axis .shape"):
        select("greedy", tobj, k, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="lazy_greedy"):
        select_batched("lazy_greedy", tobj, k, [SeedKey(0)], device="cpu")
    with pytest.raises(ValueError, match="opt="):
        select_batched("dash", tobj, k, [SeedKey(0)], device="cpu")


def test_normalized_results():
    """Every algorithm returns the same SelectionResult surface."""
    _, tobj, k = reg_pair()
    for algo in ROSTER:
        opts = {"n_guesses": 2, "n_samples": 4} if algo == "dash" else {}
        res = select(algo, tobj, k, device="cpu", **opts)
        assert tuple(res.sel_mask.shape) == (tobj.n,), algo
        assert int(res.sel_count) == int(res.sel_mask.sum()), algo
        assert int(res.sel_count) <= k, algo
        assert np.isfinite(float(res.value)), algo
        assert res.values.dim() == 1, algo
        assert res.raw is not None, algo


def test_select_matches_direct_calls():
    _, tobj, k = reg_pair()
    key = JaxKey(KEY)
    direct = {
        "greedy": lambda: tgreedy.greedy(tobj, k, device="cpu"),
        "lazy_greedy": lambda: lazy_greedy(tobj, k, device="cpu"),
        "stochastic_greedy": lambda: stochastic_greedy(tobj, k, key,
                                                       device="cpu"),
        "fast": lambda: fast(tobj, k, key, device="cpu"),
        "dash": lambda: dash_auto(tobj, k, key, n_guesses=2, n_samples=4,
                                  device="cpu"),
    }
    for algo, run in direct.items():
        opts = {"n_guesses": 2, "n_samples": 4} if algo == "dash" else {}
        got = select(algo, tobj, k, key=key, device="cpu", **opts)
        want = run()
        assert torch.equal(got.sel_mask, want.sel_mask), algo
        assert float(got.value) == float(want.value), algo
    # a missing key is SeedKey(0)
    assert torch.equal(select("random", tobj, k, device="cpu").sel_mask,
                       select("random", tobj, k, key=SeedKey(0),
                              device="cpu").sel_mask)


@pytest.mark.parametrize("algo", ["greedy", "topk", "random",
                                  "stochastic_greedy", "lazy_greedy",
                                  "fast", "adaptive_sequencing"])
def test_select_matches_reference(algo):
    """select() in both packages on the reference's regression problem."""
    jobj, tobj, k = reg_pair()
    want = jalg.select(algo, jobj, k, key=KEY)
    got = select(algo, tobj, k, key=JaxKey(KEY), device="cpu")
    np.testing.assert_array_equal(got.sel_mask.numpy(), _np(want.sel_mask))
    assert int(got.sel_count) == int(want.sel_count)
    _close(float(got.value), float(want.value))
    assert tuple(got.values.shape) == tuple(want.values.shape)


def test_select_precision_view():
    """precision= runs through the objective's with_precision view."""
    _, tobj, k = reg_pair()
    res = select("greedy", tobj, k, precision="bf16", device="cpu")
    ref = select("greedy", tobj, k, device="cpu")
    assert abs(float(res.value) - float(ref.value)) < 5e-2


# ---------------------------------------------------------------------------
# stochastic and lazy greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,eps", [(32, 6, 0.1), (8192, 128, 0.1),
                                     (10, 20, 0.5), (1, 1, 0.1),
                                     (65536, 128, 0.01)])
def test_subsample_size(n, k, eps):
    assert tgreedy.subsample_size(n, k, eps) == \
        jgreedy.subsample_size(n, k, eps)


def test_round_gumbel_and_fold_in():
    key = jax.random.PRNGKey(11)
    ref = jax.jit(jgreedy.round_gumbel, static_argnums=2)
    for i in (0, 1, 17):
        np.testing.assert_array_equal(
            tgreedy.round_gumbel(JaxKey(key), i, 40, "cpu").numpy(),
            _np(ref(key, i, 40)))
    # SeedKey.fold_in: deterministic, and distinct from split's children
    k = SeedKey(5)
    folds = [k.fold_in(i).seed for i in range(8)]
    assert folds == [k.fold_in(i).seed for i in range(8)]
    assert len(set(folds)) == 8
    assert not set(folds) & {c.seed for c in k.split(8)}
    assert k.fold_in(3).host is False and SeedKey(5, True).fold_in(3).host


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("subsample", [None, 5])
def test_stochastic_greedy_same_picks(name, subsample):
    jobj, tobj, k = problem(name)
    want = jgreedy.stochastic_greedy(jobj, k, KEY, subsample=subsample)
    got = stochastic_greedy(tobj, k, JaxKey(KEY), subsample=subsample,
                            device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), _np(want.sel_idx))
    _close(got.values.numpy(), _np(want.values))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("batch", [1, 8])
def test_lazy_greedy_same_picks(name, batch):
    jobj, tobj, k = problem(name)
    want = jgreedy.lazy_greedy(jobj, k, batch=batch)
    got = lazy_greedy(tobj, k, batch=batch, device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), _np(want.sel_idx))
    _close(got.values.numpy(), _np(want.values))


def test_lazy_greedy_edges():
    """k > n stops after n distinct picks; batch must be positive."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(8, 5)).astype(np.float32)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    y = rng.normal(size=8).astype(np.float32)
    tobj = RegressionObjective(X, y, 5, device="cpu")
    want = jgreedy.lazy_greedy(JaxRegression(jnp.asarray(X), jnp.asarray(y),
                                             kmax=5), 8)
    got = lazy_greedy(tobj, 8, device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), _np(want.sel_idx))
    assert tuple(got.values.shape) == (5,)
    with pytest.raises(ValueError, match="batch"):
        lazy_greedy(tobj, 3, batch=0, device="cpu")


# ---------------------------------------------------------------------------
# DASH's loop mode and request batching
# ---------------------------------------------------------------------------

def test_dash_auto_loop_mode():
    """guess_mode="loop" gives the batched lanes' sets guess by guess,
    and the reference loop mode's."""
    jobj, tobj, k = problem("regression")
    kw = dict(eps=0.25, alpha=0.6, n_samples=4, n_guesses=4,
              return_lattice=True)
    key = jax.random.PRNGKey(2)
    _, want = jdash.dash_auto(jobj, k, key, guess_mode="loop", **kw)
    lbest, loop = dash_auto(tobj, k, JaxKey(key), guess_mode="loop",
                            device="cpu", **kw)
    bbest, batched = dash_auto(tobj, k, JaxKey(key), device="cpu", **kw)
    assert tuple(loop.value.shape) == (4,)
    for g in range(4):
        np.testing.assert_array_equal(loop.sel_mask[g].numpy(),
                                      batched.sel_mask[g].numpy())
        np.testing.assert_array_equal(loop.sel_mask[g].numpy(),
                                      _np(want.sel_mask[g]))
        np.testing.assert_array_equal(loop.trace.filter_iters[g].numpy(),
                                      _np(want.trace.filter_iters[g]))
        _close(float(loop.value[g]), float(want.value[g]))
    assert torch.equal(lbest.sel_mask, bbest.sel_mask)
    with pytest.raises(ValueError, match="guess_mode"):
        dash_auto(tobj, k, SeedKey(0), guess_mode="lanes", device="cpu")


@pytest.mark.parametrize("algo", ["greedy", "topk", "random",
                                  "stochastic_greedy", "fast",
                                  "adaptive_sequencing", "dash"])
def test_select_batched(algo):
    """Field shapes (B, ...) and each request equal to its own run."""
    _, tobj, k = reg_pair()
    keys = [JaxKey(jax.random.PRNGKey(s)) for s in (0, 3, 4)]
    kw = {"opt": [0.9, 0.95, 1.0], "n_samples": 4} if algo == "dash" else {}
    res = select_batched(algo, tobj, k, keys, device="cpu", **kw)
    assert tuple(res.sel_mask.shape) == (3, tobj.n)
    assert tuple(res.sel_count.shape) == (3,)
    assert tuple(res.value.shape) == (3,)
    assert res.values.shape[0] == 3
    for i, key in enumerate(keys):
        if algo == "dash":
            one = select("dash", tobj, k, key=key, opt=kw["opt"][i],
                         n_samples=4, device="cpu")
        else:
            one = select(algo, tobj, k, key=key, device="cpu")
        np.testing.assert_array_equal(res.sel_mask[i].numpy(),
                                      one.sel_mask.numpy())
        assert int(res.sel_count[i]) == int(one.sel_count)
        _close(float(res.value[i]), float(one.value))


# ---------------------------------------------------------------------------
# LASSO, γ estimators, the surrogate datasets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lasso_data(task):
    if task == "linear":
        X, y, _ = tsynth.make_d1_regression(n_samples=250, n_features=125,
                                            support=25)
    else:
        X, y, _ = tsynth.make_d3_classification(n_samples=150,
                                                n_features=50, support=12)
    return X, y


@pytest.mark.parametrize("task", ["linear", "logistic"])
def test_fista_matches(task):
    X, y = lasso_data(task)
    lam = 0.3 * float(np.max(np.abs(X.T @ (y - (0.5 if task == "logistic"
                                                 else 0.0)))))
    want = jlasso.fista(jnp.asarray(X), jnp.asarray(y), lam, task=task,
                        iters=200)
    got = tlasso.fista(X, y, lam, task=task, iters=200, device="cpu")
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_allclose(got.w.numpy(), _np(want.w), atol=W_ATOL)


@pytest.mark.parametrize("task", ["linear", "logistic"])
def test_lasso_path_select_matches(task):
    X, y = lasso_data(task)
    wbest, wpath = jlasso.lasso_path_select(X, y, 10, task=task, iters=150)
    gbest, gpath = tlasso.lasso_path_select(X, y, 10, task=task, iters=150,
                                            device="cpu")
    assert len(gpath) == len(wpath)
    assert [int(r.nnz) for r in gpath[1:]] == [int(r.nnz) for r in wpath[1:]]
    for g, w in zip(gpath, wpath):
        np.testing.assert_allclose(g.w.numpy(), _np(w.w), atol=W_ATOL)
        np.testing.assert_allclose(float(g.lam), float(w.lam), rtol=1e-5)
    assert int(gbest.nnz) == int(wbest.nnz)
    np.testing.assert_allclose(gbest.w.numpy(), _np(wbest.w), atol=W_ATOL)
    with pytest.raises(ValueError, match="task"):
        tlasso.fista(X, y, 1.0, task="probit", device="cpu")


def test_sparse_eig_ratio():
    X, _ = lasso_data("linear")
    k = 10
    idx = tspectral.probe_subsets(SeedKey(0), X.shape[1], 2 * k, 6, "cpu")
    assert tuple(idx.shape) == (6, 2 * k)
    assert all(len(set(r)) == 2 * k for r in idx.tolist())
    mins, maxs = tspectral.subset_eig_extremes(torch.from_numpy(X), idx)
    for p, r in enumerate(idx.numpy()):
        C = jnp.asarray(X[:, r])
        ev = jnp.linalg.eigvalsh(C.T @ C / X.shape[0])
        np.testing.assert_allclose(float(mins[p]), float(ev[0]),
                                   rtol=EIG_RTOL)
        np.testing.assert_allclose(float(maxs[p]), float(ev[-1]),
                                   rtol=EIG_RTOL)
    want = float(jspectral.sparse_eig_ratio(jnp.asarray(X), k, KEY))
    Xt = torch.from_numpy(X)
    got = float(tspectral.sparse_eig_ratio(Xt, k, SeedKey(0)))
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(got, want, rtol=GAMMA_RTOL)
    assert float(tspectral.gamma_regression(Xt, k, SeedKey(0))) == got
    assert float(tspectral.gamma_classification(Xt, k, SeedKey(0))) == got


@pytest.mark.parametrize("seed,d,n", [(1, 300, 96), (4, 120, 385)])
def test_make_d2_clinical_identical(seed, d, n):
    got = tsynth.make_d2_clinical(seed=seed, n_samples=d, n_features=n)
    want = jsynth.make_d2_clinical(seed=seed, n_samples=d, n_features=n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,d,n", [(3, 200, 625), (0, 64, 100)])
def test_make_d4_gene_identical(seed, d, n):
    got = tsynth.make_d4_gene(seed=seed, n_samples=d, n_features=n)
    want = jsynth.make_d4_gene(seed=seed, n_samples=d, n_features=n)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the §5 entry point
# ---------------------------------------------------------------------------

def test_bench_selection_baseline_datasets_match():
    """The entry point's baseline problems are the reference suite's."""
    from repro_torch.bench_selection import baseline_datasets

    for (name, tobj, k_grid, opts), (jname, make_obj, X, jk, jopts) in zip(
            baseline_datasets(1, "cpu"), _baseline_datasets(1)):
        jobj = make_obj(X)
        assert (name, k_grid, opts) == (jname, jk, jopts)
        np.testing.assert_allclose(tobj.X.numpy(), _np(jobj.X), rtol=1e-6,
                                   atol=1e-6)
        if hasattr(jobj, "y"):
            np.testing.assert_array_equal(tobj.y.numpy(), _np(jobj.y))


def test_bench_selection_main_suite_small():
    """The main suite's selectors and LASSO, at a small D1 on the CPU."""
    from repro_torch.bench_selection import MAIN_ALGOS, run_main

    res = run_main("cpu", d=300, n=120, k=12, support=24, verbose=False)
    rows = res["rows"]
    assert set(rows) == set(MAIN_ALGOS) | {"lasso"}
    for algo, row in rows.items():
        assert 0.0 <= row["value"] <= 1.0, algo
        assert algo == "lasso" or row["sel_count"] <= 12, algo
    assert rows["fast"]["rounds"] >= 1
