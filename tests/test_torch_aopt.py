"""The port's A-optimal design slice against the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX functions and the
port's counterparts; objective states start equal, the JAX objective
builds them and their fields cross as numpy arrays through
``repro_torch.convert``.  Every A-optimality operand comes from a
genuine state (W = M⁻¹X with M = β²I + σ⁻²X_SX_Sᵀ, Woodbury factors from
``expand_factors`` or the same Cholesky formula), so den ≥ 1.

Tolerances:
  * RTOL 1e-5 / ATOL 1e-6 on gains, set gains, Woodbury factors and the
    kernels' plain versions (f32 sums taken in another order);
  * ATOL_STATE 1e-5 on M, L and W (a Cholesky factor and two triangular
    solves in another LAPACK);
  * VAL_ATOL 2e-4 on values f(S) = d/β² − Tr(M⁻¹): both packages lose
    about d·ε_f32 to the cancellation (d ≤ 128 here);
  * TIE_RTOL 2e-4 on decision margins: a greedy or TOP-K decision is
    compared only where its margin exceeds it (see the greedy test).
"""

import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import spectral as jspectral  # noqa: E402
from repro.core.baselines import random_select as jax_random_select  # noqa: E402
from repro.core.baselines import top_k_select as jax_top_k_select  # noqa: E402
from repro.core.greedy import greedy as jax_greedy  # noqa: E402
from repro.core.objectives import AOptimalityObjective as JaxAOpt  # noqa: E402
from repro.data.synthetic import make_d1_design as jax_make_d1_design  # noqa: E402
from repro.kernels.aopt_gains.ops import aopt_gains as jax_aopt_gains  # noqa: E402
from repro.kernels.aopt_gains.ref import aopt_gains_ref as jax_aopt_gains_ref  # noqa: E402
from repro.kernels.common import quantize as jax_quantize  # noqa: E402
from repro.kernels.filter_gains.ops import (  # noqa: E402
    aopt_filter_gains as jax_aopt_filter_gains,
)
from repro.kernels.filter_gains.ref import (  # noqa: E402
    aopt_filter_gains_lattice_ref as jax_aopt_lattice_ref,
)
from repro_torch.convert import (  # noqa: E402
    aopt_objective_from_numpy,
    aopt_state_from_numpy,
)
from repro_torch.core import baselines, spectral  # noqa: E402
from repro_torch.core.greedy import greedy  # noqa: E402
from repro_torch.data.synthetic import make_d1_design  # noqa: E402
from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref  # noqa: E402
from repro_torch.kernels.common import quantize  # noqa: E402
from repro_torch.kernels.filter_gains import (  # noqa: E402
    aopt_filter_gains,
    aopt_filter_gains_lattice_ref,
)
from test_torch_dash import JaxKey  # noqa: E402

# The packages export functions named like these modules.
jdash = importlib.import_module("repro.core.dash")
tdash = importlib.import_module("repro_torch.core.dash")

RTOL, ATOL = 1e-5, 1e-6
ATOL_STATE = 1e-5
VAL_ATOL = 2e-4
TIE_RTOL = 2e-4


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _np(x):
    return np.array(x)


def _sets(mask):
    return set(np.flatnonzero(np.asarray(mask)).tolist())


# ---------------------------------------------------------------------------
# data and genuine operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    dict(seed=3, n_samples=77, n_features=31),
    dict(seed=0, n_samples=512, n_features=128, rho=0.5),
])
def test_make_d1_design_byte_identical(kw):
    a, b = jax_make_d1_design(**kw), make_d1_design(**kw)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _genuine(d, n, g, m, b, n_sel=6, sigma2=1.0, seed=0):
    """X (d, n) of the design; per lane a genuine W = M⁻¹X of a random
    n_sel-set; per (lane, sample) Woodbury factors E (d, b) of a random
    b-set by the reference's Cholesky formula, F = EᵀE.  numpy f32."""
    rng = np.random.default_rng(seed)
    X = np.ascontiguousarray(
        make_d1_design(seed=seed, n_samples=n, n_features=d), np.float64)
    isig2 = 1.0 / sigma2
    W = np.zeros((g, d, n))
    E = np.zeros((g, m, d, b))
    for gi in range(g):
        Xs = X[:, rng.choice(n, size=n_sel, replace=False)]
        M = np.eye(d) + isig2 * Xs @ Xs.T
        W[gi] = np.linalg.solve(M, X)
        for i in range(m):
            C = X[:, rng.choice(n, size=b, replace=False)]
            P = np.linalg.solve(M, C)
            Lk = np.linalg.cholesky(np.eye(b) + isig2 * C.T @ P)
            E[gi, i] = np.sqrt(isig2) * np.linalg.solve(Lk, P.T).T
    F = np.einsum("gmdb,gmdc->gmbc", E, E)
    f32 = [a.astype(np.float32) for a in (X, W, E, F)]
    return (*f32, isig2)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,n,g,parts", [(24, 48, 1, 4), (96, 64, 3, 2),
                                         (33, 1000, 2, 8)])
def test_aopt_gains_ref_bits_do_not_depend_on_width(d, n, g, parts):
    """A column's plain-version gain has the same bits in a call over
    all n columns and in one over a column block of them (the sharded
    runtime's ties break as on one device)."""
    X, W, _, _, isig2 = _genuine(d, n, g, 1, 1, sigma2=0.7)
    X, W = torch.from_numpy(X), torch.from_numpy(W)
    whole = aopt_gains_ref(X, W, isig2)
    w = n // parts
    blocks = torch.cat([aopt_gains_ref(X[:, i * w:(i + 1) * w].contiguous(),
                                       W[..., i * w:(i + 1) * w].contiguous(),
                                       isig2) for i in range(parts)], dim=-1)
    assert torch.equal(blocks, whole)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g", [(24, 50, 1), (64, 300, 3), (33, 129, 2)])
def test_aopt_gains_ref_matches(d, n, g, precision):
    """Plain version and CPU wrapper against JAX's reference and its
    Pallas kernel in interpret mode, lane by lane."""
    X, W, _, _, isig2 = _genuine(d, n, g, 1, 1, sigma2=0.7)
    Xq, Wq = (quantize(torch.from_numpy(a), precision) for a in (X, W))
    got = aopt_gains_ref(Xq, Wq, isig2)
    before = aopt_gains.launches
    wrapped = aopt_gains(torch.from_numpy(X), torch.from_numpy(W), isig2,
                         precision=precision)
    assert aopt_gains.launches == before          # CPU: the plain version
    assert got.shape == (g, n)
    _close(wrapped, got, rtol=0, atol=0)
    _close(aopt_gains(torch.from_numpy(X), torch.from_numpy(W[0]), isig2,
                      precision=precision), got[0], rtol=0, atol=0)
    jX, jW = (jax_quantize(jnp.asarray(a), precision) for a in (X, W))
    for gi in range(g):
        _close(got[gi], jax_aopt_gains_ref(jX, jW[gi], isig2))
        _close(got[gi], jax_aopt_gains(jnp.asarray(X), jnp.asarray(W[gi]),
                                       isig2, interpret=True,
                                       precision=precision))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,b", [
    (24, 50, 1, 2, 1),
    (64, 300, 2, 3, 4),
    (40, 129, 3, 5, 3),
])
def test_aopt_filter_lattice_ref_matches(d, n, g, m, b, precision):
    """The lattice plain version and the CPU wrapper against JAX's
    lattice reference and its engine in interpret mode, on genuine
    Woodbury operands."""
    X, W, E, F, isig2 = _genuine(d, n, g, m, b, sigma2=0.7)
    tX, tW, tE, tF = (torch.from_numpy(a) for a in (X, W, E, F))
    got = aopt_filter_gains_lattice_ref(quantize(tX, precision),
                                        quantize(tW, precision), tE, tF,
                                        isig2)
    assert got.shape == (g, m, n)
    before = aopt_filter_gains.launches
    _close(aopt_filter_gains(tX, tW, tE, tF, isig2, precision=precision),
           got, rtol=0, atol=0)
    assert aopt_filter_gains.launches == before
    jX, jW = (jax_quantize(jnp.asarray(a), precision) for a in (X, W))
    _close(got, jax_aopt_lattice_ref(jX, jW, jnp.asarray(E), jnp.asarray(F),
                                     isig2))
    _close(got, jax_aopt_filter_gains(jnp.asarray(X), jnp.asarray(W),
                                      jnp.asarray(E), jnp.asarray(F), isig2,
                                      interpret=True, precision=precision))


# ---------------------------------------------------------------------------
# the objective, lane by lane from stacked reference states
# ---------------------------------------------------------------------------

def _pair(d=48, n=120, kmax=16, seed=0, precision=None, sigma2=1.0):
    X = make_d1_design(seed=seed, n_samples=n, n_features=d)
    jobj = JaxAOpt(jnp.asarray(X), kmax=kmax, sigma2=sigma2,
                   precision=precision)
    tobj = aopt_objective_from_numpy(X, kmax, sigma2=sigma2,
                                     precision=precision, device="cpu")
    return jobj, tobj


def _jstate(jobj, sel):
    st = jobj.init()
    if sel:
        st = jobj.add_set(st, jnp.asarray(sel, jnp.int32),
                          jnp.ones(len(sel), bool))
    return st


SELS = [[], [1, 5], [0, 2, 4, 6, 8, 10, 12]]


def _lane_states(jobj, sels=SELS):
    """The reference's states for ``sels`` and the port's G-lane state
    built from their stacked fields."""
    jstates = [_jstate(jobj, s) for s in sels]
    fields = [np.stack([_np(s[i]) for s in jstates]) for i in range(5)]
    return jstates, aopt_state_from_numpy(*fields, device="cpu")


def test_init_matches():
    jobj, tobj = _pair()
    jst = jobj.init()
    tst = tobj.init(3)
    for name in ("M", "L", "W", "sel_mask", "value"):
        for g in range(3):
            np.testing.assert_array_equal(getattr(tst, name)[g].numpy(),
                                          _np(getattr(jst, name)))


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_gains_and_subset(precision):
    jobj, tobj = _pair(precision=precision, sigma2=0.5)
    jstates, tst = _lane_states(jobj)
    got = tobj.gains(tst)
    idx = np.array([[0, 3, 5, 7, 119, 20], [1, 5, 9, 2, 2, 60],
                    [12, 13, 14, 0, 8, 99]])
    sub = tobj.gains_subset(tst, torch.from_numpy(idx))
    for g, jst in enumerate(jstates):
        _close(got[g], jobj.gains(jst))
        _close(sub[g], jobj.gains_subset(jst, jnp.asarray(idx[g], jnp.int32)))


def test_set_gain():
    jobj, tobj = _pair()
    jstates, tst = _lane_states(jobj)
    idx = np.array([[[1, 4, 6, 30], [2, 2, 17, 0], [9, 10, 11, 12]]] * 3)
    idx[1, 0, 0], idx[2, 1, 3] = 5, 4          # members of S in the sets
    mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 1]], bool)
    mask = np.stack([mask] * 3)
    got = tobj.set_gain(tst, torch.from_numpy(idx), torch.from_numpy(mask))
    assert got.shape == (3, 3)
    for g, jst in enumerate(jstates):
        want = [jobj.set_gain(jst, jnp.asarray(i, jnp.int32), jnp.asarray(v))
                for i, v in zip(idx[g], mask[g])]
        _close(got[g], np.stack(want))


@pytest.mark.parametrize("add,valid", [
    ([[5, 6, 7], [8, 9, 10], [30, 31, 32]], [1, 1, 1]),
    ([[5, 40, 41], [1, 50, 51], [2, 4, 60]], [1, 1, 0]),   # S duplicates
])
def test_add_set(add, valid):
    jobj, tobj = _pair(sigma2=0.5)
    jstates, tst = _lane_states(jobj)
    idx = np.array(add)
    mask = np.tile(np.array(valid, bool), (3, 1))
    got = tobj.add_set(tst, torch.from_numpy(idx), torch.from_numpy(mask))
    for g, jst in enumerate(jstates):
        want = jobj.add_set(jst, jnp.asarray(idx[g], jnp.int32),
                            jnp.asarray(mask[g]))
        for name in ("M", "L", "W"):
            _close(getattr(got, name)[g], getattr(want, name),
                   atol=ATOL_STATE)
        np.testing.assert_array_equal(got.sel_mask[g].numpy(),
                                      _np(want.sel_mask))
        _close(got.value[g], want.value, atol=VAL_ATOL)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_expand_factors_and_filter_gains_batch(precision):
    """G = 3 lanes × 4 samples of 3 slots, some padded and some already
    in S, against the reference's per-lane methods."""
    jobj, tobj = _pair(precision=precision, sigma2=0.5)
    jstates, tst = _lane_states(jobj)
    rng = np.random.default_rng(4)
    idx = np.stack([[rng.choice(120, 3, replace=False) for _ in range(4)]
                    for _ in range(3)])
    idx[1, 0, 0], idx[2, 3, 2] = 5, 8            # members of S
    mask = rng.uniform(size=idx.shape) < 0.8
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    got = tobj.filter_gains_batch(tst, ti, tm)
    E, F = tobj.expand_factors(tst, ti, tm)
    assert got.shape == (3, 4, 120)
    for g, jst in enumerate(jstates):
        ji, jm = jnp.asarray(idx[g], jnp.int32), jnp.asarray(mask[g])
        _close(got[g], jobj.filter_gains_batch(jst, ji, jm))
        jE, jF = jax.vmap(lambda i, v: jobj.expand_factors(jst, i, v, jst.W))(
            ji, jm)
        _close(E[g], jE)
        _close(F[g], jF)
        # The reference's fresh-solve factors (no shared W) agree too.
        jE0, jF0 = jax.vmap(lambda i, v: jobj.expand_factors(jst, i, v))(
            ji, jm)
        _close(E[g], jE0, atol=ATOL_STATE)
        _close(F[g], jF0, atol=ATOL_STATE)


def test_value_matches_brute_value():
    jobj, tobj = _pair(sigma2=0.5)
    sel = [0, 2, 4, 6, 8, 10, 12, 33, 71]
    st = tobj.add_set(tobj.init(), torch.tensor([sel]),
                      torch.ones((1, len(sel)), dtype=torch.bool))
    _close(st.value[0], tobj.brute_value(sel), atol=VAL_ATOL)
    _close(tobj.brute_value(sel), jobj.brute_value(sel), atol=VAL_ATOL)


@pytest.mark.parametrize("sigma2", [1.0, 0.5])
def test_gamma_aopt_matches(sigma2):
    X = make_d1_design(seed=1, n_samples=300, n_features=40)
    tX = torch.from_numpy(X)
    _close(spectral.spectral_norm_sq(tX), jspectral.spectral_norm_sq(
        jnp.asarray(X)), rtol=1e-5)
    g = spectral.gamma_aopt(tX, 1.0, sigma2)
    _close(g, jspectral.gamma_aopt(jnp.asarray(X), 1.0, sigma2), rtol=1e-5)
    _close(spectral.alpha_from_gamma(g), jspectral.alpha_from_gamma(g.item()),
           rtol=1e-6)


# ---------------------------------------------------------------------------
# greedy, TOP-K, RANDOM and DASH on the small design (128 × 512, k = 32)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _design_pair(scaled: bool):
    """The example's design; ``scaled`` multiplies the columns by seeded
    factors in [0.5, 1.5], which breaks the exact ties of the unit-norm
    candidates."""
    X = make_d1_design(seed=0, n_samples=512, n_features=128)
    if scaled:
        X = X * np.random.default_rng(9).uniform(0.5, 1.5, size=(1, 512))
        X = X.astype(np.float32)
    return (JaxAOpt(jnp.asarray(X), kmax=32),
            aopt_objective_from_numpy(X, 32, device="cpu"))


def _check_decision(gains, pick, want):
    """The reference's pick ``want`` is the port's argmax ``pick`` or
    within TIE_RTOL of it; returns whether the margin was a tie."""
    top = float(gains[pick])
    tie = float(gains[want]) >= top * (1.0 - TIE_RTOL)
    assert pick == want or tie, (pick, want, top, float(gains[want]))
    return pick != want


@pytest.mark.parametrize("scaled", [False, True])
def test_greedy_decisions_match(scaled):
    """Teacher-forced along the reference's picks: at every step the
    port's argmax is the reference's pick, or the two are within
    TIE_RTOL in the port's gains; values agree within VAL_ATOL.  On the
    unit-norm design every first gain is 0.5 in exact arithmetic, so the
    first pick is an f32 tie; with the scaled columns no step may tie,
    and the port's own greedy run then picks the same sequence."""
    jobj, tobj = _design_pair(scaled)
    want = jax_greedy(jobj, 32)
    picks = _np(want.sel_idx)
    st, ties = tobj.init(), 0
    for i, a in enumerate(picks):
        g = tobj.gains(st)[0]
        ties += _check_decision(g, int(torch.argmax(g)), int(a))
        st = tobj.add_one(st, torch.tensor([int(a)]))
        _close(st.value[0], want.values[i], atol=VAL_ATOL)
    if scaled:
        assert ties == 0
        got = greedy(tobj, 32, device="cpu")
        np.testing.assert_array_equal(got.sel_idx.numpy(), picks)
        _close(got.values, want.values, atol=VAL_ATOL)


@pytest.mark.parametrize("scaled", [False, True])
def test_top_k_decisions_match(scaled):
    """Every member of the reference's TOP-K set lies within TIE_RTOL of
    the port's k-th gain, and the port's set holds every candidate above
    it by more; with the scaled columns the sets are equal."""
    jobj, tobj = _design_pair(scaled)
    want = _sets(jax_top_k_select(jobj, 32).sel_mask)
    got = baselines.top_k_select(tobj, 32, device="cpu")
    g = tobj.gains(tobj.init())[0]
    kth = float(torch.sort(g, descending=True).values[31])
    assert all(float(g[a]) >= kth * (1.0 - TIE_RTOL) for a in want)
    above = set(torch.nonzero(g > kth * (1.0 + TIE_RTOL)).flatten().tolist())
    assert above <= _sets(got.sel_mask)
    if scaled:
        assert _sets(got.sel_mask) == want
    _close(got.value, tobj.brute_value(sorted(_sets(got.sel_mask))),
           atol=VAL_ATOL)


def test_random_select_identical_set():
    jobj, tobj = _design_pair(False)
    key = jax.random.PRNGKey(1)
    want = jax_random_select(jobj, 32, key)
    got = baselines.random_select(tobj, 32, JaxKey(key), device="cpu")
    assert _sets(got.sel_mask) == _sets(want.sel_mask)
    _close(got.value, want.value, atol=VAL_ATOL)


def test_dash_auto_lattice_matches_per_guess():
    """The entry point's lattice (6 OPT guesses × α ∈ {0.3, 1}, 8
    samples) with the reference's noise: per guess the same set, the
    same filter iterations per round and values within VAL_ATOL."""
    jobj, tobj = _design_pair(False)
    kw = dict(eps=0.25, alpha=0.3, alphas=[0.3, 1.0], n_samples=8,
              n_guesses=6, return_lattice=True)
    key = jax.random.PRNGKey(0)
    wbest, want = jdash.dash_auto(jobj, 32, key, **kw)
    gbest, got = tdash.dash_auto(tobj, 32, JaxKey(key), device="cpu", **kw)
    assert got.value.shape == (12,)
    assert int(torch.sum(got.trace.filter_iters)) > 0
    for g in range(12):
        assert _sets(got.sel_mask[g]) == _sets(want.sel_mask[g]), g
        np.testing.assert_array_equal(got.trace.filter_iters[g].numpy(),
                                      _np(want.trace.filter_iters[g]))
        _close(got.value[g], want.value[g], atol=VAL_ATOL)
    assert _sets(gbest.sel_mask) == _sets(wbest.sel_mask)
    assert int(gbest.rounds) == int(wbest.rounds)


def test_entry_point_runs_on_cpu():
    from repro_torch import experimental_design

    out = experimental_design.main(device="cpu", d=32, n=256, k=8,
                                   verbose=False)
    assert len(out["lanes"]) == 12 and out["alphas"] == [0.3, 1.0]
    assert [lane["alpha"] for lane in out["lanes"][:2]] == [0.3, 1.0]
    for algo in ("greedy", "dash", "topk", "random"):
        assert 0.0 <= out[algo + "_value"] <= 32.0
    assert out["dash_selected"] <= 8
