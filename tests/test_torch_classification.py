"""The port's logistic-classification slice against the JAX reference, on
the CPU.

The same seeded numpy inputs go through the JAX functions and the port's
counterparts; objective states start equal — the JAX objective builds
them and their fields cross as numpy arrays through
``repro_torch.convert``.  The JAX Newton-sweep kernels run as the JAX
package's own tests run them: through their references and in Pallas
interpret mode.

Tolerances:
  * gains of the Newton sweeps (kernels' plain versions, objective
    oracles): rtol 1e-5 and, per state, atol 2·ε_f32·√d·ℓ_abs(η) with
    ℓ_abs(η) = Σ_i |y_i η_i − softplus(η_i)| — both packages take the
    gain as ℓ_new − ℓ_old, the difference of two f32 sums of order
    d·ln 2, in another summation order; ε_f32·√d·ℓ_abs is the size of
    that cancellation in one of them, the chip's gate for the kernels
    (at d ≤ 600 at most about 2.4e-3 for the two, at η = 0, against
    gains of 10 to 300);
  * ATOL_STATE 1e-4 on refit logits η and weights w (eight IRLS steps of
    batched Cholesky solves in another LAPACK; |η| ≤ 30 here);
  * VAL_ATOL 1e-3 on values f(S) = ℓ − ℓ(0) (sums of order d·ln 2 ≤ 416,
    about 20 ε_f32 of them);
  * TIE_RTOL 1e-4 on decision margins: a greedy or TOP-K decision is
    compared only where its margin exceeds it.
DASH with the reference's noise (``JaxKey``) must select the same set
with the same filter iterations per guess, values within VAL_ATOL.
"""

import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.baselines import random_select as jax_random_select  # noqa: E402
from repro.core.baselines import top_k_select as jax_top_k_select  # noqa: E402
from repro.core.greedy import greedy as jax_greedy  # noqa: E402
from repro.core.objectives import ClassificationObjective as JaxClass  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_d3_classification as jax_make_d3_classification,
)
from repro.kernels.common import quantize as jax_quantize  # noqa: E402
from repro.kernels.filter_gains.ops import (  # noqa: E402
    logistic_filter_gains as jax_logistic_filter_gains,
)
from repro.kernels.filter_gains.ref import (  # noqa: E402
    logistic_filter_gains_lattice_ref as jax_logistic_lattice_ref,
)
from repro.kernels.logistic_gains.ops import (  # noqa: E402
    logistic_gains as jax_logistic_gains,
)
from repro.kernels.logistic_gains.ref import (  # noqa: E402
    logistic_gains_ref as jax_logistic_gains_ref,
)
from repro_torch.convert import (  # noqa: E402
    classification_objective_from_numpy,
    classification_state_from_numpy,
)
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.greedy import greedy  # noqa: E402
from repro_torch.data.synthetic import make_d3_classification  # noqa: E402
from repro_torch.kernels.common import quantize  # noqa: E402
from repro_torch.kernels.filter_gains import (  # noqa: E402
    logistic_filter_gains,
    logistic_filter_gains_lattice_ref,
)
from repro_torch.kernels.logistic_gains import (  # noqa: E402
    logistic_gains,
    logistic_gains_ref,
)
from test_torch_dash import JaxKey  # noqa: E402

# The packages export functions named like these modules.
jdash = importlib.import_module("repro.core.dash")
tdash = importlib.import_module("repro_torch.core.dash")

REPO = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)
RTOL = 1e-5
ATOL_STATE = 1e-4
VAL_ATOL = 1e-3
TIE_RTOL = 1e-4
FIELDS = ("sel_idx", "sel_k", "w", "eta", "sel_mask", "value")


def _np(x):
    return np.array(x)


def _sets(mask):
    return set(np.flatnonzero(np.asarray(mask)).tolist())


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def gain_atol(y, etas):
    """2·ε_f32·√d·ℓ_abs(η) per state: etas (..., d) → (..., 1)."""
    etas = np.asarray(etas, np.float64)
    labs = np.sum(np.abs(np.asarray(y) * etas - np.logaddexp(etas, 0.0)),
                  axis=-1, keepdims=True)
    return 2.0 * EPS32 * np.sqrt(etas.shape[-1]) * labs


def _close_gains(got, want, y, etas):
    """Gains (..., n) at logits etas (..., d) within RTOL and the
    per-state cancellation floor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = gain_atol(y, etas) + RTOL * np.abs(want)
    assert np.all(np.abs(got - want) <= lim), float(
        np.max(np.abs(got - want) - lim))


# ---------------------------------------------------------------------------
# data and genuine logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    dict(seed=3, n_samples=77, n_features=31, support=5),
    dict(seed=0, n_samples=600, n_features=200, support=50, rho=0.5),
])
def test_make_d3_classification_byte_identical(kw):
    want, got = jax_make_d3_classification(**kw), make_d3_classification(**kw)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _genuine(d, n, g, m, seed=0):
    """D3 features X (d, n) and labels y, and the refit logits (g, m, d)
    of g·m random supports of 1 to 6 features, each fitted by the port's
    objective (the first one is the empty set, η = 0).  numpy f32."""
    X, y, _ = make_d3_classification(seed=seed, n_samples=d, n_features=n,
                                     support=max(1, n // 4))
    obj = classification_objective_from_numpy(X, y, 6, device="cpu")
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=6, replace=False)
                    for _ in range(g * m)])
    mask = np.arange(6)[None, :] < rng.integers(1, 7, size=(g * m, 1))
    mask[0] = False
    st = obj.add_set(obj.init(g * m), torch.from_numpy(idx),
                     torch.from_numpy(mask))
    return X, y, st.eta.numpy().reshape(g, m, d)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,steps", [
    (24, 50, 1, 1), (64, 300, 3, 3), (33, 129, 2, 4), (600, 200, 2, 3),
])
def test_logistic_gains_ref_matches(d, n, g, steps, precision):
    """Plain version and CPU wrapper (with and without a lane axis)
    against JAX's reference and its Pallas kernel in interpret mode."""
    X, y, etas = _genuine(d, n, g, 1)
    E = etas[:, 0]
    tX, ty, tE = (torch.from_numpy(a) for a in (X, y, E))
    Xq = quantize(tX, precision)
    got = torch.stack([logistic_gains_ref(Xq, ty, e, steps=steps)
                       for e in tE])
    before = logistic_gains.launches
    _close(logistic_gains(tX, ty, tE, steps=steps, precision=precision), got,
           rtol=0)
    _close(logistic_gains(tX, ty, tE[0], steps=steps, precision=precision),
           got[0], rtol=0)
    assert logistic_gains.launches == before      # CPU: the plain version
    jX = jax_quantize(jnp.asarray(X), precision)
    for gi in range(g):
        _close_gains(got[gi], jax_logistic_gains_ref(
            jX, jnp.asarray(y), jnp.asarray(E[gi]), steps=steps), y, E[gi])
        _close_gains(got[gi], jax_logistic_gains(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(E[gi]), steps=steps,
            interpret=True, precision=precision), y, E[gi])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,steps", [
    (24, 50, 1, 2, 3), (64, 300, 2, 3, 1), (40, 129, 3, 5, 4),
])
def test_logistic_filter_lattice_ref_matches(d, n, g, m, steps, precision):
    """The lattice plain version and the CPU wrapper against JAX's
    lattice reference and its engine in interpret mode."""
    X, y, etas = _genuine(d, n, g, m, seed=1)
    tX, ty, tE = (torch.from_numpy(a) for a in (X, y, etas))
    got = logistic_filter_gains_lattice_ref(quantize(tX, precision), ty, tE,
                                            steps=steps)
    assert got.shape == (g, m, n)
    before = logistic_filter_gains.launches
    _close(logistic_filter_gains(tX, ty, tE, steps=steps,
                                 precision=precision), got, rtol=0)
    assert logistic_filter_gains.launches == before
    jX = jax_quantize(jnp.asarray(X), precision)
    _close_gains(got, jax_logistic_lattice_ref(
        jX, jnp.asarray(y), jnp.asarray(etas), steps=steps), y, etas)
    _close_gains(got, jax_logistic_filter_gains(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(etas), steps=steps,
        interpret=True, precision=precision), y, etas)


def _width_invariant(fn, X, n):
    """``fn(X_block)`` over all n columns equals its calls over n/2 and
    n/4 of them, bit for bit."""
    whole = fn(X)
    for parts in (2, 4):
        w = n // parts
        got = torch.cat([fn(X[:, i * w:(i + 1) * w].contiguous())
                         for i in range(parts)], dim=-1)
        assert torch.equal(got, whole), parts


@pytest.mark.parametrize("d,n,steps", [(24, 48, 1), (120, 32, 2),
                                       (600, 200, 3), (64, 1000, 3)])
def test_logistic_gains_ref_bits_do_not_depend_on_width(d, n, steps):
    """A column's plain-version gain has the same bits in a call over all
    n columns and in one over a block of them (the sharded runtime's
    ties break as on one device)."""
    X, y, etas = _genuine(d, n, 1, 2)
    ty, te = torch.from_numpy(y), torch.from_numpy(etas[0, 1])
    _width_invariant(lambda Xb: logistic_gains_ref(Xb, ty, te, steps=steps),
                     torch.from_numpy(X), n)


@pytest.mark.parametrize("d,n,g,m", [(24, 48, 1, 2), (120, 32, 2, 3),
                                     (200, 400, 2, 4)])
def test_logistic_filter_gains_ref_bits_do_not_depend_on_width(d, n, g, m):
    """As above, for the logistic filter engine's plain version."""
    X, y, etas = _genuine(d, n, g, m, seed=2)
    ty, tE = torch.from_numpy(y), torch.from_numpy(etas)
    _width_invariant(
        lambda Xb: logistic_filter_gains_lattice_ref(Xb, ty, tE, steps=3),
        torch.from_numpy(X), n)


def test_wrappers_check_their_arguments():
    X, y, etas = _genuine(16, 20, 1, 2)
    tX, ty, tE = (torch.from_numpy(a) for a in (X, y, etas))
    with pytest.raises(ValueError):
        logistic_gains(tX, ty, tE[0, 0], steps=-1)
    with pytest.raises(ValueError):
        logistic_filter_gains(tX, ty, tE[0], steps=2)        # (m, d)
    with pytest.raises(ValueError):
        logistic_filter_gains(tX, ty, tE, precision="fp8")


# ---------------------------------------------------------------------------
# the objective, lane by lane from stacked reference states
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _problem(d=120, n=60, seed=0):
    X, y, _ = make_d3_classification(seed=seed, n_samples=d, n_features=n,
                                     support=15)
    return X, y


@functools.lru_cache(maxsize=None)
def _pair(kmax=8, precision=None, gain_mode="newton1d"):
    X, y = _problem()
    jobj = JaxClass(jnp.asarray(X), jnp.asarray(y), kmax=kmax,
                    precision=precision, gain_mode=gain_mode)
    tobj = classification_objective_from_numpy(
        X, y, kmax, precision=precision, gain_mode=gain_mode, device="cpu")
    return jobj, tobj


@functools.lru_cache(maxsize=None)
def _jit(jobj, name):
    """The reference objective's method ``name``, compiled once."""
    return jax.jit(getattr(jobj, name))


def _jstate(jobj, sel):
    st = jobj.init()
    if sel:
        st = _jit(jobj, "add_set")(st, jnp.asarray(sel, jnp.int32),
                                   jnp.ones(len(sel), bool))
    return st


SELS = [[], [1, 5], [0, 2, 4, 6, 8, 10, 12]]


def _lane_states(jobj, sels=SELS):
    """The reference's states for ``sels`` and the port's G-lane state
    built from their stacked fields."""
    jstates = [_jstate(jobj, s) for s in sels]
    fields = [np.stack([_np(getattr(s, f)) for s in jstates]) for f in FIELDS]
    return jstates, classification_state_from_numpy(*fields, device="cpu")


def _weights_by_column(sel_idx, sel_k, w, n):
    """Total weight per feature: a feature held in two slots (a duplicate
    in R) has one identifiable weight, their sum, however the ridge-
    regularized solve splits it."""
    out = np.zeros(n)
    np.add.at(out, np.asarray(sel_idx)[np.asarray(sel_k)],
              np.asarray(w, np.float64)[np.asarray(sel_k)])
    return out


def _close_state(got, want, g):
    np.testing.assert_array_equal(got.sel_idx[g].numpy(), _np(want.sel_idx))
    np.testing.assert_array_equal(got.sel_k[g].numpy(), _np(want.sel_k))
    np.testing.assert_array_equal(got.sel_mask[g].numpy(),
                                  _np(want.sel_mask))
    n = got.sel_mask.shape[-1]
    _close(_weights_by_column(got.sel_idx[g], got.sel_k[g], got.w[g], n),
           _weights_by_column(want.sel_idx, want.sel_k, want.w, n),
           atol=ATOL_STATE)
    _close(got.eta[g], want.eta, atol=ATOL_STATE)
    _close(got.value[g], want.value, rtol=0, atol=VAL_ATOL)


def test_init_matches():
    jobj, tobj = _pair()
    jst, tst = jobj.init(), tobj.init(3)
    for name in FIELDS:
        for g in range(3):
            np.testing.assert_array_equal(getattr(tst, name)[g].numpy(),
                                          _np(getattr(jst, name)))
    _close(tobj.ll0, jobj.ll0, rtol=1e-6)


@pytest.mark.parametrize("precision,gain_mode", [
    (None, "newton1d"), ("bf16", "newton1d"), (None, "quadratic"),
])
def test_gains_and_subset(precision, gain_mode):
    jobj, tobj = _pair(precision=precision, gain_mode=gain_mode)
    jstates, tst = _lane_states(jobj)
    got = tobj.gains(tst)
    idx = np.array([[0, 3, 5, 7, 59, 20], [1, 5, 9, 2, 2, 40],
                    [12, 13, 14, 0, 8, 33]])
    sub = tobj.gains_subset(tst, torch.from_numpy(idx))
    y = _problem()[1]
    for g, jst in enumerate(jstates):
        eta = _np(jst.eta)
        _close_gains(got[g], _jit(jobj, "gains")(jst), y, eta)
        _close_gains(sub[g], _jit(jobj, "gains_subset")(
            jst, jnp.asarray(idx[g], jnp.int32)), y, eta)
        _close_gains(sub[g], got[g, idx[g]], y, eta)


def test_set_gain():
    """Sets with padding and with members of S, per lane against the
    reference; no capacity cut (the support is kcap + m slots)."""
    jobj, tobj = _pair()
    jstates, tst = _lane_states(jobj)
    idx = np.array([[[1, 4, 6, 30], [2, 2, 17, 0], [9, 11, 13, 15]]] * 3)
    idx[1, 0, 0], idx[2, 1, 3] = 5, 4          # members of S in the sets
    mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 1]], bool)
    mask = np.stack([mask] * 3)
    got = tobj.set_gain(tst, torch.from_numpy(idx), torch.from_numpy(mask))
    assert got.shape == (3, 3)
    for g, jst in enumerate(jstates):
        want = [_jit(jobj, "set_gain")(jst, jnp.asarray(i, jnp.int32),
                                       jnp.asarray(v))
                for i, v in zip(idx[g], mask[g])]
        _close(got[g], np.stack(want), rtol=0, atol=VAL_ATOL)


@pytest.mark.parametrize("add,valid", [
    ([[5, 6, 7], [8, 9, 10], [30, 31, 32]], [1, 1, 1]),
    ([[5, 40, 41], [1, 50, 51], [2, 4, 50]], [1, 1, 0]),   # S members, pad
    ([[7, 7, 3], [9, 9, 5], [44, 44, 45]], [1, 1, 1]),     # duplicates in R
])
def test_add_set(add, valid):
    """add_set per lane against the reference: slots, weights, logits,
    membership and value.  The third lane holds 7 of kmax = 8 slots, so
    the first and last cases overflow past kmax."""
    jobj, tobj = _pair()
    jstates, tst = _lane_states(jobj)
    idx = np.array(add)
    mask = np.tile(np.array(valid, bool), (3, 1))
    got = tobj.add_set(tst, torch.from_numpy(idx), torch.from_numpy(mask))
    for g, jst in enumerate(jstates):
        want = _jit(jobj, "add_set")(jst, jnp.asarray(idx[g], jnp.int32),
                                     jnp.asarray(mask[g]))
        _close_state(got, want, g)


def test_greedy_steps_fill_to_kmax_and_add_one():
    jobj, tobj = _pair(kmax=3)
    jst, tst = jobj.init(), tobj.init()
    for a in (4, 9, 4, 17, 23):                 # a repeat, then overflow
        jst = _jit(jobj, "add_one")(jst, a)
        tst = tobj.add_one(tst, torch.tensor([a]))
        _close_state(tst, jst, 0)


@pytest.mark.parametrize("precision,gain_mode", [
    (None, "newton1d"), ("bf16", "newton1d"), (None, "quadratic"),
])
def test_expand_logits_and_filter_gains_batch(precision, gain_mode):
    """G = 3 lanes × 4 samples of 3 slots, some padded, some already in
    S, some past kmax, against the reference's per-lane methods."""
    jobj, tobj = _pair(precision=precision, gain_mode=gain_mode)
    jstates, tst = _lane_states(jobj)
    rng = np.random.default_rng(4)
    idx = np.stack([[rng.choice(60, 3, replace=False) for _ in range(4)]
                    for _ in range(3)])
    idx[1, 0, 0], idx[2, 3, 2] = 5, 8            # members of S
    mask = rng.uniform(size=idx.shape) < 0.8
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    etas = tobj.expand_logits(tst, ti, tm)
    got = tobj.filter_gains_batch(tst, ti, tm)
    assert etas.shape == (3, 4, 120) and got.shape == (3, 4, 60)
    y = _problem()[1]
    for g, jst in enumerate(jstates):
        ji, jm = jnp.asarray(idx[g], jnp.int32), jnp.asarray(mask[g])
        want_eta = jax.vmap(_jit(jobj, "expand_logits"),
                            in_axes=(None, 0, 0))(jst, ji, jm)
        _close(etas[g], want_eta, atol=ATOL_STATE)
        _close_gains(got[g], _jit(jobj, "filter_gains_batch")(jst, ji, jm), y,
                     _np(want_eta))


def test_value_matches_brute_value():
    jobj, tobj = _pair(kmax=12)
    sel = [0, 2, 4, 6, 8, 10, 12, 33, 51]
    st = tobj.add_set(tobj.init(), torch.tensor([sel]),
                      torch.ones((1, len(sel)), dtype=torch.bool))
    assert abs(float(st.value[0]) - float(tobj.brute_value(sel))) < 0.05
    _close(tobj.brute_value(sel), jobj.brute_value(sel), rtol=0,
           atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# greedy, TOP-K, RANDOM and DASH on the small D3 (600 × 200, k = 20)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _d3_pair():
    X, y, _ = make_d3_classification(n_samples=600, n_features=200,
                                     support=50)
    return (JaxClass(jnp.asarray(X), jnp.asarray(y), kmax=20),
            classification_objective_from_numpy(X, y, 20, device="cpu"))


def _check_decision(gains, pick, want):
    """The reference's pick ``want`` is the port's argmax ``pick`` or
    within TIE_RTOL of it."""
    top = float(gains[pick])
    assert pick == want or float(gains[want]) >= top * (1.0 - TIE_RTOL), (
        pick, want, top, float(gains[want]))


def test_greedy_matches():
    """Teacher-forced along the reference's picks, every step's argmax
    agrees or ties within TIE_RTOL, values within VAL_ATOL; the port's
    own greedy run picks the reference's sequence."""
    jobj, tobj = _d3_pair()
    want = jax_greedy(jobj, 20)
    picks = _np(want.sel_idx)
    st = tobj.init()
    for i, a in enumerate(picks):
        g = tobj.gains(st)[0]
        _check_decision(g, int(torch.argmax(g)), int(a))
        st = tobj.add_one(st, torch.tensor([int(a)]))
        _close(st.value[0], want.values[i], rtol=0, atol=VAL_ATOL)
    got = greedy(tobj, 20, device="cpu")
    np.testing.assert_array_equal(got.sel_idx.numpy(), picks)
    _close(got.values, want.values, rtol=0, atol=VAL_ATOL)


def test_top_k_matches():
    jobj, tobj = _d3_pair()
    want = jax_top_k_select(jobj, 20)
    got = baselines.top_k_select(tobj, 20, device="cpu")
    assert _sets(got.sel_mask) == _sets(want.sel_mask)
    _close(got.value, want.value, rtol=0, atol=VAL_ATOL)


def test_random_select_identical_set():
    jobj, tobj = _d3_pair()
    key = jax.random.PRNGKey(1)
    want = jax_random_select(jobj, 20, key)
    got = baselines.random_select(tobj, 20, JaxKey(key), device="cpu")
    assert _sets(got.sel_mask) == _sets(want.sel_mask)
    _close(got.value, want.value, rtol=0, atol=VAL_ATOL)


def test_dash_auto_lattice_matches_per_guess():
    """The benchmark's DASH (6 OPT guesses, eps 0.25, α 0.6, 8 samples)
    with the reference's noise: per guess the same set, the same filter
    iterations per round and values within VAL_ATOL."""
    jobj, tobj = _d3_pair()
    kw = dict(eps=0.25, alpha=0.6, n_samples=8, n_guesses=6,
              return_lattice=True)
    key = jax.random.PRNGKey(0)
    wbest, want = jdash.dash_auto(jobj, 20, key, **kw)
    gbest, got = tdash.dash_auto(tobj, 20, JaxKey(key), device="cpu", **kw)
    assert got.value.shape == (6,)
    assert int(torch.sum(got.trace.filter_iters)) > 0
    for g in range(6):
        assert _sets(got.sel_mask[g]) == _sets(want.sel_mask[g]), g
        np.testing.assert_array_equal(got.trace.filter_iters[g].numpy(),
                                      _np(want.trace.filter_iters[g]))
        _close(got.value[g], want.value[g], rtol=0, atol=VAL_ATOL)
    assert _sets(gbest.sel_mask) == _sets(wbest.sel_mask)
    assert int(gbest.rounds) == int(wbest.rounds)


def test_entry_point_runs_on_cpu():
    from repro_torch import classification

    out = classification.main(device="cpu", d=120, n=60, k=6, support=15,
                              verbose=False)
    assert len(out["lanes"]) == 6
    assert all(lane["alpha"] == 0.6 for lane in out["lanes"])
    bound = 120 * np.log(2.0)
    for algo in ("greedy", "dash", "topk", "random"):
        assert 0.0 <= out[algo + "_value"] <= bound
    assert out["dash_selected"] <= 6
    assert out["greedy_value"] >= out["topk_value"]


def test_slice_modules_import_no_jax_and_no_repro():
    mods = ["repro_torch.classification",
            "repro_torch.core.objectives.classification",
            "repro_torch.kernels.logistic_gains",
            "repro_torch.kernels.filter_gains"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
