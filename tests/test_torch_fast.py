"""The port's FAST and adaptive sequencing against the JAX reference.

The same seeded numpy inputs — the three objectives of the reference's
baseline suite at scale 1 (``benchmarks/bench_selection.py::
_baseline_datasets``: regression 96 × 64, k 8; A-optimal design 24 × 48,
k 6; logistic 96 × 32, k 4) — go through the JAX functions and the
port's, the port's noise drawn through ``JaxKey``, which replays the
reference's ``split``, ``fold_in`` and Gumbel draws exactly.  Both
packages score the insertion prefixes through their filter engines.

Tolerances: the same selected set and the same round count; values
within VAL_RTOL 1e-5 relative plus VAL_ATOL 1e-4 (f32 sums in another
order; the logistic values reach tens); prefix gains within PREFIX_TOL
(rtol 1e-4, atol 1e-5 regression and design; the logistic gains are
differences of two f32 sums of order d·ln 2, so atol 1e-3 there).
Every threshold decision compares bf16-quantized values in both.
"""

import functools
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.bench_selection import _baseline_datasets  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.core.adaptive_sequencing import (  # noqa: E402
    adaptive_sequencing as jax_adaptive_sequencing,
)
from repro.core.greedy import greedy as jax_greedy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AOptimalityObjective,
    ClassificationObjective,
    RegressionObjective,
)
from repro_torch.core.adaptive_sequencing import adaptive_sequencing  # noqa: E402

# The packages export functions named like these modules.
jfast = importlib.import_module("repro.core.fast")
tfast = importlib.import_module("repro_torch.core.fast")

VAL_RTOL, VAL_ATOL = 1e-5, 1e-4
PREFIX_TOL = {"regression": (1e-4, 1e-5), "aopt": (1e-4, 1e-5),
              "logistic": (1e-4, 1e-3)}
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


def port_objective(jobj, **kw):
    """The port's objective over the reference objective's inputs
    (``kw`` passes on to its constructor)."""
    X = np.array(jobj.X)
    if hasattr(jobj, "isig2"):
        return AOptimalityObjective(X, jobj.kmax, beta2=jobj.beta2,
                                    sigma2=1.0 / jobj.isig2, device="cpu",
                                    **kw)
    y = np.array(jobj.y)
    if hasattr(jobj, "newton_steps"):
        return ClassificationObjective(
            X, y, jobj.kmax, newton_steps=jobj.newton_steps,
            newton_gain_steps=jobj.newton_gain_steps, device="cpu", **kw)
    return RegressionObjective(X, y, jobj.kmax, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def problem(name):
    """(reference objective, port objective, k, select-opts)."""
    for nm, make_obj, X, k_grid, opts in _baseline_datasets(1):
        if nm == name:
            jobj = make_obj(X)
            return jobj, port_objective(jobj), k_grid[-1], opts
    raise KeyError(name)


def _np(x):
    return np.array(x)


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=VAL_RTOL,
                               atol=VAL_ATOL)


def _same_run(got, want):
    np.testing.assert_array_equal(got.sel_mask.numpy(), _np(want.sel_mask))
    assert int(got.sel_count) == int(want.sel_count)
    assert int(got.rounds) == int(want.rounds)
    _close(got.value, want.value)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_q_cmp_rounds_as_jax():
    """bf16 round to nearest even, ties and near-ties included."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(
        -6, 3, size=4096)
    # exact halfway points between bf16 neighbours, both parities
    half = (np.arange(1, 257, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    x = np.concatenate([x, half, -half, [0.0, np.inf, -np.inf]]).astype(
        np.float32)
    got = tfast.q_cmp(torch.from_numpy(x)).float().numpy()
    want = np.asarray(jfast.q_cmp(jnp.asarray(x)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", [1, 5, 8])
def test_prefix_masks(L):
    np.testing.assert_array_equal(tfast.prefix_masks(L).numpy(),
                                  _np(jfast.prefix_masks(L)))


@pytest.mark.parametrize("k,eps", [(1, 0.06), (8, 0.2), (40, 0.06),
                                   (128, 0.06), (128, 0.25)])
def test_ladder_and_round_cap(k, eps):
    assert tfast.ladder_levels(k, eps) == jfast.ladder_levels(k, eps)
    assert tfast.fast_round_cap(k, eps) == jfast.fast_round_cap(k, eps)
    for n in (1, 32, 8192):
        assert tfast.fast_cost(n, k, eps) == jfast.fast_cost(n, k, eps)


def test_binary_search_probes_and_merge():
    """The probe sequence, the fold_in keys and the running-best merge
    (a NaN value never wins) on a stand-in core whose value is a fixed
    function of the guess."""
    guesses = np.geomspace(0.1, 3.0, 8).astype(np.float32)
    table = {0: 0.2, 1: float("nan"), 2: 0.45, 3: 0.5, 4: 0.52, 5: 0.4,
             6: 0.6, 7: 0.7}

    def core_for(mod, res_type):
        seen = []

        def run(key, g):
            i = int(np.argmin(np.abs(guesses - float(g))))
            seen.append((i, np.array(key.key if hasattr(key, "key") else key)))
            v = table[i]
            return res_type(
                sel_mask=mod.full((4,), i % 2 == 0), sel_count=mod.asarray(i),
                value=mod.asarray(v, dtype=mod.float32),
                rounds=mod.asarray(i + 1), values=mod.zeros((3,)),
                opt=mod.asarray(g))
        return run, seen

    key = jax.random.PRNGKey(7)
    jrun, jseen = core_for(jnp, jfast.FastResult)
    want = jfast.binary_search_opt(jrun, key, jnp.asarray(guesses), 0.06)
    trun, tseen = core_for(torch, tfast.FastResult)
    got = tfast.binary_search_opt(trun, JaxKey(key),
                                  torch.from_numpy(guesses), 0.06)
    assert [i for i, _ in tseen] == [i for i, _ in jseen]
    for (_, tk), (_, jk) in zip(tseen, jseen):
        np.testing.assert_array_equal(tk, jk)
    assert int(got.rounds) == int(want.rounds)
    assert float(got.opt) == float(want.opt)


@pytest.mark.parametrize("name", NAMES)
def test_sequence_prefix_gains_row_by_row(name):
    """Every prefix row of one engine call against the reference's, from
    a state with two elements selected; ragged slot validity."""
    jobj, tobj, k, _ = problem(name)
    n = jobj.n
    L = min(k, n)
    rng = np.random.default_rng(1)
    seq = rng.permutation(n)[:L].astype(np.int32)
    ok = np.ones(L, bool)
    ok[L - 1] = False                       # a padded last slot
    sel = np.asarray([seq[0] ^ 1, (seq[1] + 7) % n], np.int32)
    jst = jobj.add_set(jobj.init(), jnp.asarray(sel), jnp.ones(2, bool))
    tst = tobj.add_set(tobj.init(), torch.from_numpy(sel).long()[None],
                       torch.ones((1, 2), dtype=torch.bool))
    wG, wm = jfast.sequence_prefix_gains(jobj, jst, jnp.asarray(seq),
                                         jnp.asarray(ok), engine=True)
    gG, gm = tfast.sequence_prefix_gains(tobj, tst,
                                         torch.from_numpy(seq).long(),
                                         torch.from_numpy(ok), engine=True)
    rtol, atol = PREFIX_TOL[name]
    assert tuple(gG.shape) == (L + 1, n)
    for j in range(L + 1):
        np.testing.assert_allclose(gG[j].numpy(), _np(wG[j]), rtol=rtol,
                                   atol=atol, err_msg=f"prefix {j}")
    np.testing.assert_allclose(gm.numpy(), _np(wm), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_per_prefix_path(name):
    """The engine's L + 1 prefix rows against one gains(add_set) per
    prefix, and a whole FAST run down each path."""
    jobj, tobj, k, _ = problem(name)
    L = min(k, tobj.n)
    rng = np.random.default_rng(2)
    seq = torch.from_numpy(rng.permutation(tobj.n)[:L]).long()
    ok = torch.ones(L, dtype=torch.bool)
    st = tobj.init()
    a, am = tfast.sequence_prefix_gains(tobj, st, seq, ok, engine=True)
    b, bm = tfast.sequence_prefix_gains(tobj, st, seq, ok, engine=False)
    rtol, atol = PREFIX_TOL[name]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(am.numpy(), bm.numpy(), rtol=rtol, atol=atol)
    key = jax.random.PRNGKey(3)
    on = tfast.fast(tobj, k, JaxKey(key), device="cpu")
    off = tfast.fast(port_objective(jobj, use_filter_engine=False), k,
                     JaxKey(key), device="cpu")
    np.testing.assert_array_equal(on.sel_mask.numpy(), off.sel_mask.numpy())
    assert int(on.rounds) == int(off.rounds)
    _close(on.value, off.value)


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fast_pinned_opt_matches(name):
    """One ladder run at a pinned OPT guess (greedy's value)."""
    jobj, tobj, k, _ = problem(name)
    opt = float(jax_greedy(jobj, k).value)
    key = jax.random.PRNGKey(0)
    want = jfast.fast(jobj, k, key, opt=opt)
    got = tfast.fast(tobj, k, JaxKey(key), opt=opt, device="cpu")
    _same_run(got, want)
    np.testing.assert_allclose(got.values.numpy(), _np(want.values),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    assert float(got.opt) == float(want.opt)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed,eps", [(0, 0.06), (4, 0.2)])
def test_fast_binary_search_matches(name, seed, eps):
    """The binary search over the default 8-guess lattice: the probes'
    keys, the merge and every decision."""
    jobj, tobj, k, _ = problem(name)
    key = jax.random.PRNGKey(seed)
    want = jfast.fast(jobj, k, key, eps=eps)
    got = tfast.fast(tobj, k, JaxKey(key), eps=eps, device="cpu")
    _same_run(got, want)
    _close(got.opt, want.opt)      # the lattice scales the top gain
    assert int(got.rounds) <= tfast.fast_round_cap(k, eps)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 5])
def test_adaptive_sequencing_matches(name, seed):
    jobj, tobj, k, opts = problem(name)
    key = jax.random.PRNGKey(seed)
    kw = dict(eps=opts["eps"], alpha=opts["alpha"])
    want = jax_adaptive_sequencing(jobj, k, key, **kw)
    got = adaptive_sequencing(tobj, k, JaxKey(key), device="cpu", **kw)
    _same_run(got, want)


def test_adaptive_sequencing_rounds_and_opt():
    """An explicit round budget and OPT guess pass through as in the
    reference."""
    jobj, tobj, k, _ = problem("regression")
    key = jax.random.PRNGKey(9)
    opt = 0.5 * float(jax_greedy(jobj, k).value)
    want = jax_adaptive_sequencing(jobj, k, key, rounds=2, opt=opt)
    got = adaptive_sequencing(tobj, k, JaxKey(key), rounds=2, opt=opt,
                              device="cpu")
    _same_run(got, want)
    assert int(got.rounds) <= 2
    assert math.isfinite(float(got.value))
