"""The port's kernel modules against the JAX reference, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
references, the JAX Pallas kernels in interpret mode, and the port's
plain versions / wrappers (which take the plain route for CPU tensors).
Tolerance: ``STREAM_PARITY_TOL[...]["kernel_vs_ref"]`` = 2e-4 rtol and
atol, as the JAX package's own kernel-vs-reference tests.  Also the
guard tests: the port imports neither JAX nor ``repro``, and its entry
points refuse to fall back to the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.common import quantize as jax_quantize  # noqa: E402
from repro.kernels.filter_gains.ops import (  # noqa: E402
    aopt_filter_gains as jax_aopt_filter_gains,
    filter_gains as jax_filter_gains,
)
from repro.kernels.filter_gains.ref import (  # noqa: E402
    aopt_filter_gains_lattice_ref as jax_aopt_lattice_ref,
    filter_gains_lattice_ref as jax_filter_gains_lattice_ref,
    filter_gains_ref as jax_filter_gains_ref,
)
from repro.kernels.marginal_gains.ops import (  # noqa: E402
    regression_gains as jax_regression_gains,
)
from repro.kernels.marginal_gains.ref import (  # noqa: E402
    regression_gains_ref as jax_regression_gains_ref,
)
from repro_torch.kernels.common import (  # noqa: E402
    STREAM_PARITY_TOL,
    quantize,
)
from repro_torch.kernels.filter_gains import (  # noqa: E402
    aopt_filter_gains_lattice_ref,
    filter_gains,
    filter_gains_lattice_ref,
    filter_gains_ref,
)
from repro_torch.kernels.marginal_gains import (  # noqa: E402
    regression_gains,
    regression_gains_ref,
)
from repro_torch.kernels.logistic_gains.ops import (  # noqa: E402
    ENGINE_STATES_PER_PASS,
    SMEM_PER_CTA,
    STATES_PER_PASS,
    cluster_plan as logistic_cluster_plan,
    scratch_bytes as lg_scratch_bytes,
    smem_bytes as lg_smem_bytes,
)
from repro_torch.kernels.marginal_gains.ops import (  # noqa: E402
    CTAS_PER_SM,
    STAGE_ROWS,
    split_plan,
)
from repro_torch.kernels.filter_gains.ops import (  # noqa: E402
    AOPT_ROUND_B,
    AoptPlan,
    StackPlan,
    aopt_plan,
    aopt_scratch_elems,
    aopt_smem_bytes,
    engine_plan,
    pack_basis,
    pack_factors,
)
from test_torch_aopt import RTOL as AOPT_RTOL, ATOL as AOPT_ATOL, _genuine  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = STREAM_PARITY_TOL["f32"]["kernel_vs_ref"]

# The ragged shapes of tests/test_filter_gains.py, k = 0 included.
SHAPES = [
    (32, 64, 0, 1, 2),
    (100, 300, 7, 4, 5),
    (128, 128, 16, 8, 3),
    (257, 513, 5, 3, 8),
    (64, 1000, 32, 2, 4),
]


def _problem(seed, d, n, k, b, m, g=1):
    """X (d, n), per-guess orthonormal Q (g, d, k), deltas D (g, m, d, b)
    ⊥ Q, residuals R (g, m, d), col_sq — numpy f32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(d, n)).astype(np.float32)
    Qs, Ds = [], []
    for _ in range(g):
        Q = np.linalg.qr(rng.normal(size=(d, k)))[0] if k else np.zeros((d, 0))
        Qs.append(Q)
        Dg = []
        for _ in range(m):
            Di = rng.normal(size=(d, b))
            Di = Di - Q @ (Q.T @ Di)
            Dg.append(np.linalg.qr(Di)[0][:, :b])
        Ds.append(np.stack(Dg))
    R = rng.normal(size=(g, m, d)).astype(np.float32)
    return (X, np.stack(Qs).astype(np.float32),
            np.stack(Ds).astype(np.float32), R,
            np.sum(X * X, axis=0).astype(np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m", SHAPES)
def test_regression_gains_matches_jax(d, n, k, b, m, precision):
    X, Q, _, R, csq = _problem(1, d, n, k, b, m)
    r = R[0, 0]
    Xq = np.asarray(jax_quantize(jnp.asarray(X), precision))
    want_ref = jax_regression_gains_ref(Xq, Q[0], r, csq)
    want_kernel = jax_regression_gains(X, Q[0] if k else np.zeros((d, 0), np.float32),
                                       r, csq, interpret=True,
                                       precision=precision)
    Xt, Qt, rt, ct = _t(X, Q[0], r, csq)
    got_ref = regression_gains_ref(quantize(Xt, precision), Qt, rt, ct)
    got = regression_gains(Xt, Qt, rt, ct, precision=precision)
    assert got.shape == (n,)
    _close(got_ref, want_ref)
    _close(got_ref, want_kernel)
    _close(got, want_ref)


def test_regression_gains_lane_axis_matches_per_lane():
    """The lane axis (G, d, k) gives each lane's own sweep."""
    X, Q, _, R, csq = _problem(2, 96, 200, 6, 1, 1, g=3)
    Xt, Qt, Rt, ct = _t(X, Q, R[:, 0], csq)
    got = regression_gains(Xt, Qt, Rt, ct)
    assert got.shape == (3, 200)
    for g in range(3):
        want = jax_regression_gains_ref(X, Q[g], R[g, 0], csq)
        _close(got[g], want)


# d, n, k, b, m, g: ragged widths and the sharded runtime's test shapes.
WIDTH_SHAPES = [(24, 48, 4, 2, 3, 1), (96, 64, 8, 3, 4, 3),
                (120, 32, 6, 2, 3, 2), (200, 1000, 16, 4, 8, 2),
                (600, 200, 40, 5, 4, 1)]


def _by_parts(fn, n, parts, cols):
    """``fn`` on each of ``parts`` equal column blocks, concatenated;
    ``cols(sl)`` gives the call's arguments for the column slice."""
    w = n // parts
    return torch.cat([fn(*cols(slice(i * w, (i + 1) * w)))
                      for i in range(parts)], dim=-1)


def _width_invariant(fn, n, cols):
    """A call over all n columns equals calls over n/2 and n/4 of them,
    bit for bit."""
    whole = fn(*cols(slice(0, n)))
    for parts in (2, 4):
        assert torch.equal(_by_parts(fn, n, parts, cols), whole), parts


def _c(a, sl):
    return a[..., sl].contiguous()


@pytest.mark.parametrize("d,n,k,b,m,g", WIDTH_SHAPES)
def test_regression_gains_ref_bits_do_not_depend_on_width(d, n, k, b, m, g):
    """A column's plain-version gain has the same bits in a call over all
    n columns and in one over a block of them (the sharded runtime's
    ties break as on one device)."""
    X, Q, _, R, csq = _t(*_problem(5, d, n, k, b, m, g=g))
    _width_invariant(regression_gains_ref, n,
                     lambda sl: (_c(X, sl), Q, R[:, 0], _c(csq, sl)))


@pytest.mark.parametrize("d,n,k,b,m,g", WIDTH_SHAPES)
def test_filter_gains_ref_bits_do_not_depend_on_width(d, n, k, b, m, g):
    """As above, for the regression filter engine's plain version."""
    X, Q, D, R, csq = _t(*_problem(6, d, n, k, b, m, g=g))
    _width_invariant(filter_gains_lattice_ref, n,
                     lambda sl: (_c(X, sl), Q, D, R, _c(csq, sl)))


@pytest.mark.parametrize("d,n,k,b,m,g", WIDTH_SHAPES)
def test_aopt_filter_gains_ref_bits_do_not_depend_on_width(d, n, k, b, m, g):
    """As above, for the A-optimal filter engine's plain version, on
    operands of a real solve."""
    X, W, E, F, isig2 = _genuine(d, n, g, m, b, sigma2=0.7)
    X, W, E, F = _t(X, W, E, F)
    _width_invariant(aopt_filter_gains_lattice_ref, n,
                     lambda sl: (_c(X, sl), _c(W, sl), E, F, isig2))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m", SHAPES)
def test_filter_gains_matches_jax(d, n, k, b, m, precision):
    X, Q, D, R, csq = _problem(3, d, n, k, b, m)
    Xq = np.asarray(jax_quantize(jnp.asarray(X), precision))
    want_ref = jax_filter_gains_ref(Xq, Q[0], D[0], R[0], csq)
    want_kernel = jax_filter_gains(X, Q[0], D[0], R[0], csq, interpret=True,
                                   precision=precision)
    Xt, Qt, Dt, Rt, ct = _t(X, Q, D, R, csq)
    got_ref = filter_gains_ref(quantize(Xt, precision), Qt[0], Dt[0], Rt[0],
                               ct)
    got = filter_gains(Xt, Qt, Dt, Rt, ct, precision=precision)
    assert got.shape == (1, m, n)
    _close(got_ref, want_ref)
    _close(got_ref, want_kernel)
    _close(got[0], want_ref)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g", [
    (64, 130, 5, 3, 4, 3),
    (33, 257, 0, 1, 2, 2),
    (100, 300, 8, 2, 8, 6),
])
def test_filter_gains_lattice_matches_jax(d, n, k, b, m, g, precision):
    X, Q, D, R, csq = _problem(4, d, n, k, b, m, g=g)
    Xq = np.asarray(jax_quantize(jnp.asarray(X), precision))
    want_ref = jax_filter_gains_lattice_ref(Xq, Q, D, R, csq)
    want_kernel = jax_filter_gains(X, Q, D, R, csq, interpret=True,
                                   precision=precision)
    Xt, Qt, Dt, Rt, ct = _t(X, Q, D, R, csq)
    got_ref = filter_gains_lattice_ref(quantize(Xt, precision), Qt, Dt, Rt, ct)
    got = filter_gains(Xt, Qt, Dt, Rt, ct, precision=precision)
    assert got.shape == (g, m, n)
    _close(got_ref, want_ref)
    _close(got_ref, want_kernel)
    _close(got, want_ref)


def test_quantize_bitwise_equals_jax():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4096,)) * np.logspace(-6, 6, 4096)).astype(np.float32)
    for p in ("f32", "bf16"):
        want = np.asarray(jax_quantize(jnp.asarray(x), p))
        got = quantize(torch.from_numpy(x), p).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("g", [1, 2, 6])
def test_regression_split_plan_covers_d_once(g, sms):
    """The split of d that the card's regression_gains uses: every slice
    non-empty, the slices cover d exactly once, and S = 1 whenever the
    lanes, basis tiles and column panels already fill the CTA slots."""
    for d in (1, 5, 31, 32, 33, 1000, 1023, 8192):
        for n in (1, 129, 777, 4099, 8192):
            for k in (0, 37, 128, 130):
                s, rows = split_plan(g, d, n, k, sms)
                assert s >= 1 and rows > 0 and rows % STAGE_ROWS == 0
                cover = np.zeros(d, np.int64)
                for z in range(s):
                    lo, hi = z * rows, min((z + 1) * rows, d)
                    assert lo < hi, (g, d, n, k, sms, s, rows)
                    cover[lo:hi] += 1
                assert (cover == 1).all(), (g, d, n, k, sms, s, rows)
                ctas = g * max(1, -(-k // 128)) * -(-n // 128)
                if ctas >= CTAS_PER_SM * sms:
                    assert s == 1, (g, d, n, k, sms, s)
    # greedy's call on the H100: one lane, 64 panels, d split into one
    # wave of 2 CTAs per SM.
    if (g, sms) == (1, 132):
        s, rows = split_plan(1, 8192, 8192, 128, 132)
        assert s > 1 and 64 * s <= CTAS_PER_SM * 132 and s * rows >= 8192


# The regression engine's stacked basis: (G, m, k, b, what the case
# exercises).  "cross": a state's segment straddles a 128-column tile.
STACK_CASES = [
    (1, 2, 0, 3, "k = 0"),
    (2, 3, 5, 0, "b = 0"),
    (2, 3, 130, 17, "k, b above one tile"),
    (1, 2, 120, 10, "cross"),
    (6, 8, 128, 10, "the lattice, G·m = 48"),
]


@pytest.mark.parametrize("g,m,k,b,what", STACK_CASES)
def test_stack_plan_segments_tile_the_basis(g, m, k, b, what):
    """Every stacked vector has one column: the G base segments, then per
    state its b deltas and its residual, in order, then zero padding to
    kp, the fewest 128-column tiles that hold them."""
    plan = StackPlan(g, m, k, b)
    cols = [c for gi in range(g) for c in plan.base_cols(gi)]
    for s in range(g * m):
        cols += [*plan.state_cols(s), plan.resid_col(s)]
    assert cols == list(range(plan.width))
    assert plan.width == g * k + g * m * (b + 1)
    assert plan.kp % 128 == 0 and 0 <= plan.kp - plan.width < 128
    assert plan.kp >= 128
    crosses = [s for s in range(g * m)
               if plan.state_cols(s).start // 128 != plan.resid_col(s) // 128]
    if what == "cross" or (g, m) == (6, 8):
        assert crosses
    if (g, m, k, b) == (6, 8, 128, 10):
        assert (plan.width, plan.kp) == (1296, 1408)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("g,m,k,b,what", STACK_CASES)
def test_engine_plan_covers_d_once(g, m, k, b, what, sms):
    """The engine's split of d starts from the regression sweep's at one
    lane of kp basis vectors and adds at most 3 slices, only where they
    shorten the waves (⌈S·c/w⌉ / S of one unsplit CTA's time); the slices
    cover d once."""
    slots = CTAS_PER_SM * sms
    for d in (1, 5, 24, 1000, 1023, 8192):
        for n in (1, 300, 4099, 8192):
            plan, s, rows = engine_plan(g, m, d, n, k, b, sms)
            assert plan == StackPlan(g, m, k, b)
            s0 = split_plan(1, d, n, plan.kp, sms)[0]
            assert s0 <= s <= s0 + 3
            assert rows % STAGE_ROWS == 0
            cover = np.zeros(d, np.int64)
            for z in range(s):
                lo, hi = z * rows, min((z + 1) * rows, d)
                assert lo < hi
                cover[lo:hi] += 1
            assert (cover == 1).all()
            ctas = plan.kp // 128 * -(-n // 128)
            assert -(-s * ctas // slots) * s0 <= -(-s0 * ctas // slots) * s
    # The card test's G = 1 shape splits d; at the regression lattice on
    # the H100 S = 3 fills the last of 8 waves of 264 slots.
    assert engine_plan(1, 2, 1000, 300, 7, 4, 132)[1] > 1
    assert engine_plan(6, 8, 8192, 8192, 128, 10, 132)[1:] == (3, 2752)


@pytest.mark.parametrize("g,m,k,b,what", STACK_CASES)
def test_pack_basis_places_every_segment(g, m, k, b, what):
    rng = np.random.default_rng(11)
    d = 24
    Q, D, R = _t(rng.normal(size=(g, d, k)).astype(np.float32),
                 rng.normal(size=(g, m, d, b)).astype(np.float32),
                 rng.normal(size=(g, m, d)).astype(np.float32))
    plan = StackPlan(g, m, k, b)
    B = pack_basis(Q, D, R, plan)
    assert B.shape == (d, plan.kp) and B.is_contiguous()
    for gi in range(g):
        assert torch.equal(B[:, plan.base_cols(gi)], Q[gi])
        for i in range(m):
            s = gi * m + i
            assert torch.equal(B[:, plan.state_cols(s)], D[gi, i])
            assert torch.equal(B[:, plan.resid_col(s)], R[gi, i])
    assert not B[:, plan.width:].any()


def _stacked_gains(X, Q, D, R, csq, span_tol=1e-6):
    """The engine's formulation in plain torch: pack, one product, sums of
    squares within each segment, the guarded ratio."""
    g, m, b = Q.shape[0], D.shape[1], D.shape[3]
    plan = StackPlan(g, m, Q.shape[2], b)
    P = pack_basis(Q, D, R, plan).T @ X                       # (kp, n)
    out = torch.empty((g, m, X.shape[1]))
    for gi in range(g):
        base = torch.sum(P[list(plan.base_cols(gi))] ** 2, dim=0)
        for i in range(m):
            s = gi * m + i
            sd = torch.sum(P[list(plan.state_cols(s))] ** 2, dim=0)
            c = P[plan.resid_col(s)]
            denom = (csq - base) - sd
            gain = c * c / torch.clamp(denom, min=1e-30)
            out[gi, i] = torch.where(denom > span_tol * torch.clamp(csq, min=1.0),
                                     gain, torch.zeros_like(gain))
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g", [
    (64, 130, 5, 3, 4, 3),
    (33, 257, 0, 1, 2, 2),          # k = 0
    (100, 300, 8, 2, 8, 6),         # G·m = 48
    (300, 200, 120, 10, 2, 1),      # a state's segment across a tile
    (513, 140, 130, 17, 2, 2),      # k, b above one tile
])
def test_stacked_formulation_matches_jax(d, n, k, b, m, g, precision):
    """Pack, one product, segment sums: equal to the port's plain version
    and to the JAX reference and Pallas kernel (interpret mode)."""
    X, Q, D, R, csq = _problem(12, d, n, k, b, m, g=g)
    Xq = np.asarray(jax_quantize(jnp.asarray(X), precision))
    Xt, Qt, Dt, Rt, ct = _t(X, Q, D, R, csq)
    got = _stacked_gains(quantize(Xt, precision), Qt, Dt, Rt, ct)
    _close(got, filter_gains_lattice_ref(quantize(Xt, precision), Qt, Dt,
                                         Rt, ct))
    _close(got, jax_filter_gains_lattice_ref(Xq, Q, D, R, csq))
    _close(got, jax_filter_gains(X, Q, D, R, csq, interpret=True,
                                 precision=precision))


def test_stacked_formulation_takes_b_zero():
    """b = 0: every state is its guess's base with c = r_sᵀx."""
    X, Q, D, R, csq = _problem(13, 48, 90, 6, 0, 3, g=2)
    Xt, Qt, Dt, Rt, ct = _t(X, Q, D, R, csq)
    _close(_stacked_gains(Xt, Qt, Dt, Rt, ct),
           filter_gains_lattice_ref(Xt, Qt, Dt, Rt, ct))


# ---------------------------------------------------------------------------
# kernel 5 (A-optimality engine): plan, packed factors, chunked formulation
# ---------------------------------------------------------------------------

AOPT_PLAN_BS = (0, 1, 3, 8, 9, 17, 64, 65, 128, 129, 300)


@pytest.mark.parametrize("m", [1, 8, 9])
@pytest.mark.parametrize("b", AOPT_PLAN_BS)
def test_aopt_plan_covers_every_column_once(b, m):
    """Every (sample, Woodbury column) has one packed column; a sample's
    columns sit in one unit, in whole 8-column groups of its own (a
    thread's register tile never mixes two samples), within its unit's
    nc chunks of 64; the units hold exactly the m samples."""
    plan = aopt_plan(m, b)
    C = AOPT_ROUND_B
    assert plan.units * plan.ms >= m > (plan.units - 1) * plan.ms
    assert plan.bs >= b and plan.bs % 8 == 0 and plan.bw % C == 0
    if b <= C:
        assert plan.nc == 1 and plan.ms * plan.bs <= C
        assert plan.bs == 8 * max(1, -(-b // 8))
    else:
        assert plan.ms == 1 and plan.bs == plan.nc * C and plan.bs - C < b
    owner = {}
    for i in range(m):
        for k in range(b):
            col = plan.column(i, k)
            assert 0 <= col < plan.bw and col not in owner
            owner[col] = i
            unit = i // plan.ms
            assert unit * plan.nc * C <= col < (unit + 1) * plan.nc * C
    groups = {}
    for col, i in owner.items():
        assert groups.setdefault(col // 8, i) == i
    if (m, b) == (8, 8):                   # the design lattice: one chunk
        assert plan == AoptPlan(8, 8, 1, 1) and plan.bw == 64
    if (m, b) == (8, 9):                   # m·b = 72: two units of 4
        assert plan == AoptPlan(16, 4, 1, 2)


@pytest.mark.parametrize("b", AOPT_PLAN_BS)
def test_aopt_smem_and_scratch_follow_the_plan(b):
    """Two CTAs per SM fit in shared memory for every plan; a unit's
    chunks before its last go to the scratch, one (nc − 1) × 64 × 128
    block per CTA, and b ≤ 64 needs none."""
    plan = aopt_plan(8, b)
    for dtype in (torch.float32, torch.bfloat16):
        smem = aopt_smem_bytes(dtype)
        assert smem % 16 == 0 and 2 * (smem + 1024) <= 228 * 1024
    elems = aopt_scratch_elems(3, 8, 1000, b)
    if plan.nc == 1:
        assert elems == 0
    else:
        assert elems == 8 * 3 * plan.units * (plan.nc - 1) * 64 * 128
    assert aopt_smem_bytes(torch.float32) == 81920 + 10240


@pytest.mark.parametrize("g,m,b", [(2, 8, 8), (1, 8, 9), (2, 3, 0),
                                   (1, 9, 3), (2, 3, 65), (1, 2, 300)])
def test_pack_factors_places_every_column(g, m, b):
    rng = np.random.default_rng(3)
    d = 20
    E = torch.from_numpy(rng.normal(size=(g, m, d, b)).astype(np.float32))
    plan = aopt_plan(m, b)
    Ep = pack_factors(E, plan)
    assert Ep.shape == (g, d, plan.bw) and Ep.is_contiguous()
    used = torch.zeros(plan.bw, dtype=torch.bool)
    for i in range(m):
        for k in range(b):
            col = plan.column(i, k)
            assert torch.equal(Ep[:, :, col], E[:, i, :, k])
            used[col] = True
    assert not Ep[:, :, ~used].any()


def _chunked_aopt_gains(X, W, E, F, isig2):
    """Kernel 5's formulation in plain torch: pack; per unit and chunk of
    64 columns t and u, −2uᵀt and ‖t‖² per column; tᵀF t over the unit's
    block-diagonal F across its chunks; the sums per slot."""
    g, m, d, b = E.shape
    plan = aopt_plan(m, b)
    C, width = AOPT_ROUND_B, plan.nc * AOPT_ROUND_B
    Ep = pack_factors(E, plan)
    out = torch.empty((g, m, X.shape[1]))
    for gi in range(g):
        wsq = torch.sum(W[gi] * W[gi], dim=0)
        xw = torch.sum(X * W[gi], dim=0)
        for j in range(plan.units):
            cols = Ep[gi][:, j * width:(j + 1) * width]
            T = torch.cat([cols[:, c * C:(c + 1) * C].T @ X
                           for c in range(plan.nc)])
            Uw = torch.cat([cols[:, c * C:(c + 1) * C].T @ W[gi]
                            for c in range(plan.nc)])
            Fu = torch.zeros((width, width))
            for q in range(plan.ms):
                if j * plan.ms + q < m:
                    o = q * plan.bs
                    Fu[o:o + b, o:o + b] = F[gi, j * plan.ms + q]
            num = T * (Fu @ T) - 2.0 * Uw * T
            for q in range(plan.ms):
                i = j * plan.ms + q
                if i >= m:
                    continue
                rows = slice(q * plan.bs, q * plan.bs + min(plan.bs, width))
                nm = wsq + torch.sum(num[rows], dim=0)
                den = 1.0 + isig2 * (xw - torch.sum(T[rows] ** 2, dim=0))
                out[gi, i] = (isig2 * torch.clamp(nm, min=0.0)
                              / torch.clamp(den, min=1e-30))
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,b", [
    (40, 129, 2, 8, 8),      # the design lattice's m and b: one chunk
    (40, 129, 1, 8, 9),      # m·b = 72 past one chunk: two units
    (33, 100, 2, 3, 0),      # b = 0: the singleton gain
    (48, 130, 1, 2, 65),     # two chunks
    (48, 130, 1, 2, 130),    # three chunks
])
def test_chunked_aopt_formulation_matches_jax(d, n, g, m, b, precision):
    """The chunked formulation against the port's plain version, the JAX
    lattice reference and the JAX engine in interpret mode, on operands of
    a real solve (W = M⁻¹X, Woodbury factors by the Cholesky formula)."""
    X, W, E, F, isig2 = _genuine(d, n, g, m, b, sigma2=0.7)
    tX, tW, tE, tF = (torch.from_numpy(a) for a in (X, W, E, F))
    tXq, tWq = quantize(tX, precision), quantize(tW, precision)
    got = _chunked_aopt_gains(tXq, tWq, tE, tF, isig2)

    def close(want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=AOPT_RTOL, atol=AOPT_ATOL)

    close(aopt_filter_gains_lattice_ref(tXq, tWq, tE, tF, isig2))
    jX, jW = (jax_quantize(jnp.asarray(a), precision) for a in (X, W))
    close(jax_aopt_lattice_ref(jX, jW, jnp.asarray(E), jnp.asarray(F),
                               isig2))
    close(jax_aopt_filter_gains(jnp.asarray(X), jnp.asarray(W),
                                jnp.asarray(E), jnp.asarray(F), isig2,
                                interpret=True, precision=precision))


# d, n, dtype: the main shapes (greedy's and DASH's calls share one plan),
# the card tests' shapes and edges: d = 1, d below one CTA, d ragged over
# the cluster, d past the on-chip capacity (f32 and bf16; 58,081 is one
# row past what one CTA of the engine's first port could hold), n = 1.
CLUSTER_PLAN_SHAPES = [
    (8192, 8192), (1, 1), (5, 3), (32, 64), (257, 8193), (1001, 1537),
    (600, 700), (20000, 100), (30000, 4096), (58081, 100), (60000, 1000),
    (100000, 100), (250000, 7), (8192, 1),
]


def _pr18_smem_bytes(rows, bn, elem):
    """The singleton sweep's shared memory before the engine shared its
    kernel: one 16-byte record per slab row, 11 × 64 f32 of scratch."""
    return -(-rows * bn * elem // 16) * 16 + 16 * rows + 4 * 64 * 11


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("states_per_pass", STATES_PER_PASS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", CLUSTER_PLAN_SHAPES)
def test_logistic_cluster_plan_covers_d_once(d, n, dtype, states_per_pass,
                                             sms):
    """The geometry of the card's logistic kernel at L states per pass
    (each instance that is built) on a card of ``sms`` SMs: every row of
    d lies in exactly one CTA's slab or in exactly one CTA's tail, no slab
    is empty, the cluster is portable, a CTA's shared memory (slab, L
    state records and a label per row, scratch for L states) fits the
    card (and two CTAs share an SM where the plan says so), the grid is C
    per panel, the plan does not depend on the state count, and at L = 1
    it is the singleton sweep's plan as it was."""
    L = states_per_pass
    elem = torch.empty((), dtype=dtype).element_size()
    p = logistic_cluster_plan(1, d, n, dtype, sms, L)
    for g in (6, 7, 48):  # G-free
        assert p == logistic_cluster_plan(g, d, n, dtype, sms, L)
    assert p.states_per_pass == L
    assert p.cluster in (1, 2, 4, 8) and p.bn in (4, 8, 16, 32)
    assert p.ctas == -(-n // p.bn) * p.cluster
    assert p.smem_bytes == lg_smem_bytes(p.rows, p.bn, elem, L)
    assert p.smem_bytes <= SMEM_PER_CTA[p.ctas_per_sm]
    assert p.smem_bytes <= 232_448  # the card's 227 KB per CTA
    if L == 1:
        assert p == logistic_cluster_plan(1, d, n, dtype, sms)
        assert p.smem_bytes == _pr18_smem_bytes(p.rows, p.bn, elem)
    cover = np.zeros(d, np.int64)
    for c in range(p.cluster):
        lo, hi = c * p.rows, min((c + 1) * p.rows, d)
        assert lo < hi, (d, n, p)
        cover[lo:hi] += 1
        t0 = p.cluster * p.rows + c * p.tail_per_cta
        cover[t0:min(t0 + p.tail_per_cta, d)] += 1
    assert (cover == 1).all(), (d, n, p)
    assert p.tail_rows == max(0, d - p.cluster * p.rows)
    # A tail only past the largest capacity: 8 CTAs of BN = 4, one per
    # SM, as many rows as fit.
    cap = 8 * ((SMEM_PER_CTA[1] - lg_scratch_bytes(4, L) - 16)
               // (4 * elem + 8 * L + 8))
    assert (p.tail_rows > 0) == (d > cap), (d, cap, p)
    if p.tail_rows:
        assert (p.bn, p.cluster, p.ctas_per_sm, p.rows) == (4, 8, 1,
                                                           cap // 8)


def test_logistic_cluster_plan_holds_greedy_on_chip():
    """Greedy's call (d = n = 8192, G = 1) on the H100: all of X on chip,
    at two CTAs per SM; the tail starts only past the largest capacity."""
    for dtype, bn in ((torch.float32, 16), (torch.bfloat16, 32)):
        p = logistic_cluster_plan(1, 8192, 8192, dtype, 132)
        assert (p.tail_rows, p.ctas_per_sm, p.bn) == (0, 2, bn), p
        assert p.cluster * p.rows >= 8192
    assert logistic_cluster_plan(1, 257, 8193, torch.float32, 132).cluster == 1
    assert logistic_cluster_plan(1, 100_000, 100, torch.float32,
                                 132).tail_rows > 0
    with pytest.raises(ValueError):
        logistic_cluster_plan(1, 0, 10, torch.float32, 132)
    with pytest.raises(ValueError):
        logistic_cluster_plan(1, 10, 10, torch.float32, 132, 0)


def test_logistic_engine_plan_holds_the_lattice_on_chip():
    """The filter engine's plan at the classification lattice (d = n =
    8192, G·m = 48) on the H100: 16-column panels over clusters of 8 at
    two CTAs per SM in f32 and bf16 (bf16's 32 columns would take
    117,760 bytes with four states' records), all of X on chip; the same
    plan for 1, 7 and 48 states."""
    L = ENGINE_STATES_PER_PASS
    assert L == 4
    want = {torch.float32: 112_128, torch.bfloat16: 79_360}
    for dtype in (torch.float32, torch.bfloat16):
        p = logistic_cluster_plan(48, 8192, 8192, dtype, 132, L)
        assert (p.cluster, p.rows, p.bn, p.ctas_per_sm, p.tail_rows) == (
            8, 1024, 16, 2, 0)
        assert p.smem_bytes == want[dtype]
        assert p == logistic_cluster_plan(1, 8192, 8192, dtype, 132, L)
        assert p == logistic_cluster_plan(7, 8192, 8192, dtype, 132, L)
    assert lg_smem_bytes(1024, 32, 2, 4) == 117_760 > SMEM_PER_CTA[2]


@pytest.mark.parametrize("states_per_pass", [0, 2, 3, 8])
def test_logistic_cluster_plan_rejects_an_instance_not_built(states_per_pass):
    """The kernel is built at L = 1 and ENGINE_STATES_PER_PASS states per
    pass only: the wrapper side plans no other instance."""
    with pytest.raises(ValueError, match="states_per_pass"):
        logistic_cluster_plan(48, 8192, 8192, torch.float32, 132,
                              states_per_pass)


def test_logistic_engine_states_per_pass_is_the_kernels():
    """ENGINE_STATES_PER_PASS names the instance that
    csrc/logistic_gains.cu builds as ENGINE_L."""
    src = (REPO / "src/repro_torch/kernels/csrc/logistic_gains.cu").read_text()
    got = re.findall(r"constexpr int ENGINE_L = (\d+);", src)
    assert got == [str(ENGINE_STATES_PER_PASS)]


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers take the plain route and launch
    nothing."""
    X, Q, D, R, csq = _problem(6, 16, 20, 2, 1, 2)
    before = (regression_gains.launches, filter_gains.launches)
    Xt, Qt, Dt, Rt, ct = _t(X, Q, D, R, csq)
    regression_gains(Xt, Qt, Rt[:, 0], ct)
    filter_gains(Xt, Qt, Dt, Rt, ct)
    assert (regression_gains.launches, filter_gains.launches) == before


# ---------------------------------------------------------------------------
# guards: no JAX in the port, no silent CPU fallback
# ---------------------------------------------------------------------------

def _port_modules():
    root = REPO / "src"
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (root / "repro_torch").rglob("*.py")
    )


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    files = [*(REPO / "src" / "repro_torch").rglob("*.py"),
             REPO / "chip_smoke.py"]
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert hits == []


def test_objective_without_device_refuses_cpu(monkeypatch):
    """device=None means the card: with none, construction raises instead
    of running on the CPU."""
    from repro_torch import bench_selection
    from repro_torch.core import (
        RegressionObjective,
        dash_auto,
        fast,
        greedy,
        lazy_greedy,
        select,
    )
    from repro_torch.core.random import SeedKey

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.eye(4, 3, dtype=np.float32)
    y = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegressionObjective(X, y, 2)
    obj = RegressionObjective(X, y, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy(obj, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dash_auto(obj, 2, SeedKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        select("greedy", obj, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast(obj, 2, SeedKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        lazy_greedy(obj, 2)
    for suite in bench_selection.SUITES:
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_selection.main(suite=suite, verbose=False)
