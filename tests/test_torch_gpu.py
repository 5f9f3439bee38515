"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present (decided in
the ``cuda`` fixture, never at import).  Run them on a machine with the
card:  python -m pytest -q -m gpu tests/test_torch_gpu.py
Tolerance: ``STREAM_PARITY_TOL[...]["kernel_vs_ref"]`` = 2e-4 rtol and
atol, kernel and plain version on the same (quantized) inputs.  The
A-optimality kernels take genuine operands (W = M⁻¹X of a real state,
Woodbury factors by the objective's Cholesky formula), so den ≥ 1.  The
logistic kernels take genuine logits (refit states, ``expand_logits``)
and are held to the plain version run in float64, within rtol 2e-4 and
atol 2e-4 + ε_f32·√d·ℓ_abs(η): their gain ℓ_new − ℓ_old is the
difference of two sums of order d·ln 2, and the f32 plain version itself
strays from the float64 one by about that much.  Flash attention
(kernel 8) is held to its plain version on the same inputs within the
JAX test's tolerance, rtol = atol = 2e-5 in f32 and 2e-2 in bf16 (the
plain version rounds its scores to bf16 before the softmax, the kernel
keeps them in f32).
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    STREAM_PARITY_TOL,
    quantize,
    set_full_f32_matmul,
    stream_dtype,
)
from repro_torch.kernels.filter_gains import (  # noqa: E402
    aopt_filter_gains,
    aopt_filter_gains_lattice_ref,
    filter_gains,
    filter_gains_lattice_ref,
)
from repro_torch.kernels.filter_gains.ops import (  # noqa: E402
    AOPT_ROUND_B,
    aopt_kernel_info,
    aopt_smem_bytes,
    engine_plan,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
)
from repro_torch.kernels.marginal_gains import (  # noqa: E402
    regression_gains,
    regression_gains_ref,
)
from repro_torch.kernels.marginal_gains.ops import (  # noqa: E402
    split_plan,
    wide_copies,
)

pytestmark = pytest.mark.gpu
TOL = STREAM_PARITY_TOL["f32"]["kernel_vs_ref"]


def _digest(t):
    """sha256 prefix of a tensor's bytes: a stored reading of its bits."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    set_full_f32_matmul()
    return torch.device("cuda")


def _problem(dev, d, n, k, b, m, g, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(d, n)).astype(np.float32)
    Q = np.zeros((g, d, k), np.float32)
    D = np.zeros((g, m, d, b), np.float32)
    for gi in range(g):
        if k:
            Q[gi] = np.linalg.qr(rng.normal(size=(d, k)))[0]
        for i in range(m):
            Di = rng.normal(size=(d, b))
            Di -= Q[gi] @ (Q[gi].T @ Di)
            D[gi, i] = np.linalg.qr(Di)[0][:, :b]
    R = rng.normal(size=(g, m, d)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (X, Q, D, R)]
    return (*t, torch.sum(t[0] * t[0], dim=0))


SHAPES = [  # d, n, k, b, m, g
    (32, 64, 0, 1, 2, 1),
    (100, 300, 7, 4, 5, 1),
    (257, 513, 5, 3, 8, 2),
    (64, 1000, 32, 2, 4, 3),
    (513, 777, 130, 17, 3, 2),    # k > one basis tile, b > one delta tile
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g", SHAPES)
def test_regression_gains_kernel(cuda, d, n, k, b, m, g, precision):
    X, Q, _, R, csq = _problem(cuda, d, n, k, b, m, g)
    before = regression_gains.launches
    got = regression_gains(X, Q, R[:, 0].contiguous(), csq,
                           precision=precision)
    torch.cuda.synchronize()
    assert regression_gains.launches == before + 1
    want = regression_gains_ref(quantize(X, precision), Q, R[:, 0], csq)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g", SHAPES)
def test_filter_gains_kernel(cuda, d, n, k, b, m, g, precision):
    X, Q, D, R, csq = _problem(cuda, d, n, k, b, m, g)
    before = filter_gains.launches
    got = filter_gains(X, Q, D, R, csq, precision=precision)
    torch.cuda.synchronize()
    assert filter_gains.launches == before + 1
    want = filter_gains_lattice_ref(quantize(X, precision), Q, D, R, csq)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# filter_gains' stacked engine: (d, n, k, b, m, G, what the case must be).
# "split": S > 1; "cross": a state's segment straddles a 128-column tile.
# n = 4099 takes element copies of X.
FILTER_ENGINE_SHAPES = [
    (1000, 300, 7, 4, 2, 1, "split"),       # G = 1: d split over the card
    (600, 500, 120, 10, 2, 1, "cross"),     # state 0 at columns 120-130
    (1023, 4099, 37, 3, 2, 2, "split"),     # n = 4099: element copies
    (257, 513, 6, 0, 3, 2, "split"),        # b = 0
    (24, 1000, 4, 1, 2, 1, ""),             # d below one 32-row stage
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g,what", FILTER_ENGINE_SHAPES)
def test_filter_gains_engine_shapes(cuda, d, n, k, b, m, g, what, precision):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan, s, _ = engine_plan(g, m, d, n, k, b, sms)
    if what == "split":
        assert s > 1
    elif what == "cross":
        assert plan.state_cols(0).start // 128 != plan.resid_col(0) // 128
    X, Q, D, R, csq = _problem(cuda, d, n, k, b, m, g)
    got = filter_gains(X, Q, D, R, csq, precision=precision)
    torch.cuda.synchronize()
    want = filter_gains_lattice_ref(quantize(X, precision), Q, D, R, csq)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,m,g", [(1000, 300, 7, 4, 2, 1),
                                         (513, 777, 130, 17, 3, 2)])
def test_filter_gains_is_deterministic(cuda, d, n, k, b, m, g, precision):
    """The S partials of each basis vector are added in a fixed order: two
    calls on the same inputs give the same bits."""
    X, Q, D, R, csq = _problem(cuda, d, n, k, b, m, g)
    a = filter_gains(X, Q, D, R, csq, precision=precision)
    assert torch.equal(a, filter_gains(X, Q, D, R, csq, precision=precision))


# regression_gains' split-d kernel: (d, n, k, G, S > 1 expected, 16-byte
# copies expected in f32).  S comes from split_plan with the card's SMs.
REGRESSION_SPLIT_SHAPES = [
    (1000, 300, 7, 1, True, False),      # 32 one-stage slices, last of 8 rows
    (1023, 4099, 37, 1, True, False),    # slices of 128 rows, last of 127
    (1000, 1024, 128, 2, True, True),    # full basis tile, ragged last slice
    (5, 300, 2, 1, False, False),        # d below one 32-row stage
    (257, 1024, 0, 2, True, True),       # k = 0: c alone
    (513, 1024, 130, 1, True, False),    # k above one basis tile
    (1000, 777, 37, 2, True, False),     # unaligned n and k: element copies
    (1000, 4099, 16, 6, False, False),   # DASH's G = 6: the lanes fill the card
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,g,split,wide", REGRESSION_SPLIT_SHAPES)
def test_regression_gains_split_d(cuda, d, n, k, g, split, wide, precision):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (split_plan(g, d, n, k, sms)[0] > 1) == split
    X, Q, _, R, csq = _problem(cuda, d, n, k, 1, 1, g)
    Xs = X.to(stream_dtype(precision))
    assert wide_copies(Xs, Q) == (wide and (precision == "f32"
                                            or n % 8 == 0))
    got = regression_gains(Xs, Q, R[:, 0].contiguous(), csq,
                           precision=precision)
    torch.cuda.synchronize()
    want = regression_gains_ref(quantize(X, precision), Q, R[:, 0], csq)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,g", [(1023, 4099, 37, 1),
                                     (1000, 1024, 128, 2)])
def test_regression_gains_is_deterministic(cuda, d, n, k, g, precision):
    """The S partial sums are added in a fixed order: two calls on the same
    inputs give the same bits."""
    X, Q, _, R, csq = _problem(cuda, d, n, k, 1, 1, g)
    r = R[:, 0].contiguous()
    a = regression_gains(X, Q, r, csq, precision=precision)
    b = regression_gains(X, Q, r, csq, precision=precision)
    assert torch.equal(a, b)


# Kernel 1's outputs on fixed inputs, read on an NVIDIA H100 80GB HBM3
# (700 W) at commit b2de2bc, before its partial kernel moved into
# split_proj.cuh, and equal after the move: (d, n, k, G) → (f32, bf16)
# sha256 prefixes of the (G, n) gains.  A new CUDA toolkit may compile
# other bits: read them again from that commit then.
REGRESSION_STORED_READINGS = {
    (1000, 1537, 37, 2): ("149753f0867148bb", "616f7efdb1825d50"),
    (2048, 4096, 128, 1): ("f3af4a2f51b754b5", "1899db4666c52998"),
    (257, 1024, 0, 2): ("330df2b59f37228b", "89b847ae9ec64e38"),
}


@pytest.mark.parametrize("shape", list(REGRESSION_STORED_READINGS))
def test_regression_gains_bits_unchanged(cuda, shape):
    """The shared partial kernel gives kernel 1 the same bits as the
    stored reading (inputs from numpy alone, small Q so no gain is
    guarded to 0)."""
    d, n, k, g = shape
    rng = np.random.default_rng(list(REGRESSION_STORED_READINGS).index(shape))
    X = rng.standard_normal((d, n), dtype=np.float32)
    Q = rng.standard_normal((g, d, k), dtype=np.float32) * np.float32(
        0.5 / np.sqrt(d))
    r = rng.standard_normal((g, d), dtype=np.float32)
    X, Q, r = (torch.from_numpy(a).to(cuda) for a in (X, Q, r))
    csq = torch.sum(X * X, dim=0)
    got = tuple(_digest(regression_gains(X, Q, r, csq, precision=p))
                for p in ("f32", "bf16"))
    assert got == REGRESSION_STORED_READINGS[shape]


def test_wrappers_reject_what_the_kernel_cannot_take(cuda):
    X, Q, D, R, csq = _problem(cuda, 16, 40, 2, 1, 2, 1)
    with pytest.raises(ValueError):
        regression_gains(X.t(), Q, R[:, 0].contiguous(), csq)   # shape
    with pytest.raises(ValueError):
        filter_gains(X, Q.double(), D, R, csq)                  # dtype
    with pytest.raises(ValueError):
        regression_gains(X, Q, R[:, 0].contiguous(), csq.cpu())  # device


def test_dash_on_card_matches_cpu(cuda):
    """Greedy and DASH on the quickstart's D1, card against the CPU plain
    path.  DASH draws its noise on the CPU (``SeedKey(host=True)``) so
    both see the same noise.  Greedy's picks are equal, or first differ
    at a step whose top two CPU gains are within 2e-4 relative; DASH
    selects the same set, or values agree within 1e-3."""
    from repro_torch.core import RegressionObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d1_regression

    X, y, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                 support=40)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = RegressionObjective(X, y, 40, device=dev)
        runs[dev] = (greedy(obj, 40, device=dev),
                     dash_auto(obj, 40, SeedKey(0, host=True), eps=0.25,
                               alpha=0.6, n_samples=8, n_guesses=6,
                               device=dev))
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.numpy(), gg.sel_idx.cpu().numpy()
    diff = np.flatnonzero(pc != pg)
    if diff.size:
        i = int(diff[0])
        obj = objs["cpu"]
        st = obj.add_set(obj.init(), torch.from_numpy(pc[:i])[None],
                         torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values
        assert float(top[0] - top[1]) <= 2e-4 * float(top[0]), (i, top)
    same_set = bool(torch.equal(dc.sel_mask, dg.sel_mask.cpu()))
    assert same_set or abs(float(dc.value) - float(dg.value)) < 1e-3


# ---------------------------------------------------------------------------
# A-optimality: the Sherman–Morrison sweep and the Woodbury filter engine
# ---------------------------------------------------------------------------

def _aopt_problem(dev, d, n, g, m, b, n_sel=6, sigma2=1.0, seed=0):
    """Design columns X (d, n); per lane a genuine W = M⁻¹X of a random
    n_sel-set; per (lane, sample) the Woodbury factors E (d, b) of a
    random b-set and F = EᵀE — in float64 numpy, then f32 on ``dev``."""
    from repro_torch.data.synthetic import make_d1_design

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
    t = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (X, W, E, F)]
    return (*t, isig2)


AOPT_SHAPES = [  # d, n, g, m, b, sigma2
    (1024, 4096, 2, 8, 8, 1.0),    # the design path's d, m and b
    (1000, 1537, 2, 3, 1, 0.5),    # d % 16 != 0, n % 128 != 0, b = 1
    (257, 513, 2, 4, 0, 1.0),      # b = 0: the singleton gain
    (100, 300, 1, 9, 3, 2.0),      # m above the 8 samples of one CTA
    (129, 333, 3, 2, AOPT_ROUND_B, 1.0),   # b at one chunk's width
    (1000, 1537, 2, 8, 9, 1.0),    # m·b = 72 past one chunk: 2 units
    (513, 777, 2, 1, AOPT_ROUND_B, 0.5),   # m = 1 at one chunk's width
    (64, 4096, 1, 4, 22, 1.0),     # the coreset's: dim_cap 64, k 256, m 4
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,b,sigma2", AOPT_SHAPES)
def test_aopt_gains_kernel(cuda, d, n, g, m, b, sigma2, precision):
    X, W, _, _, isig2 = _aopt_problem(cuda, d, n, g, 1, 1, sigma2=sigma2)
    before = aopt_gains.launches
    got = aopt_gains(X, W, isig2, precision=precision)
    torch.cuda.synchronize()
    assert aopt_gains.launches == before + 1
    want = aopt_gains_ref(quantize(X, precision), quantize(W, precision),
                          isig2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,b,sigma2", AOPT_SHAPES)
def test_aopt_filter_gains_kernel(cuda, d, n, g, m, b, sigma2, precision):
    X, W, E, F, isig2 = _aopt_problem(cuda, d, n, g, m, b, n_sel=b + 5,
                                      sigma2=sigma2)
    before = aopt_filter_gains.launches
    got = aopt_filter_gains(X, W, E, F, isig2, precision=precision)
    torch.cuda.synchronize()
    assert aopt_filter_gains.launches == before + 1
    want = aopt_filter_gains_lattice_ref(quantize(X, precision),
                                         quantize(W, precision), E, F, isig2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,b", [
    (513, 777, 2, 3, AOPT_ROUND_B + 1),    # one column past a pass
    (1024, 4099, 2, 4, 128),               # two full rounds
    (257, 1000, 1, 3, 300),                # five rounds, the last ragged
])
def test_aopt_filter_gains_in_rounds(cuda, d, n, g, m, b, precision):
    """b > AOPT_ROUND_B: one sample per CTA, its Woodbury columns in
    chunks of 64 (t of the chunks before the last through the scratch)
    and tᵀF t across the chunks, on genuine operands."""
    X, W, E, F, isig2 = _aopt_problem(cuda, d, n, g, m, b, n_sel=9)
    before = aopt_filter_gains.launches
    got = aopt_filter_gains(X, W, E, F, isig2, precision=precision)
    torch.cuda.synchronize()
    assert aopt_filter_gains.launches == before + 1
    want = aopt_filter_gains_lattice_ref(quantize(X, precision),
                                         quantize(W, precision), E, F, isig2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# Kernel 5's outputs at b ≤ 64 (one chunk per CTA) on fixed inputs, read
# on an NVIDIA H100 80GB HBM3 (700 W) from the kernel sources of commit
# d7a200a, the redesign that moved them (the b = 0 reading did not move):
# (d, n, G, m, b) → (f32, bf16) sha256 prefixes of the (G, m, n) gains.
# A new CUDA toolkit may compile other bits: read them again from that
# commit then.
AOPT_STORED_READINGS = {
    (1024, 4096, 2, 8, 8): ("b199f34748f94050", "79a02b4e967ee7e3"),
    (513, 777, 3, 2, 64): ("20f77babe41651ca", "6d32a1744328ef93"),
    (100, 300, 1, 9, 3): ("2691dbb032ef8d62", "0b3ab0053446e7d9"),
    (257, 513, 2, 4, 0): ("e3aa9866bb3fddeb", "f54757c54f90e077"),
}


@pytest.mark.parametrize("shape", list(AOPT_STORED_READINGS))
def test_aopt_filter_gains_one_pass_bits_unchanged(cuda, shape):
    """b ≤ 64 (one chunk per CTA): the same bits as the stored reading.
    Inputs from numpy alone (no LAPACK), so every host makes the same
    ones: W ≈ X / 2, small E, a symmetric F."""
    d, n, g, m, b = shape
    rng = np.random.default_rng(10 + list(AOPT_STORED_READINGS).index(shape))
    X = rng.standard_normal((d, n), dtype=np.float32)
    W = np.float32(0.5) * X + np.float32(0.1) * rng.standard_normal(
        (g, d, n), dtype=np.float32)
    E = rng.standard_normal((g, m, d, b), dtype=np.float32) * np.float32(0.01)
    A = rng.standard_normal((g, m, b, b), dtype=np.float32)
    F = (A + np.swapaxes(A, -1, -2)) * np.float32(0.5)
    X, W, E, F = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                  for a in (X, W, E, F))
    got = tuple(_digest(aopt_filter_gains(X, W, E, F, 0.5, precision=p))
                for p in ("f32", "bf16"))
    assert got == AOPT_STORED_READINGS[shape]


def _random_aopt(dev, d, n, g, m, b, seed=0):
    """X (d, n), W ≈ X / 2 (G, d, n), small E (G, m, d, b) and F = EᵀE,
    drawn on the card: operands of the shape only, for bits and limits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((d, n), device=dev, generator=gen) / d ** 0.5
    W = 0.5 * X + 0.05 * torch.randn((g, d, n), device=dev,
                                     generator=gen) / d ** 0.5
    E = torch.randn((g, m, d, b), device=dev, generator=gen) * (0.1 / d ** 0.5)
    return X, W, E, (E.transpose(-1, -2) @ E).contiguous()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("g,b", [(12, 8), (6, 128)])
def test_aopt_filter_gains_is_deterministic(cuda, g, b, precision):
    """No atomics: two calls at the design lattice (d = 1024, n = 65536,
    m = 8) and at b = 128 give the same bits."""
    X, W, E, F = _random_aopt(cuda, 1024, 65536, g, 8, b)
    a = aopt_filter_gains(X, W, E, F, 1.0, precision=precision)
    assert torch.equal(a, aopt_filter_gains(X, W, E, F, 1.0,
                                            precision=precision))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aopt_filter_kernel_info_matches_plan(cuda, dtype):
    """The CUDA runtime's account of kernel 5: the shared memory per CTA
    that ``aopt_smem_bytes`` reckons for every plan, 256 threads and two
    CTAs per SM."""
    info = aopt_kernel_info(dtype)
    assert info["smem_bytes"] == aopt_smem_bytes(dtype)
    assert info["threads"] == 256 and info["ctas_per_sm"] == 2


# Past the 65,535 column panels that one launch's gridDim.y holds: 65,536
# panels of aopt_gains' 32 columns, 65,537 of the other wrappers' 128.
PAST_AOPT_GAINS_LIMIT = 2_097_152
PAST_PANEL_LIMIT = 8_388_609


def test_aopt_gains_past_the_panel_limit(cuda):
    X, W, _, _ = _random_aopt(cuda, 32, PAST_AOPT_GAINS_LIMIT, 2, 1, 0)
    got = aopt_gains(X, W, 1.0)
    torch.testing.assert_close(got, aopt_gains_ref(X, W, 1.0), rtol=TOL,
                               atol=TOL)


def test_aopt_filter_gains_past_the_panel_limit(cuda):
    X, W, E, F = _random_aopt(cuda, 32, PAST_PANEL_LIMIT, 1, 2, 3)
    got = aopt_filter_gains(X, W, E, F, 1.0)
    torch.testing.assert_close(
        got, aopt_filter_gains_lattice_ref(X, W, E, F, 1.0), rtol=TOL,
        atol=TOL)


def _wide_regression(dev, d, n, k, b, m, g):
    """X (d, n) drawn on the card; the small Q, D, R of ``_problem``."""
    _, Q, D, R, _ = _problem(dev, d, 8, k, b, m, g)
    gen = torch.Generator(device=dev).manual_seed(1)
    X = torch.randn((d, n), device=dev, generator=gen)
    return X, Q, D, R, torch.sum(X * X, dim=0)


def test_regression_gains_past_the_panel_limit(cuda):
    X, Q, _, R, csq = _wide_regression(cuda, 32, PAST_PANEL_LIMIT, 3, 1, 1, 1)
    r = R[:, 0].contiguous()
    torch.testing.assert_close(regression_gains(X, Q, r, csq),
                               regression_gains_ref(X, Q, r, csq), rtol=TOL,
                               atol=TOL)


def test_filter_gains_past_the_panel_limit(cuda):
    X, Q, D, R, csq = _wide_regression(cuda, 32, PAST_PANEL_LIMIT, 2, 1, 2, 1)
    torch.testing.assert_close(filter_gains(X, Q, D, R, csq),
                               filter_gains_lattice_ref(X, Q, D, R, csq),
                               rtol=TOL, atol=TOL)


def test_aopt_wrappers_reject_what_the_kernel_cannot_take(cuda):
    X, W, E, F, isig2 = _aopt_problem(cuda, 64, 100, 1, 2, 3)
    with pytest.raises(ValueError):
        aopt_filter_gains(X, W, E.double(), F, isig2)            # dtype
    with pytest.raises(ValueError):
        aopt_gains(X, W.cpu(), isig2)                            # device
    with pytest.raises(ValueError):
        aopt_gains(X, W[:, :, :50].contiguous(), isig2)          # shape


def test_design_dash_on_card_matches_cpu(cuda):
    """Greedy and DASH on a small design, card against the CPU plain
    path, DASH noise drawn on the CPU.  Every candidate has unit norm, so
    greedy's first gains tie at 0.5: its picks are equal, or first
    differ where the CPU's top two gains are within 2e-4 relative.  DASH
    (6 OPT guesses × α ∈ {0.3, 1}) selects the same set, or its values
    agree within 1e-3."""
    from repro_torch.core import AOptimalityObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d1_design

    X = make_d1_design(seed=0, n_samples=512, n_features=128)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = AOptimalityObjective(X, 32, device=dev)
        runs[dev] = (greedy(obj, 32, device=dev),
                     dash_auto(obj, 32, SeedKey(0, host=True), eps=0.25,
                               alpha=0.3, alphas=[0.3, 1.0], n_samples=8,
                               n_guesses=6, device=dev))
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.numpy(), gg.sel_idx.cpu().numpy()
    diff = np.flatnonzero(pc != pg)
    if diff.size:
        i = int(diff[0])
        obj = objs["cpu"]
        st = obj.init()
        if i:
            st = obj.add_set(st, torch.from_numpy(pc[:i])[None],
                             torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values
        assert float(top[0] - top[1]) <= 2e-4 * float(top[0]), (i, top)
    same_set = bool(torch.equal(dc.sel_mask, dg.sel_mask.cpu()))
    assert same_set or abs(float(dc.value) - float(dg.value)) < 1e-3


def test_design_dash_one_round_of_80_on_card_matches_cpu(cuda):
    """DASH with r = 1 at k = 80 on a design: one block of b = 80 Woodbury
    columns per sample, past one pass of the engine.  The card selects the
    CPU's set, or its value agrees within 1e-3."""
    from repro_torch.core import AOptimalityObjective, dash_auto
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d1_design

    X = make_d1_design(seed=1, n_samples=512, n_features=128)
    runs = {}
    for dev in ("cpu", "cuda"):
        obj = AOptimalityObjective(X, 80, device=dev)
        runs[dev] = dash_auto(obj, 80, SeedKey(0, host=True), eps=0.25,
                              alpha=0.3, r=1, n_samples=8, n_guesses=6,
                              device=dev)
    dc, dg = runs["cpu"], runs["cuda"]
    same_set = bool(torch.equal(dc.sel_mask, dg.sel_mask.cpu()))
    assert same_set or abs(float(dc.value) - float(dg.value)) < 1e-3


# ---------------------------------------------------------------------------
# Logistic classification: the Newton sweep and its filter engine
# ---------------------------------------------------------------------------

def _logistic_problem(dev, d, n, g, m, b=3, n_sel=5, seed=0):
    """D3 features X (d, n) and labels y on ``dev``; the logits E (g, d)
    of g states refit on n_sel random features, and the refit logits
    (g, m, d) of m random b-sets per state (``expand_logits``)."""
    from repro_torch.core import ClassificationObjective
    from repro_torch.data.synthetic import make_d3_classification

    X, y, _ = make_d3_classification(seed=seed, n_samples=d, n_features=n,
                                     support=max(1, n // 4))
    obj = ClassificationObjective(X, y, n_sel + b, device=dev)
    rng = np.random.default_rng(seed)

    def draw(shape, count):
        return torch.from_numpy(np.stack(
            [rng.choice(n, size=count, replace=False)
             for _ in range(int(np.prod(shape)))]).reshape(*shape, count)
        ).to(dev)

    idx = draw((g,), n_sel)
    st = obj.add_set(obj.init(g), idx, torch.ones_like(idx, dtype=torch.bool))
    sidx = draw((g, m), b)
    etas = obj.expand_logits(st, sidx, torch.ones_like(sidx,
                                                       dtype=torch.bool))
    return obj.X, obj.y, st.eta.contiguous(), etas.contiguous()


def _f64_gate(got, want64, y, etas):
    """The kernels' gate: rtol 2e-4 and atol 2e-4 + ε_f32·√d·ℓ_abs(η)
    against the plain version in float64 (ℓ_abs = Σ|y η − softplus(η)|,
    the size of the f32 cancellation of ℓ_new − ℓ_old)."""
    from repro_torch.kernels.logistic_gains.ref import softplus

    e = etas.double()
    labs = torch.sum(torch.abs(y.double() * e - softplus(e)), dim=-1,
                     keepdim=True)
    atol = 2e-4 + torch.finfo(torch.float32).eps * e.shape[-1] ** 0.5 * labs
    err = (got.double() - want64).abs()
    assert bool((err <= atol + 2e-4 * want64.abs()).all()), float(err.max())


LOGISTIC_SHAPES = [  # d, n, g, m, steps
    (32, 64, 1, 2, 3),
    (257, 513, 2, 3, 1),          # odd d, ragged n, one step
    (1000, 1537, 3, 8, 4),        # G·m = 24
    (600, 700, 5, 8, 3),          # G·m = 40
    (20000, 100, 1, 2, 3),        # the engine at one CTA per SM
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,steps", LOGISTIC_SHAPES)
def test_logistic_gains_kernel(cuda, d, n, g, m, steps, precision):
    from repro_torch.kernels.logistic_gains import (
        logistic_gains,
        logistic_gains_ref,
    )

    X, y, E, _ = _logistic_problem(cuda, d, n, g, 1)
    before = logistic_gains.launches
    got = logistic_gains(X, y, E, steps=steps, precision=precision)
    torch.cuda.synchronize()
    assert logistic_gains.launches == before + 1
    X64 = quantize(X, precision).double()
    want = torch.stack([logistic_gains_ref(X64, y.double(), e.double(),
                                           steps=steps) for e in E])
    _f64_gate(got, want, y, E)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,steps", LOGISTIC_SHAPES)
def test_logistic_filter_gains_kernel(cuda, d, n, g, m, steps, precision):
    from repro_torch.kernels.filter_gains import (
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )

    X, y, _, etas = _logistic_problem(cuda, d, n, g, m)
    before = logistic_filter_gains.launches
    got = logistic_filter_gains(X, y, etas, steps=steps, precision=precision)
    torch.cuda.synchronize()
    assert logistic_filter_gains.launches == before + 1
    want = logistic_filter_gains_lattice_ref(
        quantize(X, precision).double(), y.double(), etas.double(),
        steps=steps)
    _f64_gate(got, want, y, etas)


# logistic_gains' cluster kernel: (d, n, G, steps, what the plan must be).
# "C1": one CTA holds d; "split": C > 1; "ragged": C > 1 with a ragged
# last CTA; "tail": d past the on-chip capacity, the rest read from
# global memory in every pass.
LOGISTIC_CLUSTER_SHAPES = [
    (257, 8193, 2, 1, "C1"),         # n ragged against BN = 32
    (1001, 1537, 3, 4, "ragged"),    # 4 CTAs of 251 rows, the last 248
    (8192, 777, 6, 3, "split"),      # DASH's G = 6 at greedy's d, ragged n
    (601, 700, 1, 0, "ragged"),      # steps = 0: every gain 0
    (100_000, 100, 1, 3, "tail"),    # 57,400 f32 (76,536 bf16) rows on chip
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,steps,kind", LOGISTIC_CLUSTER_SHAPES)
def test_logistic_gains_cluster_plan(cuda, d, n, g, steps, kind, precision):
    from repro_torch.kernels.logistic_gains import (
        logistic_gains,
        logistic_gains_ref,
    )
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.logistic_gains.ops import (
        cluster_plan,
        kernel_info,
    )

    X, y, E, _ = _logistic_problem(cuda, d, n, g, 1)
    Xs = X.to(stream_dtype(precision))
    plan = cluster_plan(g, d, n, Xs.dtype, sm_count(cuda))
    if kind == "C1":
        assert plan.cluster == 1 and plan.tail_rows == 0, plan
    elif kind in ("split", "ragged"):
        assert plan.cluster > 1 and plan.tail_rows == 0, plan
        assert (plan.cluster * plan.rows > d) == (kind == "ragged"), plan
    else:
        assert plan.tail_rows > 0, plan
    info = kernel_info(Xs.dtype, plan)
    assert info["smem_bytes"] == plan.smem_bytes, (info, plan)
    assert info["active_clusters"] >= 1, info
    got = logistic_gains(Xs, y, E, steps=steps, precision=precision)
    torch.cuda.synchronize()
    X64 = quantize(X, precision).double()
    want = torch.stack([logistic_gains_ref(X64, y.double(), e.double(),
                                           steps=steps) for e in E])
    _f64_gate(got, want, y, E)
    if steps == 0:
        assert bool((got == 0).all())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g", [(1001, 1537, 3), (100_000, 100, 1)])
def test_logistic_gains_is_deterministic(cuda, d, n, g, precision):
    """The cluster's sums close in rank order: two calls on the same
    inputs give the same bits."""
    from repro_torch.kernels.logistic_gains import logistic_gains

    X, y, E, _ = _logistic_problem(cuda, d, n, g, 1)
    a = logistic_gains(X, y, E, precision=precision)
    b = logistic_gains(X, y, E, precision=precision)
    assert torch.equal(a, b)


def test_logistic_wrappers_reject_what_the_kernel_cannot_take(cuda):
    from repro_torch.kernels.filter_gains import logistic_filter_gains
    from repro_torch.kernels.logistic_gains import logistic_gains

    X, y, E, etas = _logistic_problem(cuda, 64, 100, 2, 3)
    with pytest.raises(ValueError):
        logistic_gains(X, y, E.double())                          # dtype
    with pytest.raises(ValueError):
        logistic_gains(X, y.cpu(), E)                             # device
    with pytest.raises(ValueError):
        logistic_gains(X.t().contiguous().t(), y, E)              # layout
    with pytest.raises(ValueError):
        logistic_filter_gains(X, y, etas.transpose(0, 1))         # layout
    with pytest.raises(ValueError):
        logistic_filter_gains(X, y.double(), etas)                # dtype


def test_logistic_branch_free_log1pf_is_log1pf(cuda):
    """The logistic kernels take log1pf's fast path without its branch
    for special arguments: the same bits as the library's log1pf
    at every float in [0, 1] (the range of e^(−|v|))."""
    from repro_torch.kernels.logistic_gains.ops import log1p_check

    assert log1p_check() == 0


# The logistic filter engine (kernel 6's template at several states per
# pass): (d, n, G, m, steps, what the plan must be).  "C1", "split",
# "ragged" and "tail" as for kernel 6; d = 60,000 and 100,000 lie past the
# 58,080 f32 rows that one CTA of the engine's first port could hold.
LOGISTIC_ENGINE_SHAPES = [
    (257, 8193, 1, 3, 1, "C1"),       # n ragged against BN = 32
    (1001, 1537, 2, 3, 4, "ragged"),  # G·m = 6: a ragged batch
    (8192, 777, 6, 8, 3, "split"),    # the lattice's d and G·m
    (601, 700, 1, 7, 0, "ragged"),    # steps = 0: every gain 0
    (60_000, 100, 1, 3, 3, "tail"),
    (100_000, 100, 1, 3, 3, "tail"),
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m,steps,kind", LOGISTIC_ENGINE_SHAPES)
def test_logistic_filter_gains_cluster_plan(cuda, d, n, g, m, steps, kind,
                                            precision):
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.filter_gains import (
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.logistic_gains.ops import (
        ENGINE_STATES_PER_PASS,
        cluster_plan,
        kernel_info,
    )

    X, y, _, etas = _logistic_problem(cuda, d, n, g, m)
    Xs = X.to(stream_dtype(precision))
    plan = cluster_plan(g * m, d, n, Xs.dtype, sm_count(cuda),
                        ENGINE_STATES_PER_PASS)
    if kind == "C1":
        assert plan.cluster == 1 and plan.tail_rows == 0, plan
    elif kind in ("split", "ragged"):
        assert plan.cluster > 1 and plan.tail_rows == 0, plan
        assert (plan.cluster * plan.rows > d) == (kind == "ragged"), plan
    else:
        assert plan.tail_rows > 0, plan
    info = kernel_info(Xs.dtype, plan)
    assert info["smem_bytes"] == plan.smem_bytes, (info, plan)
    assert info["spill_bytes"] == 0, info
    assert info["active_clusters"] >= 1, info
    before = logistic_filter_gains.launches
    got = logistic_filter_gains(Xs, y, etas, steps=steps,
                                precision=precision)
    torch.cuda.synchronize()
    assert logistic_filter_gains.launches == before + 1
    want = logistic_filter_gains_lattice_ref(
        quantize(X, precision).double(), y.double(), etas.double(),
        steps=steps)
    _f64_gate(got, want, y, etas)
    if steps == 0:
        assert bool((got == 0).all())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,g,m", [(1001, 1537, 6, 8), (100_000, 100, 1, 3)])
def test_logistic_filter_gains_is_deterministic(cuda, d, n, g, m,
                                                precision):
    """The engine's cluster sums close in rank order: two calls on the
    same inputs give the same bits."""
    from repro_torch.kernels.filter_gains import logistic_filter_gains

    X, y, _, etas = _logistic_problem(cuda, d, n, g, m)
    a = logistic_filter_gains(X, y, etas, precision=precision)
    b = logistic_filter_gains(X, y, etas, precision=precision)
    assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n", [(8192, 1000), (1001, 1537)])
def test_logistic_filter_gains_state_does_not_see_the_others(cuda, d, n,
                                                             precision):
    """State s of a 48-state call has the bits of the same state in a
    1-state call and in a 7-state call (a ragged batch), wherever it sits
    in its batch: the plan does not depend on the state count, and a
    state's sums take the same order in every slot."""
    from repro_torch.kernels.filter_gains import logistic_filter_gains

    X, y, _, etas = _logistic_problem(cuda, d, n, 6, 8)
    flat = etas.reshape(48, d)
    full = logistic_filter_gains(X, y, etas,
                                 precision=precision).reshape(48, n)
    for lo, count in ((0, 1), (5, 1), (3, 7), (41, 7)):
        part = logistic_filter_gains(
            X, y, flat[lo:lo + count].contiguous().view(1, count, d),
            precision=precision)
        assert torch.equal(part[0], full[lo:lo + count]), (lo, count)


def test_classification_dash_on_card_matches_cpu(cuda):
    """Greedy and DASH on the small D3 (600 × 200, support 50, k = 20),
    card against the CPU plain path, DASH noise drawn on the CPU.
    Greedy's picks are equal, or first differ where the CPU's top two
    gains are within 1e-4 relative; per DASH guess the card selects the
    CPU's set, or its value agrees within 1e-3."""
    from repro_torch.core import ClassificationObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d3_classification

    X, y, _ = make_d3_classification(n_samples=600, n_features=200,
                                     support=50)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = ClassificationObjective(X, y, 20, device=dev)
        runs[dev] = (greedy(obj, 20, device=dev),
                     dash_auto(obj, 20, SeedKey(0, host=True), eps=0.25,
                               alpha=0.6, n_samples=8, n_guesses=6,
                               return_lattice=True, device=dev)[1])
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.numpy(), gg.sel_idx.cpu().numpy()
    diff = np.flatnonzero(pc != pg)
    if diff.size:
        i = int(diff[0])
        obj = objs["cpu"]
        st = obj.init()
        if i:
            st = obj.add_set(st, torch.from_numpy(pc[:i])[None],
                             torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values
        assert float(top[0] - top[1]) <= 1e-4 * float(top[0]), (i, top)
    for g in range(dc.value.shape[0]):
        same = bool(torch.equal(dc.sel_mask[g], dg.sel_mask[g].cpu()))
        assert same or abs(float(dc.value[g]) - float(dg.value[g])) < 1e-3


# ---------------------------------------------------------------------------
# FAST's prefix sweep: the engines on a sequence's L + 1 insertion prefixes
# ---------------------------------------------------------------------------

def _prefix_set(dev, n, b, ragged, seed):
    """One random sequence of b as (1, b + 1, b) idx and FAST's prefix
    masks, the last ``ragged`` slots invalid."""
    from repro_torch.core.fast import prefix_masks

    g = torch.Generator().manual_seed(seed)
    seq = torch.randperm(n, generator=g)[:b].to(dev)
    idx = seq[None, None, :].expand(1, b + 1, b).contiguous()
    ok = torch.arange(b, device=dev) < b - ragged
    return idx, (prefix_masks(b, dev) & ok[None, :])[None].contiguous()


def _one_selected(obj, dev, a=0):
    return obj.add_set(obj.init(), torch.tensor([[a]], device=dev),
                       torch.ones((1, 1), dtype=torch.bool, device=dev))


# d, n, k (the basis capacity), b, ragged slots
FAST_REGRESSION_SHAPES = [(8192, 8192, 128, 128, 0), (1000, 1537, 40, 40, 7)]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,b,ragged", FAST_REGRESSION_SHAPES)
def test_filter_gains_fast_prefixes(cuda, d, n, k, b, ragged, precision):
    """Kernel 3 on the regression objective's own FAST operands: |S| = 1
    of a k-column basis, the MGS deltas of b + 1 prefixes; bitwise equal
    in two calls.  Compared where the candidate lies outside S ∪ R_j:
    the members' denominators are f32 residue around 0, on either side
    of the in-span floor in kernel and plain version alike, and the
    objective zeroes them (``filter_gains_batch``)."""
    from repro_torch.core.objectives.base import mark_selected
    from repro_torch.core import RegressionObjective
    from repro_torch.data.synthetic import make_d1_regression

    X, y, _ = make_d1_regression(seed=1, n_samples=d, n_features=n,
                                 support=min(256, n // 4))
    obj = RegressionObjective(X, y, k, device=cuda)
    st = _one_selected(obj, cuda)
    idx, mask = _prefix_set(cuda, n, b, ragged, seed=d)
    D, R = obj.expand_basis(st, idx, mask)
    got = filter_gains(obj.X, st.Q, D, R, obj.col_sq, precision=precision)
    again = filter_gains(obj.X, st.Q, D, R, obj.col_sq, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = filter_gains_lattice_ref(quantize(obj.X, precision), st.Q, D, R,
                                    obj.col_sq)
    members = mark_selected(st.sel_mask[:, None].repeat(1, b + 1, 1), idx,
                            mask)
    torch.testing.assert_close(got[~members], want[~members], rtol=TOL,
                               atol=TOL)
    assert int((~members).sum()) >= (b + 1) * (n - b - 1)


# d, n, b, ragged slots, |S|
FAST_AOPT_SHAPES = [(1024, 8192, 128, 0, 40), (300, 1000, 40, 5, 9)]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,b,ragged,n_sel", FAST_AOPT_SHAPES)
def test_aopt_filter_gains_fast_prefixes(cuda, d, n, b, ragged, n_sel,
                                         precision):
    """Kernel 5 on the design objective's Woodbury factors of b + 1
    prefixes (b = 128: two chunks of 64); bitwise equal in two calls."""
    from repro_torch.core import AOptimalityObjective
    from repro_torch.data.synthetic import make_d1_design

    obj = AOptimalityObjective(make_d1_design(seed=2, n_samples=n,
                                              n_features=d),
                               n_sel + b, device=cuda)
    sel = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    sel = sel[:n_sel].to(cuda)[None]
    st = obj.add_set(obj.init(), sel, torch.ones_like(sel, dtype=torch.bool))
    idx, mask = _prefix_set(cuda, n, b, ragged, seed=d + 1)
    E, F = obj.expand_factors(st, idx, mask)
    E, F = E.contiguous(), F.contiguous()
    got = aopt_filter_gains(obj.X, st.W, E, F, obj.isig2,
                            precision=precision)
    again = aopt_filter_gains(obj.X, st.W, E, F, obj.isig2,
                              precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = aopt_filter_gains_lattice_ref(quantize(obj.X, precision),
                                         quantize(st.W, precision), E, F,
                                         obj.isig2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,b,ragged", [(8192, 1000, 128, 0),
                                          (600, 700, 40, 6)])
def test_logistic_filter_gains_fast_prefixes(cuda, d, n, b, ragged,
                                             precision):
    """Kernel 7 on the refit logits of b + 1 prefixes (129 states at
    b = 128), against the plain version in float64."""
    from repro_torch.core import ClassificationObjective
    from repro_torch.data.synthetic import make_d3_classification
    from repro_torch.kernels.filter_gains import (
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )

    X, y, _ = make_d3_classification(seed=4, n_samples=d, n_features=n,
                                     support=n // 4)
    obj = ClassificationObjective(X, y, 1 + b, device=cuda)
    st = _one_selected(obj, cuda, a=5)
    idx, mask = _prefix_set(cuda, n, b, ragged, seed=d + 2)
    etas = obj.expand_logits(st, idx, mask).contiguous()
    got = logistic_filter_gains(obj.X, obj.y, etas, precision=precision)
    torch.cuda.synchronize()
    want = logistic_filter_gains_lattice_ref(
        quantize(obj.X, precision).double(), obj.y.double(), etas.double())
    _f64_gate(got, want, obj.y, etas)


@pytest.mark.parametrize("algo", ["lazy_greedy", "stochastic_greedy",
                                  "fast", "adaptive_sequencing"])
def test_select_on_card_matches_cpu(cuda, algo):
    """select() on the quickstart's D1 (600 × 200, k = 40), card against
    the CPU plain path, noise drawn on the CPU: the same set; or, for the
    pickers, a first difference at a near-tie (the CPU's gains of the two
    differing picks within 2e-4 relative), for FAST and adaptive
    sequencing values within 1e-3."""
    from repro_torch.core import RegressionObjective, SeedKey, select
    from repro_torch.data.synthetic import make_d1_regression

    X, y, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                 support=40)
    objs = {dev: RegressionObjective(X, y, 40, device=dev)
            for dev in ("cpu", "cuda")}
    rc, rg = (select(algo, objs[dev], 40, key=SeedKey(0, host=True),
                     device=dev) for dev in ("cpu", "cuda"))
    if torch.equal(rc.sel_mask, rg.sel_mask.cpu()):
        return
    if not hasattr(rc.raw, "sel_idx"):
        assert abs(float(rc.value) - float(rg.value)) < 1e-3
    else:
        pc, pg = rc.raw.sel_idx.tolist(), rg.raw.sel_idx.cpu().tolist()
        i = next(j for j, (a, b) in enumerate(zip(pc, pg)) if a != b)
        obj = objs["cpu"]
        st = obj.init()
        if i:
            st = obj.add_set(st, torch.tensor([pc[:i]]),
                             torch.ones((1, i), dtype=torch.bool))
        g = obj.gains(st)[0]
        assert abs(float(g[pc[i]] - g[pg[i]])) <= 2e-4 * abs(float(g[pc[i]]))


# ---------------------------------------------------------------------------
# slice 6: the per-sample path, diversity, coreset, checkpointed DASH
# ---------------------------------------------------------------------------

def _slice6_problem(name, dev, engine=True):
    from repro_torch.core import (
        AOptimalityObjective,
        ClassificationObjective,
        RegressionObjective,
    )
    from repro_torch.data.synthetic import (
        make_d1_design,
        make_d1_regression,
        make_d3_classification,
    )

    if name == "regression":
        X, y, _ = make_d1_regression(seed=0, n_samples=600, n_features=300,
                                     support=40)
        return RegressionObjective(X, y, 40, use_filter_engine=engine,
                                   device=dev)
    if name == "aopt":
        X = make_d1_design(seed=0, n_samples=700, n_features=128)
        return AOptimalityObjective(X, 40, use_filter_engine=engine,
                                    device=dev)
    X, y, _ = make_d3_classification(n_samples=600, n_features=300,
                                     support=40)
    return ClassificationObjective(X, y, 40, use_filter_engine=engine,
                                   device=dev)


# The per-sample path against the engine, as on the CPU
# (tests/test_torch_objectives_more.py): the reference's tolerances.
PER_SAMPLE_TOL = {"regression": (1e-4, 1e-5), "aopt": (1e-5, 1e-6),
                  "logistic": (1e-4, 1e-5)}


@pytest.mark.parametrize("name", ["regression", "aopt", "logistic"])
def test_per_sample_path_matches_engine_on_card(cuda, name):
    """``_estimate_elem_gains`` with use_filter_engine False (kernel 1,
    4 or 6 once per sample) and True (kernel 3, 5 or 7 once), 3 lanes,
    the same keys; and the engine-off run launches no engine kernel."""
    from repro_torch.core import DashConfig, SeedKey
    from repro_torch.core.dash import _estimate_elem_gains
    from repro_torch.kernels.filter_gains import logistic_filter_gains

    engines = {"regression": filter_gains, "aopt": aopt_filter_gains,
               "logistic": logistic_filter_gains}
    on, off = (_slice6_problem(name, cuda, e) for e in (True, False))
    st = on.add_set(on.init(3), torch.tensor([[0, 3, 9], [5, 5, 1],
                                              [7, 2, 4]], device=cuda),
                    torch.tensor([[True, True, False], [True, True, True],
                                  [False, False, False]], device=cuda))
    cfg = DashConfig(k=40, n_samples=6).resolve(on.n)
    alive = torch.ones((3, on.n), dtype=torch.bool, device=cuda)
    alive[1, ::3] = False
    allowed = torch.tensor([40, 5, 9], device=cuda)
    keys = SeedKey(11, host=True).split(3)
    want = _estimate_elem_gains(on, st, alive, 8, allowed, keys, cfg)
    before = engines[name].launches
    got = _estimate_elem_gains(off, st, alive, 8, allowed, keys, cfg)
    torch.cuda.synchronize()
    assert engines[name].launches == before
    rtol, atol = PER_SAMPLE_TOL[name]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_cluster_diversity_on_card_matches_cpu(cuda):
    """Counts bitwise (integers in f32, whatever order the atomics run
    in), values, gains and set gains as on the CPU."""
    from repro_torch.core import ClusterDiversity

    rng = np.random.default_rng(0)
    n, c = 65536, 64
    cl = rng.integers(0, c, n)
    masks = torch.from_numpy(rng.uniform(size=(4, n)) < np.array(
        [[0.0], [0.01], [0.3], [0.9]]))
    idx = torch.from_numpy(rng.integers(0, n, (4, 8, 10)))
    valid = torch.from_numpy(rng.uniform(size=(4, 8, 10)) < 0.8)
    out = {}
    for dev in ("cpu", "cuda"):
        div = ClusterDiversity(cl, c, 0.2, device=dev)
        m = masks.to(dev)
        out[dev] = [div.counts(m), div.value(m), div.gains(m),
                    div.gains_at(m, idx[:, 0].to(dev)),
                    div.set_gain(m, idx.to(dev), valid.to(dev))]
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_checkpointed_dash_kill_and_resume_on_card(cuda, tmp_path):
    """dash_checkpointed on the card: stepped equals fused, and a run
    killed at round 2 and resumed from its snapshot equals the
    uninterrupted run bit for bit (set, value, trace)."""
    from repro_torch.core import (
        DashConfig,
        ResilienceConfig,
        SeedKey,
        dash,
        dash_checkpointed,
    )
    from repro_torch.runtime import FailureInjector

    obj = _slice6_problem("regression", cuda)
    cfg = DashConfig(k=40, eps=0.25, alpha=0.6, n_samples=8)
    opt = float(torch.max(obj.gains(obj.init()))) * 12.0
    key = SeedKey(0)
    fused = dash(obj, cfg, key, opt)
    whole = dash_checkpointed(obj, cfg, key, opt,
                              resilience=ResilienceConfig())
    res = ResilienceConfig(ckpt_dir=str(tmp_path), every=1)
    with pytest.raises(RuntimeError, match="injected"):
        dash_checkpointed(obj, cfg, key, opt, resilience=res,
                          failure_injector=FailureInjector(fail_at=(2,)))
    resumed = dash_checkpointed(obj, cfg, key, opt, resilience=res,
                                resume=True)
    for run in (whole, resumed):
        assert torch.equal(run.sel_mask, fused.sel_mask)
        assert float(run.value) == float(fused.value)
        for f in fused.trace._fields:
            assert torch.equal(getattr(run.trace, f), getattr(fused.trace, f))


def test_coreset_features_on_card_match_cpu(cuda):
    """The reduced danube (f32) on the card — attention through the
    flash kernel — against the CPU, all three modes, within 1e-4."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.objectives import coreset_features
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_to

    cfg = get_reduced_config("h2o-danube-1.8b")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    dev_params = params_to(params, cuda)
    for mode in ("embed", "hidden", "grad"):
        want = coreset_features(model, params, {"tokens": tok}, mode=mode)
        before = flash_attention.launches
        got = coreset_features(model, dev_params, {"tokens": tok.to(cuda)},
                               mode=mode)
        torch.cuda.synchronize()
        if mode != "embed":
            assert flash_attention.launches == before + cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# kernel 8: flash attention
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 against the output's own scale, as chip_smoke.py gates long rows:
# the largest max_d |err| / rms_d(out) over the (b, q, h) rows, against
# the plain version in float64.
FLASH_BF16_REL = 0.1
FLASH_SHAPES = [  # sq, skv, h, hkv, d: GQA 1, 2, 8, 4 and 3; every head_dim
    (128, 128, 4, 4, 32), (130, 200, 4, 2, 32), (64, 256, 8, 1, 64),
    (100, 157, 8, 2, 80), (257, 300, 6, 2, 128), (33, 33, 4, 1, 16),
    (1000, 1537, 8, 2, 80),
]
FLASH_MASKS = [  # causal, window, softcap
    (True, 0, 0.0), (True, 48, 0.0), (False, 0, 0.0), (True, 0, 30.0),
    (False, 40, 0.0),
]


def _flash_inputs(dev, b, sq, skv, h, hkv, d, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, sq, h, d), (b, skv, hkv, d),
                               (b, skv, hkv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,h,hkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_attention_kernel(cuda, dtype, sq, skv, h, hkv, d, causal,
                                window, cap):
    q, k, v = _flash_inputs(cuda, 2, sq, skv, h, hkv, d, dtype, seed=sq + d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=cap)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (1, 100, 99, 0), (1, 100, 99, 16), (7, 64, 57, 0), (70, 4200, 4130, 64)])
def test_flash_attention_q_offset(cuda, dtype, sq, skv, q_offset, window):
    q, k, v = _flash_inputs(cuda, 3, sq, skv, 8, 2, 80, dtype)
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)
    want = flash_attention_ref(q, k, v, causal=True, window=window,
                               q_offset=q_offset)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The bf16 kernel at head_dim 64, 80 and 128 stacks a GQA group's n_rep
# query heads into the rows of a 192-row tile (192 / n_rep positions per
# CTA: 192, 48, 64 and 38 for n_rep 1, 4, 3 and 5) and walks K/V in
# blocks of 128 keys (64 at D 128): lengths one short of and one past a
# tile, and one short of and one past two blocks.
FLASH_EDGE_SHAPES = [  # sq, skv, h, hkv, d
    (191, 257, 4, 4, 64), (193, 255, 4, 4, 64), (47, 257, 8, 2, 80),
    (49, 255, 8, 2, 80), (63, 257, 6, 2, 64), (65, 255, 6, 2, 64),
    (37, 129, 10, 2, 128), (39, 127, 10, 2, 128),
]


def _check_flash(q, k, v, **kw):
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("sq,skv,h,hkv,d", FLASH_EDGE_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_flash_attention_tile_edges(cuda, sq, skv, h, hkv, d, causal,
                                    window):
    q, k, v = _flash_inputs(cuda, 2, sq, skv, h, hkv, d, torch.bfloat16,
                            seed=sq + skv)
    _check_flash(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("window", [64, 65, 128, 129, 256, 257])
def test_flash_attention_window_on_block_edges(cuda, window):
    """A window that ends exactly on a block boundary (128 keys at D 80),
    or one key past it, so a block is wholly inside the band or has one
    masked pair; and at half a block."""
    q, k, v = _flash_inputs(cuda, 2, 300, 300, 8, 2, 80, torch.bfloat16,
                            seed=window)
    _check_flash(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("h,hkv,d", [(9, 3, 64), (40, 8, 128)])
@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_attention_gqa_groups(cuda, h, hkv, d, causal, window, cap):
    """smollm's n_rep 3 at D 64 and qwen2.5-14b's n_rep 5 at D 128 (5
    does not divide the 192-row tile)."""
    q, k, v = _flash_inputs(cuda, 2, 150, 170, h, hkv, d, torch.bfloat16,
                            seed=h + d)
    _check_flash(q, k, v, causal=causal, window=window, softcap=cap)


def test_flash_attention_danube_heads_past_the_window(cuda):
    """danube's heads (H 32, Hkv 8, D 80) at S 4200 with window 4096:
    interior blocks unmasked, the diagonal and the window edge masked.
    Late rows' outputs are a few hundredths, the size of FLASH_TOL, so
    every row is also held to its own scale (FLASH_BF16_REL), and the
    output scaled by 0.9 must miss that gate."""
    kw = dict(causal=True, window=4096)
    q, k, v = _flash_inputs(cuda, 1, 4200, 4200, 32, 8, 80, torch.bfloat16,
                            seed=4200)
    got = _check_flash(q, k, v, **kw).double()
    q, k, v = q.double(), k.double(), v.double()
    want = torch.cat([  # one KV group at a time: its scores fit
        flash_attention_ref(q[:, :, 4 * g:4 * g + 4], k[:, :, g:g + 1],
                            v[:, :, g:g + 1], **kw) for g in range(8)], dim=2)
    rms = want.pow(2).mean(-1).sqrt()

    def rel(o):
        return float(((o - want).abs().amax(-1) / rms).max())

    assert rel(got) <= FLASH_BF16_REL
    assert rel(0.9 * got) > FLASH_BF16_REL


# head_dim 256 (recurrentgemma's local attention: H 10, Hkv 1, window
# 2048): the bf16 kernel stacks the 10 query heads into a 128-row tile
# (12 positions a CTA) and walks K/V in blocks of 64 keys.  Lengths one
# short of and one past a tile and a block, ragged Sq and Skv with a
# q_offset, and a prompt past the window.
FLASH_256_CASES = [  # b, sq, skv, h, hkv, causal, window, softcap, q_offset
    (2, 11, 63, 10, 1, True, 0, 0.0, 52), (2, 13, 65, 10, 1, True, 0, 0.0, 52),
    (2, 100, 157, 10, 1, True, 48, 0.0, 57),
    (2, 129, 129, 10, 1, False, 0, 30.0, 0),
    (1, 2200, 2200, 10, 1, True, 2048, 0.0, 0),
    (2, 70, 90, 4, 2, True, 0, 0.0, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,window,cap,q_offset",
                         FLASH_256_CASES)
def test_flash_attention_head_dim_256(cuda, dtype, b, sq, skv, h, hkv,
                                      causal, window, cap, q_offset):
    """Kernel 8 at head_dim 256 against its plain version; in bf16 also
    every row against its own scale in float64 (FLASH_BF16_REL), which
    the output scaled by 0.9 must miss."""
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    q, k, v = _flash_inputs(cuda, b, sq, skv, h, hkv, 256, dtype,
                            seed=sq + skv)
    got = _check_flash(q, k, v, **kw)
    if dtype == torch.bfloat16:
        want = flash_attention_ref(q.double(), k.double(), v.double(), **kw)
        rms = want.pow(2).mean(-1).sqrt()

        def rel(o):
            return float(((o.double() - want).abs().amax(-1) / rms).max())

        assert rel(got) <= FLASH_BF16_REL
        assert rel(0.9 * got.double()) > FLASH_BF16_REL


# Slice 10's shapes: whisper's encoder (non-causal, S 1500 frames), its
# cross-attention against the frames in the prefill (Sq 384) and at a
# decode step (Sq 1), and internvl2's prefill (GQA 16/8, D 128, 256 image
# + 7680 text tokens).
FLASH_SLICE10_CASES = [  # b, sq, skv, h, hkv, d, causal
    (4, 1500, 1500, 8, 8, 64, False), (4, 384, 1500, 8, 8, 64, False),
    (4, 1, 1500, 8, 8, 64, False), (1, 7936, 7936, 16, 8, 128, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", FLASH_SLICE10_CASES)
def test_flash_attention_encdec_and_vlm_shapes(cuda, dtype, b, sq, skv, h,
                                               hkv, d, causal):
    """Kernel 8 at slice 10's shapes against its plain version; in bf16
    also every row against its own scale in float64 (FLASH_BF16_REL, one
    KV group at a time), which the output scaled by 0.9 must miss."""
    q, k, v = _flash_inputs(cuda, b, sq, skv, h, hkv, d, dtype,
                            seed=sq + skv + d)
    got = _check_flash(q, k, v, causal=causal)
    if dtype == torch.bfloat16:
        r = h // hkv
        q, k, v = q.double(), k.double(), v.double()
        want = torch.cat([
            flash_attention_ref(q[:, :, g * r:(g + 1) * r], k[:, :, g:g + 1],
                                v[:, :, g:g + 1], causal=causal)
            for g in range(hkv)], dim=2)
        rms = want.pow(2).mean(-1).sqrt()

        def rel(o):
            return float(((o.double() - want).abs().amax(-1) / rms).max())

        assert rel(got) <= FLASH_BF16_REL
        assert rel(0.9 * got.double()) > FLASH_BF16_REL


# ---------------------------------------------------------------------------
# the MoE and RG-LRU layers (no kernel of their own): the card against the
# CPU in f32, tolerance LAYER_TOL (another summation order in every
# product over d_model 64)
# ---------------------------------------------------------------------------

LAYER_TOL = 1e-4
# The reduced xlstm-125m's logits: its 8 layers pass rounding on 2–3×
# amplified (the mLSTM divides by max(|nᵀq|, e^{−m})), so on the CPU the
# JAX reference's own logits move by up to 4.5e-4 when its weights get
# half an ulp of noise (tests/test_torch_encdec_vlm.py's XLSTM_TOL); the
# card read 2.821e-04 from the CPU (chip_smoke.py's [xlstm parity]).
XLSTM_TOL = 5e-4


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("skew", [False, True])
def test_moe_layer_card_matches_cpu(cuda, arch, skew):
    """The reduced MoE layer on the card against the CPU: the dispatch
    (counts, kept) equal, output and aux within LAYER_TOL; ``skew``
    routes every token to expert 0 first, which overflows."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.layers import moe

    cfg = get_reduced_config(arch)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    if skew:
        params["router"] = torch.zeros_like(params["router"])
        params["router"][:, 0] = 10.0
        x = x.abs()
    gp = {k: v.to(cuda) for k, v in params.items()}
    want, waux = moe.moe_apply(params, x, cfg)
    got, gaux = moe.moe_apply(gp, x.to(cuda), cfg)
    for a, b in zip(moe.dispatch_counts(params, x, cfg)[:2],
                    moe.dispatch_counts(gp, x.to(cuda), cfg)[:2]):
        assert torch.equal(a, b.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    torch.testing.assert_close(gaux.cpu(), waux, rtol=LAYER_TOL,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_layer_card_matches_cpu(cuda, with_state):
    """The reduced RG-LRU layer's prefill (S 700: ten scan steps) and
    three decode steps on the card against the CPU."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.layers import rglru

    cfg = get_reduced_config("recurrentgemma-2b")
    gen = torch.Generator().manual_seed(2)
    params = rglru.init_rglru(gen, cfg, torch.float32)
    x = torch.randn((2, 703, cfg.d_model), generator=gen)
    st = None
    if with_state:
        st = rglru.RGLRUState(
            torch.randn((2, cfg.recurrent.width), generator=gen),
            torch.randn((2, cfg.recurrent.conv_width - 1,
                         cfg.recurrent.width), generator=gen))
    gp = {k: v.to(cuda) for k, v in params.items()}
    gst = None if st is None else rglru.RGLRUState(*(t.to(cuda) for t in st))
    outs = {}
    for dev, p, s0 in (("cpu", params, st), ("cuda", gp, gst)):
        y, s1 = rglru.rglru_apply(p, x[:, :700].to(dev), cfg, state=s0)
        steps = [y]
        for i in range(3):
            yi, s1 = rglru.rglru_decode_step(p, x[:, 700 + i:701 + i]
                                             .to(dev), cfg, s1)
            steps.append(yi)
        outs[dev] = [t.cpu() for t in (*steps, *s1)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-base",
                                  "internvl2-2b"])
def test_slice10_archs_card_match_cpu(cuda, arch):
    """The reduced xlstm-125m, whisper-base and internvl2-2b (f32) on the
    card against the CPU on the same weights and batch (image embeddings,
    encoder frames): prefill and decode logits within LAYER_TOL (xlstm
    within XLSTM_TOL), greedy tokens identical; whisper's encoder and
    cross-attention and internvl2's prefill launch kernel 8."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.lm_serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_to

    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"cpu": model.init(gen)}
    params[cuda] = params_to(params["cpu"], cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen, dtype=torch.int32)}
    if cfg.vision is not None:
        batch["img_embeds"] = torch.randn(
            (2, cfg.vision.n_img_tokens, cfg.vision.embed_dim), generator=gen)
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn(
            (2, cfg.encoder.src_len, cfg.d_model), generator=gen)
    outs = {}
    for dev in ("cpu", cuda):
        p = params[dev]
        t = {k: v.to(dev) for k, v in batch.items()}
        before = flash_attention.launches
        lg, cache = model.prefill(p, t)
        lg2, _ = model.decode_step(p, cache, t["tokens"][:, :1],
                                   cache["step_offset"])
        launched = flash_attention.launches - before
        toks = generate(model, p, t, 8, device=dev)
        outs[dev] = [x.cpu() for x in (lg, lg2, toks)]
        if dev is cuda:
            want = {"xlstm-125m": 0, "internvl2-2b": cfg.n_layers}.get(arch)
            if cfg.is_encdec:   # encoder, self and cross; cross in decode
                want = cfg.encoder.n_layers + 3 * cfg.n_layers
            assert launched == want
    tol = XLSTM_TOL if arch == "xlstm-125m" else LAYER_TOL
    for a, b in zip(outs["cpu"][:2], outs[cuda][:2]):
        torch.testing.assert_close(b, a, rtol=tol, atol=tol)
    assert torch.equal(outs["cpu"][2], outs[cuda][2])


def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 32, torch.float32)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="dtype|float16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    q3, k3, v3 = _flash_inputs(cuda, 1, 64, 64, 4, 3, 32, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q3, k3, v3)
    q48, k48, v48 = _flash_inputs(cuda, 1, 64, 64, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q48, k48, v48)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the sharded runtime on the card (spawned ranks: NCCL at world 1, gloo at
# world 2, both ranks of world 2 on the one card)
# ---------------------------------------------------------------------------

SHARDED_AXES = ("pod", "data", "model")
# The kernel wrappers each objective's sharded DASH launches.
SHARDED_KERNELS = {
    "regression": ("regression_gains", "filter_gains"),
    "aopt": ("aopt_gains", "aopt_filter_gains"),
    "logistic": ("logistic_gains", "logistic_filter_gains"),
}


def _kernel_wrappers():
    from repro_torch.kernels.aopt_gains import ops as aopt_ops
    from repro_torch.kernels.filter_gains import ops as filter_ops
    from repro_torch.kernels.logistic_gains import ops as logistic_ops
    from repro_torch.kernels.marginal_gains import ops as marginal_ops

    return {"regression_gains": marginal_ops.regression_gains,
            "filter_gains": filter_ops.filter_gains,
            "aopt_gains": aopt_ops.aopt_gains,
            "aopt_filter_gains": filter_ops.aopt_filter_gains,
            "logistic_gains": logistic_ops.logistic_gains,
            "logistic_filter_gains": filter_ops.logistic_filter_gains}


def _sharded_dash_rank(name, world):
    """One rank: DASH through select(..., mesh=) on (pod 1, data 1, model
    world) at OPT = 1.05 × greedy's value and α = 1, where every
    objective's first rounds filter (and launch its engine); the result
    and this rank's launches."""
    from repro_torch.core import SeedKey, greedy, select
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1, world), SHARDED_AXES)
    obj = _slice6_problem(name, mesh.device)
    opt = float(greedy(obj, 40).value) * 1.05
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = select("dash", obj, 40, SeedKey(0, host=True), mesh=mesh, opt=opt,
                 alpha=1.0, eps=0.25, n_samples=4)
    return res.raw, {k: fn.launches for k, fn in wrappers.items()}


@pytest.mark.parametrize("name", ["regression", "aopt", "logistic"])
def test_sharded_dash_world2_matches_world1_on_card(cuda, name):
    """World 2 (gloo, both ranks on the card, n_local = n/2) selects the
    set of world 1 (NCCL), with the same value and trace; every rank of
    world 2 launches the objective's two kernels."""
    from repro_torch.launch.mesh import spawn_ranks

    (one, _), = spawn_ranks(_sharded_dash_rank, 1, (name, 1),
                            device="cuda", timeout_s=600)
    two = spawn_ranks(_sharded_dash_rank, 2, (name, 2), device="cuda",
                      timeout_s=600)
    for res, launches in two:
        np.testing.assert_array_equal(res.sel_mask, one.sel_mask)
        np.testing.assert_allclose(res.trace.values, one.trace.values,
                                   rtol=1e-5, atol=1e-6)
        for kernel in SHARDED_KERNELS[name]:
            assert launches[kernel] > 0, (kernel, launches)
    assert int(one.sel_count) > 0


def _x_local_devices_rank():
    """World 1 on the card: every oracle call sees X_local on the card,
    and kernels 1 and 3 launch."""
    from repro_torch.core import DashConfig, SeedKey
    from repro_torch.core.distributed import dash_distributed, shard_columns
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"))
    obj = _slice6_problem("regression", mesh.device)
    seen = {"shard": shard_columns(obj.X, mesh, "model").device.type}
    for meth in ("dist_gains", "dist_add_set", "dist_filter_gains_batch"):
        orig = getattr(obj, meth)

        def spy(*a, _orig=orig, _meth=meth):
            seen.setdefault(_meth, set()).add(a[-1].device.type)
            return _orig(*a)

        setattr(obj, meth, spy)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    opt = float(torch.max(obj.gains(obj.init()))) * 12.0
    dash_distributed(obj, DashConfig(k=40, eps=0.25, alpha=0.6, n_samples=8),
                     SeedKey(0), opt, mesh)
    return ({k: sorted(v) if isinstance(v, set) else v
             for k, v in seen.items()},
            {k: fn.launches for k, fn in wrappers.items()})


def test_cuda_mesh_keeps_x_local_on_the_card(cuda):
    from repro_torch.launch.mesh import spawn_ranks

    (seen, launches), = spawn_ranks(_x_local_devices_rank, 1, (),
                                    device="cuda", timeout_s=600)
    assert seen["shard"] == "cuda"
    for meth in ("dist_gains", "dist_add_set", "dist_filter_gains_batch"):
        assert seen[meth] == ["cuda"], (meth, seen)
    assert launches["regression_gains"] > 0
    assert launches["filter_gains"] > 0


# ---------------------------------------------------------------------------
# the selection service on the card
# ---------------------------------------------------------------------------

def _serve_d1():
    from repro_torch.data.synthetic import make_d1_regression

    X, y, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                 support=40)
    return X, y


def _served(dev, reqs, chaos=None):
    from repro_torch.runtime.hedging import HedgePolicy
    from repro_torch.serve import SelectionServer

    srv = SelectionServer(device=dev, chaos=chaos, hedge=HedgePolicy(
        max_attempts=3, backoff_s=0.0, sleep_fn=lambda s: None))
    X, y = _serve_d1()
    srv.register("d1", "regression", X, y, kmax=40)
    return srv, srv.serve(reqs)


def test_serve_small_d1_matches_cpu(cuda):
    """A DASH bucket, stochastic greedy and TOP-k on the small D1 through
    the service: the card's sets are the CPU's, noise drawn on the
    host; the card's run launches kernels 1 and 3 (OPT pinned at 1.0,
    where DASH filters; at the TOP-k probe's guess it does not)."""
    from repro_torch.core import SeedKey
    from repro_torch.serve import SelectRequest

    reqs = [SelectRequest("d1", 40, SeedKey(s, host=True), opt=1.0)
            for s in range(3)]
    reqs += [SelectRequest("d1", 20, SeedKey(7, host=True),
                           algo="stochastic_greedy"),
             SelectRequest("d1", 20, SeedKey(8, host=True), algo="topk")]
    _, cpu = _served("cpu", reqs)
    regression_gains.launches = filter_gains.launches = 0
    _, card = _served(cuda, reqs)
    assert regression_gains.launches > 0 and filter_gains.launches > 0
    for a, b in zip(cpu, card):
        assert a.ok and b.ok and a.tier == b.tier
        np.testing.assert_array_equal(a.sel_mask, b.sel_mask)
        assert abs(a.value - b.value) <= 1e-4


def test_serve_hedged_resume_is_bitwise(cuda):
    """A launch killed at rounds 1 and 3 and resumed from its last round
    commits the unfailed run's sets and values, bit for bit."""
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serve import SelectRequest

    reqs = [SelectRequest("d1", 40, s) for s in range(3)]
    _, base = _served(cuda, reqs)
    srv, hedged = _served(cuda, reqs, chaos=FailureInjector(fail_at=(1, 3)))
    assert srv.stats["hedge_retries"] == 2
    for a, b in zip(base, hedged):
        assert b.attempts == 3
        np.testing.assert_array_equal(a.sel_mask, b.sel_mask)
        assert a.value == b.value


def test_serve_warm_update_rebuilds_objective_not_runners(cuda):
    """A warm column update on the card: a new X tensor (the old one
    untouched), the objective rebuilt, no runner built, and the sets of
    a fresh server on the patched data."""
    from repro_torch.serve import SelectRequest, SelectionServer

    reqs = [SelectRequest("d1", 40, s) for s in range(2)]
    srv, _ = _served(cuda, reqs)
    entry = srv.cache.get("d1")
    X0, X0_copy = entry.arrays["X"], entry.arrays["X"].clone()
    builds, objs = entry.builds, entry.objective_builds
    cols = np.random.default_rng(3).normal(size=(600, 4)).astype(np.float32)
    srv.update_columns("d1", [1, 50, 99, 150], cols)
    warm = srv.serve(reqs)
    assert torch.equal(X0, X0_copy)
    assert entry.builds == builds and entry.objective_builds == objs + 1
    assert entry.arrays["X"].is_cuda
    X, y = _serve_d1()
    X2 = np.array(X, copy=True)
    X2[:, [1, 50, 99, 150]] = cols
    fresh = SelectionServer(device=cuda)
    fresh.register("d1", "regression", X2, y, kmax=40)
    for a, b in zip(warm, fresh.serve(reqs)):
        np.testing.assert_array_equal(a.sel_mask, b.sel_mask)


# ---------------------------------------------------------------------------
# slice 11: training
# ---------------------------------------------------------------------------

# One f32 train step on the card against the CPU from the same state:
# the loss and the grad norm relative, m (the clipped gradient / 10)
# over its largest entry, the largest parameter change relative
# (chip_smoke.py's TRAIN_PARITY_TOL, at the reduced width).
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-5, step=1e-5, m=1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", "grok-1-314b"])
def test_train_step_card_matches_cpu(cuda, arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_to
    from repro_torch.tree import tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=10, learning_rate=1e-3, warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(model, gen, tcfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                           dtype=torch.int32)
    step = make_train_step(model, tcfg)
    out = {}
    for dev in ("cpu", cuda):
        new, met = step(params_to(state, dev), {"tokens": tokens.to(dev)})
        change = max(float((a.cpu() - b).abs().max()) for a, b in
                     zip(tree_leaves(new.params), tree_leaves(state.params)))
        out[dev] = (float(met["loss"]), float(met["grad_norm"]), change,
                    [m.cpu() for m in tree_leaves(new.opt.m)])
    cpu, card = out["cpu"], out[cuda]
    for i, name in enumerate(("loss", "grad_norm", "step")):
        assert abs(card[i] - cpu[i]) <= TRAIN_TOL[name] * abs(cpu[i]), name
    scale = max(float(m.abs().max()) for m in cpu[3])
    assert max(float((a - b).abs().max()) for a, b in
               zip(card[3], cpu[3])) <= TRAIN_TOL["m"] * scale


def test_train_full_width_bf16_steps_fall(cuda):
    """smollm-135m at published width and depth, bf16 with an f32
    master, remat on: four steps on a batch of 2 × 512 tokens of the Zipf
    stream give finite losses whose last two average below the first
    two."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, learning_rate=3e-3, warmup_steps=1)
    state = init_train_state(model, torch.Generator(device=cuda)
                             .manual_seed(0), tcfg)
    toks = make_lm_tokens(0, 4 * 2 * 512, cfg.vocab_size).reshape(4, 2, 512)
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(4):
        state, met = step(state, {"tokens": torch.from_numpy(toks[i]).to(
            cuda)})
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))
    assert sum(losses[-2:]) < sum(losses[:2]), losses


def test_train_loop_selection_launches_kernels(cuda):
    """``train_loop`` with a DASH selector on reduced smollm on the card:
    the grad features' backbone goes through kernel 8 (once per layer
    per chunk of k rows) and the selection through kernel 4; the
    selections are k distinct pool rows."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import BatchSelector, TokenPipeline, make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.train import train_loop

    cfg = get_reduced_config("smollm-135m")
    toks = make_lm_tokens(1, 60_000, cfg.vocab_size)
    before = flash_attention.launches, aopt_gains.launches
    with TokenPipeline(toks, batch=4, seq=32) as pipe:
        res = train_loop(build_model(cfg), TrainConfig(total_steps=4),
                         pipe, device=cuda,
                         selector=BatchSelector(4, algo="dash",
                                                embed_dim_cap=32,
                                                n_samples=4),
                         selection_every=2, selection_pool_factor=3)
    flash = flash_attention.launches - before[0]
    assert flash == 2 * (3 * 2) * cfg.n_layers   # periods x chunks x layers
    assert aopt_gains.launches - before[1] > 0
    for ids in res.selections.values():
        assert len(set(ids.tolist())) == 8


def _sharded_step_world1_rank():
    """World 1 on the card (NCCL): two steps of reduced smollm in bf16
    through ``make_train_step(mesh=)`` and through the single-device
    step, from one state on the same batches; the two runs' leaves."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    mesh = make_host_mesh()
    cfg = dataclasses.replace(get_reduced_config("smollm-135m"),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=4, learning_rate=1e-3, warmup_steps=1)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    state = init_train_state(model, gen, tcfg)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 64)).astype(
        np.int32)} for _ in range(2)]
    out = {}
    for name, step in (("mesh", make_train_step(model, tcfg, mesh=mesh)),
                       ("single", make_train_step(model, tcfg))):
        st, losses = state, []
        for b in batches:
            dev = (shard_batch(b, mesh) if name == "mesh" else
                   {k: torch.from_numpy(v).to(mesh.device)
                    for k, v in b.items()})
            st, met = step(st, dev)
            losses.append(float(met["loss"]))
        out[name] = (losses, [t.float().cpu().numpy()
                              for t in tree_leaves(st)])
    return out


def test_sharded_step_world1_is_the_single_device_step_on_card(cuda):
    """World 1 (NCCL, mesh (1, 1)): the data-parallel step is the
    single-device step bit for bit (the batch axes hold one rank, so no
    collective touches the gradients)."""
    from repro_torch.launch.mesh import spawn_ranks

    (out,) = spawn_ranks(_sharded_step_world1_rank, 1, device="cuda",
                         timeout_s=600)
    assert out["mesh"][0] == out["single"][0]
    for a, b in zip(out["mesh"][1], out["single"][1]):
        np.testing.assert_array_equal(a, b)


def test_engine_on_card_matches_generate_on_card(cuda):
    """``ServeEngine`` on the card (kernel 8 in every admission's
    prefill) gives each request the card's own greedy ``generate`` of
    it alone, on reduced danube in f32 (ring caches: window 32, prompts
    past it)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.lm_serve import generate
    from repro_torch.models import build_model
    from repro_torch.train import ServeEngine

    cfg = get_reduced_config("h2o-danube-1.8b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 12, 50, 7)]
    before = flash_attention.launches
    engine = ServeEngine(model, params, max_batch=2, max_seq=96, eos_id=-1,
                         device="cuda")
    rids = [engine.submit(p, max_new=6) for p in prompts]
    outs = engine.run_until_done()
    assert flash_attention.launches - before == cfg.n_layers * len(prompts)
    for p, rid in zip(prompts, rids):
        want = generate(model, params, {"tokens": p[None]}, 6,
                        device="cuda")
        np.testing.assert_array_equal(outs[rid], want[0].cpu().numpy())
