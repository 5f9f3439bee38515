"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present (decided in
the ``cuda`` fixture, never at import).  Run them on a machine with the
card:  python -m pytest -q -m gpu tests/test_torch_gpu.py
Tolerance: ``STREAM_PARITY_TOL[...]["kernel_vs_ref"]`` = 2e-4 rtol and
atol, kernel and plain version on the same (quantized) inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.common import (  # noqa: E402
    STREAM_PARITY_TOL,
    quantize,
    set_full_f32_matmul,
)
from repro_torch.kernels.filter_gains import (  # noqa: E402
    filter_gains,
    filter_gains_lattice_ref,
)
from repro_torch.kernels.marginal_gains import (  # noqa: E402
    regression_gains,
    regression_gains_ref,
)

pytestmark = pytest.mark.gpu
TOL = STREAM_PARITY_TOL["f32"]["kernel_vs_ref"]


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
