"""The sharded twins on inputs with exact ties, against the single-device
port and the JAX reference, on the CPU.

Each input's gains tie in exact arithmetic: the regression, logistic
and scaled design problems' first 6 columns, 8 copies each at seeded
positions, and the unit-norm design (every singleton gain 0.5).  A tie
breaks to the lowest index only where every copy of a column gets the
same bits, in a call over all n columns and in one over a shard of
them: the plain
versions sum each column in an order fixed by d, never by the width of
the call (``kernels/common.py::by_column_blocks``; kernel 4's by
halving d).  So greedy, stochastic greedy, TOP-k and FAST (its prefix
sweeps through the filter engine) at model widths 1, 2 and 4 give the
single-device port's set, count, value and trace bit for bit (FAST at
1.05 × greedy's value).  (Sharded DASH draws other noise than one
device's; ``tests/test_torch_distributed_lattice.py`` holds it to
itself across widths.)  Both sides of that gate share the plain
versions, so the single-device port is also held to the reference's
own ``select`` on the same inputs, key and OPT (its jnp sums do not
depend on the width): the same set and count, values within VAL_RTOL.
The port runs on four gloo ranks with ``JaxKey`` noise, beside the
reference's subprocess.  On the unit-norm design the singleton gains
tie only in exact arithmetic: in f32 each column's rounding picks the
winner, and the port's sums over d run in another order than XLA's (as
``tests/test_torch_distributed_baselines.py`` notes), so TOP-k and
stochastic greedy there are held to the port's own single-device set
only.  The copies tie in f32 too, in both packages, and there every
algorithm is held to the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import greedy, select  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

AXES = ("pod", "data", "model")
WIDTHS = (1, 2, 4)
TIED = ("reg_tied", "logi_tied", "aopt_tied", "aopt")
ALGOS = ("greedy", "stochastic_greedy", "topk", "fast")
CASES = [(name, algo) for name in TIED for algo in ALGOS]
# The unit-norm design's f32 rounding ties (see above).
REF_CASES = [c for c in CASES
             if c not in (("aopt", "topk"), ("aopt", "stochastic_greedy"))]


def _runs(opt, mesh):
    """Every algorithm on every tied input: sharded over ``mesh``, or on
    one device when ``mesh`` is None."""
    out = {}
    for name in TIED:
        obj, k = H.port_objective(name)
        for algo in ALGOS:
            kw = {"opt": opt[name]} if algo == "fast" else {}
            key = H.JaxKey.seed(3)
            r = (select(algo, obj, k, key, device="cpu", **kw)
                 if mesh is None else
                 select(algo, obj, k, key, mesh=mesh, **kw))
            out[name, algo] = (r.sel_mask, int(r.sel_count), r.value,
                               r.values)
    return out


def _port(opt):
    out = {w: _runs(opt, make_mesh((4 // w, 1, w), AXES, device="cpu"))
           for w in WIDTHS}
    out["single"] = _runs(opt, None)
    return out


@pytest.fixture(scope="module")
def runs():
    opt = {}
    for name in TIED:
        obj, k = H.port_objective(name)
        opt[name] = float(greedy(obj, k, device="cpu").value) * 1.05
    ref = H.start_reference(f"""
        from repro.core import select
        out = {{}}
        for name in {TIED!r}:
            obj, k = ref_objective(name)
            for algo in {ALGOS!r}:
                kw = {{"opt": {opt!r}[name]}} if algo == "fast" else {{}}
                r = select(algo, obj, k, key=jax.random.PRNGKey(3), **kw)
                out[name + "/" + algo] = dict(
                    sel=mask_idx(r.sel_mask), value=float(r.value),
                    count=int(r.sel_count))
        print(json.dumps(out))
    """)
    try:
        port = H.launch(_port, 4, opt)
    finally:
        want = H.finish_reference(ref)
    return port, want


def test_every_rank_returns_the_same_result(runs):
    H.same_on_every_rank(runs[0])


@pytest.mark.parametrize("name,algo", CASES,
                         ids=[f"{n}-{a}" for n, a in CASES])
def test_tied_twin_matches_single_device_bitwise(runs, name, algo):
    """At model widths 1, 2 and 4 the twin gives the single-device
    port's set, count, value and trace bit for bit."""
    port = runs[0][0]
    single = port["single"][name, algo]
    assert single[1] > 0
    for w in WIDTHS:
        assert H._bits(port[w][name, algo]) == H._bits(single), w


@pytest.mark.parametrize("name,algo", REF_CASES,
                         ids=[f"{n}-{a}" for n, a in REF_CASES])
def test_tied_single_device_matches_reference(runs, name, algo):
    """The single-device port breaks the ties as the reference does: its
    set and count, values within VAL_RTOL."""
    sel, count, value, _ = runs[0][0]["single"][name, algo]
    ref = runs[1][f"{name}/{algo}"]
    assert H.idx(sel) == ref["sel"]
    assert count == ref["count"]
    np.testing.assert_allclose(float(value), ref["value"], rtol=H.VAL_RTOL,
                               atol=H.VAL_ATOL)
