"""The port's sharded §5 baselines and FAST against their JAX reference
twins on a (data 2, model 2) mesh, on the CPU.

Each of greedy, stochastic greedy, TOP-k, RANDOM and FAST (binary search
over 8 guesses; regression also with a pinned OPT) runs through
``select(algo, obj, k, key, mesh=...)`` in both packages, the port on
four gloo ranks with ``JaxKey`` noise.  The port must give the
reference twin's set and count (and FAST's rounds and OPT), values
within VAL_RTOL 1e-5, and the port's single-device result's set (the
twins are built for set-identical picks).  Also: k > n saturates at n,
and zero padding columns are never selected.

Every singleton gain of the unit-norm design is 0.5 in exact
arithmetic, so greedy, stochastic greedy and TOP-k break f32 ties there,
and the port's sums over d run in another order than XLA's.  Those three
run on the scaled design (seeded column factors in [0.5, 1.5], no ties)
against the reference, as in ``tests/test_torch_aopt.py``.  On the
unit-norm design they are held to the port's single-device set: the
plain A-optimal gains sum each column in an order fixed by d, so a
shard's gains are the whole sweep's bits and the ties break alike; TOP-k
is also checked against the port's own gains within TIE_RTOL.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import greedy, select  # noqa: E402
from repro_torch.core.distributed import pad_ground_set  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

ALGOS = ("greedy", "stochastic_greedy", "topk", "random", "fast")
TIED = ("greedy", "stochastic_greedy", "topk")
CASES = [(("aopt_scaled" if name == "aopt" and algo in TIED else name), algo)
         for name in ("reg", "aopt", "logi") for algo in ALGOS]
CASES.append(("reg", "fast-pinned"))
# Relative margin under which two f32 gains of the unit-norm design tie.
TIE_RTOL = 1e-6


def _call(algo, obj, k, key, mesh, opt):
    if algo == "fast-pinned":
        return select("fast", obj, k, key, mesh=mesh, opt=opt, device="cpu")
    return select(algo, obj, k, key, mesh=mesh, device="cpu")


def _port(opt):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"twin": {}, "single": {}, "edge": {}}
    for name, algo in CASES:
        obj, k = H.port_objective(name)
        out["twin"][name, algo] = _call(algo, obj, k, H.JaxKey.seed(0),
                                        mesh, opt)
        out["single"][name, algo] = _call(algo, obj, k, H.JaxKey.seed(0),
                                          None, opt)
    obj, k = H.port_objective("aopt")
    for algo in TIED:
        out["edge"]["tied", algo] = select(algo, obj, k, H.JaxKey.seed(0),
                                           mesh=mesh)
        out["edge"]["tied-single", algo] = select(algo, obj, k,
                                                  H.JaxKey.seed(0),
                                                  device="cpu")
    for algo in ("greedy", "topk", "random", "fast"):
        out["edge"]["k>n", algo] = select(algo, obj, obj.n + 16,
                                          H.JaxKey.seed(0), mesh=mesh)
    reg, k = H.port_objective("reg")
    Xp, _ = pad_ground_set(reg.X, 80)
    padded = type(reg)(Xp, reg.y, k, device="cpu")
    for algo in ALGOS:
        out["edge"]["pad", algo] = select(algo, padded, k, H.JaxKey.seed(0),
                                          mesh=mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    obj, k = H.port_objective("reg")
    opt = float(greedy(obj, k, device="cpu").value) * 1.05
    ref = H.start_reference(f"""
        from repro.core import select
        mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
        out = {{}}
        for name, algo in {CASES!r}:
            obj, k = ref_objective(name)
            kw = {{"opt": {opt!r}}} if algo == "fast-pinned" else {{}}
            r = select(algo.split("-")[0], obj, k, key=jax.random.PRNGKey(0),
                       mesh=mesh, **kw)
            row = dict(sel=mask_idx(r.sel_mask), value=float(r.value),
                       count=int(r.sel_count))
            if algo.startswith("fast"):
                row.update(rounds=int(r.raw.rounds), opt=float(r.raw.opt))
            out[name + "/" + algo] = row
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
def test_twin_matches_reference(runs, name, algo):
    port, want = runs
    got, ref = port[0]["twin"][name, algo], want[f"{name}/{algo}"]
    assert H.idx(got.sel_mask) == ref["sel"]
    assert int(got.sel_count) == ref["count"]
    np.testing.assert_allclose(float(got.value), ref["value"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
    if algo.startswith("fast"):
        assert int(got.raw.rounds) == ref["rounds"]
        np.testing.assert_allclose(float(got.raw.opt), ref["opt"],
                                   rtol=H.VAL_RTOL)


@pytest.mark.parametrize("name,algo", CASES,
                         ids=[f"{n}-{a}" for n, a in CASES])
def test_twin_matches_single_device(runs, name, algo):
    port = runs[0][0]
    twin, single = port["twin"][name, algo], port["single"][name, algo]
    assert H.idx(twin.sel_mask) == H.idx(single.sel_mask)
    np.testing.assert_allclose(float(twin.value), float(single.value),
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)


@pytest.mark.parametrize("algo", ("greedy", "topk", "random", "fast"))
def test_k_above_n_saturates(runs, algo):
    res = runs[0][0]["edge"]["k>n", algo]
    n = res.sel_mask.shape[0]
    assert int(res.sel_count) == int(np.sum(res.sel_mask))
    if algo == "fast":
        assert int(res.sel_count) <= n
    else:
        assert int(res.sel_count) == n


@pytest.mark.parametrize("algo", ALGOS)
def test_padding_never_selected(runs, algo):
    res = runs[0][0]["edge"]["pad", algo]
    assert res.sel_mask.shape[0] == 80
    assert not np.any(res.sel_mask[64:])
    assert 0 < int(res.sel_count) <= 8


@pytest.mark.parametrize("algo", TIED)
def test_tied_twin_matches_single_device(runs, algo):
    """On the unit-norm design (every singleton gain tied in exact
    arithmetic) the twin at model width 2 breaks the ties as the
    single-device port does: the same set."""
    edge = runs[0][0]["edge"]
    twin, single = edge["tied", algo], edge["tied-single", algo]
    assert H.idx(twin.sel_mask) == H.idx(single.sel_mask)
    assert int(twin.sel_count) == len(H.idx(single.sel_mask))
    np.testing.assert_allclose(float(twin.value), float(single.value),
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)


def test_tied_top_k_within_tie_tolerance(runs):
    """On the unit-norm design the twin's TOP-k set is the single-device
    port's, and holds every candidate above the k-th gain by more than
    TIE_RTOL and nothing below it by more (the port's single-device
    gains)."""
    edge = runs[0][0]["edge"]
    got = set(H.idx(edge["tied", "topk"].sel_mask))
    assert got == set(H.idx(edge["tied-single", "topk"].sel_mask))
    obj, k = H.port_objective("aopt")
    g = obj.gains(obj.init())[0]
    kth = float(torch.sort(g, descending=True).values[k - 1])
    assert all(float(g[a]) >= kth * (1.0 - TIE_RTOL) for a in got)
    above = set(torch.nonzero(g > kth * (1.0 + TIE_RTOL)).flatten().tolist())
    assert above <= got and len(got) == k
