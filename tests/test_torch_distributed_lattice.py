"""The port's sharded guess lattice and its partition invariance, on the
CPU, against the JAX reference.

``dash_auto_distributed`` on a (pod 2, data 1, model 2) mesh: two guesses
a pod slice as lanes, then the commit over ``pod``; the reference runs
the same call on four forced host devices.  The port must give the
reference's ``lattice_values`` (within VAL_RTOL 1e-5), ``best_guess``
and set, also over an (OPT, α) cross product.

Partition invariance: ``dash_distributed`` at model widths 1, 2 and 4
(data 1; the pod axis of the world-4 mesh carries replicas) gives
bitwise the same set, value and trace for each objective, and, under
``JaxKey``, the reference's set on its (data 1, model 4) mesh.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import DashConfig, SeedKey, greedy  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    dash_auto_distributed,
    dash_distributed,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402

AXES = ("pod", "data", "model")
WIDTHS = (1, 2, 4)
LATTICE = (("reg", 4, None), ("aopt", 4, None), ("reg", 2, (0.4, 0.7)))


def _lattice_args(name, n_guesses, alphas):
    c = H.DASH_CFG[name]
    return dict(eps=c["eps"], alpha=c["alpha"], n_samples=c["n_samples"],
                n_guesses=n_guesses, alphas=alphas)


def _port(opt):
    out = {"lattice": [], "widths": {}}
    pod = make_mesh((2, 1, 2), AXES, device="cpu")
    for name, g, alphas in LATTICE:
        obj, k = H.port_objective(name)
        out["lattice"].append(dash_auto_distributed(
            obj, k, H.JaxKey.seed(1), pod, **_lattice_args(name, g, alphas)))
    for width in WIDTHS:
        mesh = make_mesh((4 // width, 1, width), AXES, device="cpu")
        runs = {}
        for name in ("reg", "aopt", "logi"):
            obj, k = H.port_objective(name)
            cfg = DashConfig(k=k, **H.DASH_CFG[name])
            key = H.JaxKey.seed(0) if name == "reg" else SeedKey(5)
            runs[name] = dash_distributed(obj, cfg, key, opt[name], mesh)
        out["widths"][width] = runs
    return out


@pytest.fixture(scope="module")
def runs():
    opt = {}
    for name in ("reg", "aopt", "logi"):
        obj, k = H.port_objective(name)
        opt[name] = float(greedy(obj, k, device="cpu").value) * 1.05
    ref = H.start_reference(f"""
        from repro.core.distributed import (dash_auto_distributed,
                                            dash_distributed)
        pod = make_mesh((2, 1, 2), ("pod", "data", "model"),
                        devices=jax.devices()[:4])
        out = {{"lattice": []}}
        for name, g, alphas in {LATTICE!r}:
            obj, k = ref_objective(name)
            c = H.DASH_CFG[name]
            r = dash_auto_distributed(
                obj, k, jax.random.PRNGKey(1), pod, eps=c["eps"],
                alpha=c["alpha"], n_samples=c["n_samples"], n_guesses=g,
                alphas=alphas)
            out["lattice"].append(dict(
                sel=mask_idx(r.sel_mask), value=float(r.value),
                lattice=floats(r.lattice_values), best=int(r.best_guess),
                count=int(r.sel_count), rounds=int(r.rounds)))
        obj, k = ref_objective("reg")
        m4 = make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
        r = dash_distributed(obj, DashConfig(k=k, **H.DASH_CFG["reg"]),
                             jax.random.PRNGKey(0), {opt["reg"]!r}, m4)
        out["model4"] = dict(sel=mask_idx(r.sel_mask), value=float(r.value),
                             trace=floats(r.trace.values))
        print(json.dumps(out))
    """)
    try:
        port = H.launch(_port, 4, opt)
    finally:
        want = H.finish_reference(ref)
    return port, want


def test_every_rank_returns_the_same_result(runs):
    H.same_on_every_rank(runs[0])


@pytest.mark.parametrize("case", range(len(LATTICE)),
                         ids=["reg", "aopt", "reg-alphas"])
def test_lattice_matches_reference(runs, case):
    port, want = runs
    got, ref = port[0]["lattice"][case], want["lattice"][case]
    np.testing.assert_allclose(got.lattice_values, ref["lattice"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
    assert int(got.best_guess) == ref["best"]
    assert H.idx(got.sel_mask) == ref["sel"]
    assert int(got.sel_count) == ref["count"]
    assert int(got.rounds) == ref["rounds"]
    np.testing.assert_allclose(float(got.value), ref["value"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
    # the committed winner is the lattice's best value
    assert float(got.value) == float(np.max(got.lattice_values))


@pytest.mark.parametrize("name", ("reg", "aopt", "logi"))
def test_partition_invariance_bitwise(runs, name):
    widths = runs[0][0]["widths"]
    base = widths[1][name]
    assert int(base.sel_count) > 0
    for w in WIDTHS[1:]:
        assert H._bits(widths[w][name]) == H._bits(base), (name, w)


def test_model4_matches_reference(runs):
    port, want = runs
    got = port[0]["widths"][4]["reg"]
    assert H.idx(got.sel_mask) == want["model4"]["sel"]
    np.testing.assert_allclose(got.trace.values, want["model4"]["trace"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
