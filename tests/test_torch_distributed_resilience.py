"""The port's round-stepped sharded runtime on the CPU: stragglers
against the JAX reference, snapshots, elastic resumes and the elastic
mesh, on four gloo ranks.

* Stragglers: ``dash_distributed`` with ``ResilienceConfig(drop_rate=
  0.4)`` on a (data 2, model 2) mesh gives the reference's set (values
  within VAL_RTOL 1e-5; ``JaxKey`` noise, the reference's arrival masks
  bit for bit).
* Elastic resume: a run killed at round 2 on (data 1, model 4) and
  resumed on (pod 2, data 1, model 2) — the snapshot's column-sharded
  leaves gathered to (n,) by the writer, sliced again on restore — gives
  the uninterrupted run's set, value and trace bit for bit; so does
  ``dash_distributed_restartable`` whose mesh provider shrinks the model
  axis at the restart, the straggler run resumed, the lattice resumed at
  model width 1 on two of the four ranks (the others outside the mesh),
  and a resume onto the survivors' ``elastic_mesh``.  A resume onto
  another data-axis size raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DashConfig,
    ResilienceConfig,
    SeedKey,
    greedy,
)
from repro_torch.core.distributed import (  # noqa: E402
    dash_auto_distributed,
    dash_distributed,
    dash_distributed_restartable,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.runtime.elastic import (  # noqa: E402
    elastic_mesh,
    gather_tree,
    reshard_tree,
)
from repro_torch.runtime.fault_tolerance import FailureInjector  # noqa: E402

AXES = ("pod", "data", "model")
DROP = dict(drop_rate=0.4, straggler_seed=3)


def _killed(call, ckpt_dir, fail_at, **kw):
    """Run ``call`` with snapshots every round until the injected kill."""
    res = ResilienceConfig(ckpt_dir=ckpt_dir, every=1, **kw)
    try:
        call(resilience=res, failure_injector=FailureInjector(
            fail_at=(fail_at,)))
    except RuntimeError as e:
        assert "injected failure" in str(e)
        return res
    raise AssertionError("the injected failure did not fire")


def _port(opt, root):
    out = {}
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    for name in ("reg", "aopt"):
        obj, k = H.port_objective(name)
        cfg = DashConfig(k=k, **H.DASH_CFG[name])
        out["straggler", name] = dash_distributed(
            obj, cfg, H.JaxKey.seed(0), opt[name], m22,
            resilience=ResilienceConfig(**DROP))

    obj, k = H.port_objective("reg")
    cfg = DashConfig(k=k, **H.DASH_CFG["reg"])
    key, o = SeedKey(3), opt["reg"]
    m4 = make_mesh((1, 1, 4), AXES, device="cpu")
    m2 = make_mesh((2, 1, 2), AXES, device="cpu")

    def run(mesh, **kw):
        return dash_distributed(obj, cfg, key, o, mesh, **kw)

    out["fused"] = run(m4)
    out["stepped"] = run(m4, resilience=ResilienceConfig())
    _killed(lambda **kw: run(m4, **kw), f"{root}/elastic", 2)
    out["resumed"] = run(m2, resume=f"{root}/elastic")
    try:
        run(make_mesh((1, 2, 2), AXES, device="cpu"),
            resume=f"{root}/elastic")
        out["data_mismatch"] = None
    except ValueError as e:
        out["data_mismatch"] = str(e)

    meshes = iter([m4, m2, m2])
    out["restartable"] = dash_distributed_restartable(
        obj, cfg, key, o, resilience=ResilienceConfig(
            ckpt_dir=f"{root}/restartable", every=1),
        mesh_provider=lambda: next(meshes),
        failure_injector=FailureInjector(fail_at=(3,)))

    out["straggler_fused"] = run(m4, resilience=ResilienceConfig(**DROP))
    res = _killed(lambda **kw: run(m4, **kw), f"{root}/straggler", 2, **DROP)
    out["straggler_resumed"] = run(m2, resilience=ResilienceConfig(**DROP),
                                   resume=res.ckpt_dir)

    # The lattice, killed on (pod 2, model 2), resumed at model width 1
    # on ranks 0 and 1; ranks 2 and 3 are outside that mesh.
    def lattice(mesh, **kw):
        return dash_auto_distributed(obj, k, key, mesh, n_guesses=4,
                                     **H.DASH_CFG["reg"], **kw)

    out["lattice"] = lattice(m2)
    _killed(lambda **kw: lattice(m2, **kw), f"{root}/lattice", 3)
    small = make_mesh((2, 1, 1), AXES, ranks=[0, 1], device="cpu")
    out["lattice_resumed"] = (lattice(small, resume=f"{root}/lattice")
                              if small.member else None)

    # The survivors {0, 1, 3}: the elastic mesh is (data 1, model 2) on
    # ranks 0 and 1, and the model-4 snapshot resumes there.
    survivors = elastic_mesh([0, 1, 3], model_axis=4, device="cpu")
    out["elastic_shape"] = (dict(survivors.shape), survivors.ranks)
    out["elastic_resumed"] = (run(survivors, resume=f"{root}/elastic")
                              if survivors.member else None)
    full = elastic_mesh(model_axis=4, device="cpu")
    out["elastic_full"] = (dict(full.shape), full.ranks)

    # reshard_tree / gather_tree round trip on a (data 2, model 2) mesh.
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "s": np.arange(6, dtype=np.uint64) * (1 << 62)}
    specs = {"w": ("data", "model"), "s": ("model",)}
    local = reshard_tree(tree, specs, m22)
    back = gather_tree(local, specs, m22)
    out["roundtrip"] = (local["w"], bool(torch.equal(back["w"], tree["w"])),
                        bool(np.array_equal(back["s"], tree["s"])))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    opt = {}
    for name in ("reg", "aopt"):
        obj, k = H.port_objective(name)
        opt[name] = float(greedy(obj, k, device="cpu").value) * 1.05
    ref = H.start_reference(f"""
        from repro.core.distributed import dash_distributed
        from repro.core.selection_loop import ResilienceConfig
        mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
        out = {{}}
        for name, opt in {opt!r}.items():
            obj, k = ref_objective(name)
            cfg = DashConfig(k=k, **H.DASH_CFG[name])
            r = dash_distributed(obj, cfg, jax.random.PRNGKey(0), opt, mesh,
                                 resilience=ResilienceConfig(**{DROP!r}))
            out[name] = dict(sel=mask_idx(r.sel_mask), value=float(r.value),
                             trace=floats(r.trace.values),
                             rounds=int(r.rounds))
        print(json.dumps(out))
    """)
    root = str(tmp_path_factory.mktemp("sharded_ckpt"))
    try:
        port = H.launch(_port, 4, opt, root)
    finally:
        want = H.finish_reference(ref)
    return port, want


@pytest.mark.parametrize("name", ("reg", "aopt"))
def test_stragglers_match_reference(runs, name):
    port, want = runs
    got, ref = port[0]["straggler", name], want[name]
    assert H.idx(got.sel_mask) == ref["sel"]
    assert int(got.rounds) == ref["rounds"]
    np.testing.assert_allclose(float(got.value), ref["value"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
    np.testing.assert_allclose(got.trace.values, ref["trace"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)


@pytest.mark.parametrize("run", ("stepped", "resumed", "restartable"))
def test_resumed_at_model_2_is_the_uninterrupted_run(runs, run):
    out = runs[0][0]
    assert int(out["fused"].sel_count) > 0
    assert H._bits(out[run]) == H._bits(out["fused"])


def test_straggler_run_resumes_bitwise(runs):
    out = runs[0][0]
    assert H._bits(out["straggler_resumed"]) == H._bits(
        out["straggler_fused"])


def test_lattice_resumes_at_model_1_on_a_sub_mesh(runs):
    port = runs[0]
    for rank in (0, 1):
        assert H._bits(port[rank]["lattice_resumed"]) == H._bits(
            port[rank]["lattice"])
    assert port[2]["lattice_resumed"] is None
    assert port[3]["lattice_resumed"] is None


def test_elastic_mesh_and_resume(runs):
    port = runs[0]
    assert port[0]["elastic_shape"] == ({"data": 1, "model": 2}, (0, 1))
    assert port[0]["elastic_full"] == ({"data": 1, "model": 4},
                                       (0, 1, 2, 3))
    for rank in (0, 1):
        assert H._bits(port[rank]["elastic_resumed"]) == H._bits(
            port[rank]["fused"])
    assert port[3]["elastic_resumed"] is None


def test_resume_onto_another_data_axis_raises(runs):
    msg = runs[0][0]["data_mismatch"]
    assert msg is not None and "data_axis_size=1" in msg


def test_reshard_and_gather_round_trip(runs):
    port = runs[0]
    full = np.arange(64.0).reshape(8, 8)
    for rank in range(4):
        local, w_ok, s_ok = port[rank]["roundtrip"]
        r, c = divmod(rank, 2)
        np.testing.assert_array_equal(local, full[4 * r:4 * r + 4,
                                                  4 * c:4 * c + 4])
        assert w_ok and s_ok
