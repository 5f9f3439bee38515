"""The port's sharded DASH against the JAX reference on a (data 2,
model 2) mesh, for the three objectives, on the CPU.

The reference runs ``repro.core.distributed.dash_distributed`` on four
forced host devices in a subprocess; the port runs the same call on four
gloo ranks (``repro_torch.launch.mesh.spawn_ranks``), its noise drawn
through ``JaxKey``, which replays the reference's splits, folds and
Gumbel draws.  Both get the same numpy inputs and the same OPT guess
(1.05 × the port's greedy value, computed here once).

Tolerances: the reference's set, count and rounds; values within
VAL_RTOL 1e-5 (f32 sums in another order).  The engine and per-sample
filter paths of the port agree within 1e-3 · max(|greedy|, 1), the
reference's own gate for its two paths.  Every rank returns the same
bits.  Also the reference suite's edge cases (bf16 through ``select``,
OPT = 0, a padded ground set on a model-only mesh), ``select``'s
refusals and the design entry point's distributed half.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import DashConfig, SeedKey, greedy, select  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    dash_distributed,
    pad_ground_set,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402

NAMES = ("reg", "aopt", "logi")


def _opts() -> dict:
    out = {}
    for name in NAMES:
        obj, k = H.port_objective(name)
        out[name] = float(greedy(obj, k, device="cpu").value) * 1.05
    return out


def _port(opts):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name in NAMES:
        obj, k = H.port_objective(name)
        cfg = DashConfig(k=k, **H.DASH_CFG[name])
        key = H.JaxKey.seed(0)
        off, _ = H.port_objective(name, use_filter_engine=False)
        out[name] = {
            "engine": dash_distributed(obj, cfg, key, opts[name], mesh),
            "per_sample": dash_distributed(off, cfg, key, opts[name], mesh),
            "select": select("dash", obj, k, key, mesh=mesh, opt=opts[name],
                             **H.DASH_CFG[name]).raw,
        }
    # The reference suite's edge cases: bf16 streaming through select,
    # OPT = 0 (no filtering: every round commits a full block until k),
    # and a padded ground set on a model-only mesh (data_axis=None).
    obj, k = H.port_objective("reg")
    cfg = DashConfig(k=k, **H.DASH_CFG["reg"])
    key = H.JaxKey.seed(0)
    out["bf16"] = (
        select("dash", obj, k, key, mesh=mesh, precision="bf16",
               opt=opts["reg"], **H.DASH_CFG["reg"]).raw,
        dash_distributed(obj, cfg, key, opts["reg"], mesh, precision="bf16"),
        obj.precision)
    out["opt0"] = dash_distributed(obj, cfg, SeedKey(3), 0.0, mesh)
    Xp, _ = pad_ground_set(obj.X, 40)                     # 64 → 80 columns
    padded = type(obj)(Xp, obj.y, k, device="cpu")
    out["model_only"] = dash_distributed(
        padded, cfg, key, opts["reg"],
        make_mesh((4,), ("model",), device="cpu"), data_axis=None)
    # select(..., mesh=)'s refusals, raised on every rank before any
    # collective.
    errors = {}
    odd = type(obj)(torch.cat([obj.X, obj.X[:, :2]], dim=1), obj.y, k,
                    device="cpu")                       # n = 66
    for tag, call in (
            ("n", lambda: select("greedy", odd, k, mesh=make_mesh(
                (1, 4), ("data", "model"), device="cpu"))),
            ("pod", lambda: select("dash", obj, k, SeedKey(0), mesh=mesh)),
            ("lazy", lambda: select("lazy_greedy", obj, k, mesh=mesh)),
            ("adseq", lambda: select("adaptive_sequencing", obj, k,
                                     SeedKey(0), mesh=mesh))):
        try:
            call()
            errors[tag] = None
        except ValueError as e:
            errors[tag] = str(e)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def runs():
    opts = _opts()
    ref = H.start_reference(f"""
        from repro.core.distributed import dash_distributed
        mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
        out = {{}}
        for name, opt in {opts!r}.items():
            obj, k = ref_objective(name)
            cfg = DashConfig(k=k, **H.DASH_CFG[name])
            r = dash_distributed(obj, cfg, jax.random.PRNGKey(0), opt, mesh)
            out[name] = dict(sel=mask_idx(r.sel_mask), value=float(r.value),
                             count=int(r.sel_count), rounds=int(r.rounds),
                             trace=floats(r.trace.values))
        print(json.dumps(out))
    """)
    try:
        port = H.launch(_port, 4, opts)
    finally:
        want = H.finish_reference(ref)
    return port, want, opts


def test_jax_key_is_the_reference_key():
    import jax

    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(0)),
                                  H.JaxKey.seed(0).key)


def test_every_rank_returns_the_same_result(runs):
    port, _, _ = runs
    H.same_on_every_rank(port)


@pytest.mark.parametrize("name", NAMES)
def test_dash_distributed_matches_reference(runs, name):
    port, want, _ = runs
    got, ref = port[0][name]["engine"], want[name]
    assert H.idx(got.sel_mask) == ref["sel"]
    assert int(got.sel_count) == ref["count"] == len(ref["sel"])
    assert int(got.rounds) == ref["rounds"]
    np.testing.assert_allclose(float(got.value), ref["value"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)
    np.testing.assert_allclose(got.trace.values, ref["trace"],
                               rtol=H.VAL_RTOL, atol=H.VAL_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_per_sample_path(runs, name):
    port, _, opts = runs
    en, ps = port[0][name]["engine"], port[0][name]["per_sample"]
    greedy_value = opts[name] / 1.05
    assert abs(float(en.value) - float(ps.value)) <= (
        1e-3 * max(abs(greedy_value), 1.0))
    assert int(en.sel_count) <= {"reg": 8, "aopt": 8, "logi": 6}[name]


@pytest.mark.parametrize("name", NAMES)
def test_select_dispatches_to_the_twin(runs, name):
    port, _, _ = runs
    direct, via = port[0][name]["engine"], port[0][name]["select"]
    assert H._bits(via) == H._bits(direct)


def test_select_bf16_end_to_end_sharded(runs):
    """select(..., precision="bf16") runs the sharded DASH through the
    objective's bf16 view: the explicit call's bits, the parent left on
    f32, the value within the bf16 stream budget of the f32 run's."""
    from repro_torch.kernels.common import STREAM_PARITY_TOL

    port = runs[0][0]
    via, direct, parent_precision = port["bf16"]
    assert H._bits(via) == H._bits(direct)
    assert parent_precision == "f32"
    v32, v16 = float(port["reg"]["engine"].value), float(via.value)
    assert abs(v16 - v32) <= STREAM_PARITY_TOL["bf16"]["vs_f32"] * abs(v32)


def test_opt_zero_fills_to_k(runs):
    """OPT = 0: thresholds 0, no filtering; the capacity clamp stops the
    last round at exactly k."""
    res = runs[0][0]["opt0"]
    assert int(res.sel_count) == 8 == int(np.sum(res.sel_mask))


def test_padded_ground_set_on_a_model_only_mesh(runs):
    res = runs[0][0]["model_only"]
    assert res.sel_mask.shape == (80,)
    assert not np.any(res.sel_mask[64:])
    assert 1 <= int(res.sel_count) <= 8 and float(res.value) > 0.0


def test_select_mesh_errors(runs):
    errors = runs[0][0]["errors"]
    assert "does not divide the mesh's model axis" in errors["n"]
    assert "'pod' axis" in errors["pod"]
    assert errors["lazy"] == "algorithm 'lazy_greedy' has no distributed twin"
    assert errors["adseq"] == (
        "algorithm 'adaptive_sequencing' has no distributed twin")


def test_one_hot_columns_matches_reference():
    import jax.numpy as jnp

    from repro.core.objectives.base import one_hot_columns as jax_one_hot
    from repro_torch.core.objectives.base import one_hot_columns

    idx = np.array([3, 0, 3, 7], dtype=np.int64)
    mask = np.array([True, True, False, True])
    want = np.asarray(jax_one_hot(jnp.asarray(idx), jnp.asarray(mask), 9))
    got = one_hot_columns(torch.from_numpy(idx), torch.from_numpy(mask), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    X = torch.arange(18.0).reshape(2, 9)
    np.testing.assert_array_equal((X @ got).numpy(),
                                  (X[:, idx] * torch.from_numpy(mask)).numpy())


def test_experimental_design_distributed_entry_point():
    """The example's distributed half on four CPU ranks: make_host_mesh
    lays them out (data 2, model 2), and n = 125 pads to 126 with a zero
    column that is never selected."""
    from repro_torch import experimental_design

    out = experimental_design.distributed(4, device="cpu", d=32, n=125, k=8,
                                          verbose=False)
    assert out["mesh"] == {"data": 2, "model": 2}
    assert not out["padding_selected"]
    assert 0 < out["dash_selected"] <= 8
    assert 0.0 < out["dash_value"] <= out["greedy_value"] * 1.05
