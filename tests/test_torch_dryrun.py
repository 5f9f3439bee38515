"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

The reference lowers and compiles smollm-135m's ``decode_32k`` and
``train_4k`` cells on the 16×16 and 2×16×16 production meshes in one
subprocess with 512 forced host devices, as
``tests/test_distributed.py::test_dryrun_single_cell_both_meshes``.
The port's record of each cell must carry every key of the reference's,
and its ``placed_argument_bytes`` (one device's bytes under the
reference's placements) must equal XLA's ``argument_size_in_bytes``
exactly.  The registry's runnable and skipped cells equal the
reference's.  The port's traces of a cell sum traces of the model at
two and three super-blocks (``trace_cell``); on reduced configs they
equal a trace of the whole model exactly (FLOPs, bytes, collectives,
kernel launches, the peak of live bytes).  The five archs' first cells at published width run
in ``tests/test_torch_dryrun_archs.py`` and ``..._xlstm.py``.
"""

import json
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402

CELLS = [("decode_32k", False), ("decode_32k", True), ("train_4k", False),
         ("train_4k", True)]
# the reference's argument bytes at 16x16, as measured with XLA
EXPECTED_16x16 = {"decode_32k": 396_333_792, "train_4k": 23_472_500}

REF_BODY = """
from repro.configs.registry import runnable_cells, skipped_cells
from repro.launch.dryrun import lower_cell
recs = {}
for shape, mp in %r:
    r = lower_cell("smollm-135m", shape, multi_pod=mp)
    recs[f"{shape}/{mp}"] = {
        "keys": sorted(r), "memory": sorted(r["memory"]),
        "cost": sorted(r["cost"]), "cost_raw": sorted(r["cost_raw"]),
        "argument_bytes": r["memory"]["argument_bytes"],
        "n_chips": r["n_chips"]}
print(json.dumps({"recs": recs, "runnable": runnable_cells(),
                  "skipped": skipped_cells()}))
""" % (CELLS,)


@pytest.fixture(scope="module")
def records():
    proc = H.start_reference(REF_BODY, devices=512)
    try:
        mine = {f"{s}/{mp}": dryrun.lower_cell("smollm-135m", s,
                                               multi_pod=mp)
                for s, mp in CELLS}
    finally:
        ref = H.finish_reference(proc)
    return mine, ref


@pytest.mark.parametrize("shape,mp", CELLS)
def test_placed_argument_bytes_equal_the_reference(records, shape, mp):
    mine, ref = records
    key = f"{shape}/{mp}"
    want = ref["recs"][key]["argument_bytes"]
    assert mine[key]["placed_argument_bytes"] == want
    if not mp:
        assert want == EXPECTED_16x16[shape]


@pytest.mark.parametrize("shape,mp", CELLS)
def test_records_carry_the_reference_keys(records, shape, mp):
    mine, ref = records
    key = f"{shape}/{mp}"
    got, want = mine[key], ref["recs"][key]
    assert set(want["keys"]) <= set(got)
    for sub in ("memory", "cost", "cost_raw"):
        assert sorted(got[sub]) == want[sub]
    assert got["n_chips"] == want["n_chips"]
    assert "error" not in got and got["cost"]["flops"] > 0
    assert got["memory"]["peak_est_bytes"] >= got["held_bytes"]
    if shape == "train_4k":
        # the ZeRO-1 step: gradients reduce-scattered, parameters
        # all-gathered, the first call's checksums broadcast
        assert {"reduce-scatter", "all-gather", "broadcast",
                "all-reduce"} <= set(got["collectives"])
        assert any("compared nothing" in n for n in got["notes"])
    else:
        # decode steps use plain attention; the cache is written in place
        assert got["kernels"] == {}
        assert got["memory"]["alias_bytes"] > 0


def test_runnable_and_skipped_cells_equal_the_reference(records):
    from repro_torch.configs import runnable_cells, skipped_cells

    _, ref = records
    assert [list(c) for c in runnable_cells()] == ref["runnable"]
    assert [list(c) for c in skipped_cells()] == ref["skipped"]
    assert len(runnable_cells()) == 33


def _whole(cfg, shape, mesh):
    """A trace of the whole model's work at ``shape`` (no sum of parts):
    the loss and gradients of a train cell, a prefill, a decode step."""
    import contextlib

    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.sharding import batch_axes_for_mesh, batch_partition_specs
    from repro_torch.train.step import init_train_state, make_train_step

    axes = batch_axes_for_mesh(mesh)
    model = build_model(cfg)
    batch = model.input_specs(shape)
    batch.pop("cache", None)
    local = dryrun._rows(batch, batch_partition_specs(batch, mesh, axes),
                         mesh)
    if shape.kind == "train":
        acc = make_train_step(model, TrainConfig()).accumulate
        state = init_train_state(model, MetaGenerator(), TrainConfig())
        args = (state.params, local)

        def run(m):
            with dryrun.activation_sharding_ctx(axes, mesh=m):
                return acc(state, local)
        return dryrun._model_trace(mesh, args, run)
    params = model.param_specs()
    if shape.kind == "prefill":
        args = (params, local)
        call = lambda: model.prefill(params, local)
    else:
        cache = model.init_cache(local["tokens"].shape[0], shape.seq_len,
                                 device=torch.device("meta"))
        args = (params, cache, local)
        call = lambda: model.decode_step(params, cache, local["tokens"],
                                         local["pos"])

    def run(m):
        with contextlib.ExitStack() as st:
            st.enter_context(dryrun.activation_sharding_ctx(axes, mesh=m))
            st.enter_context(torch.no_grad())
            return call()
    return dryrun._model_trace(mesh, args, run)


@pytest.mark.parametrize("arch,kind,seq", [
    ("smollm-135m", "train", 64), ("grok-1-314b", "train", 32),
    ("whisper-base", "prefill", 40), ("recurrentgemma-2b", "prefill", 48),
    ("xlstm-125m", "train", 128), ("xlstm-125m", "prefill", 128),
    ("smollm-135m", "decode", 64), ("whisper-base", "decode", 40),
    ("whisper-base", "train", 40)])
def test_sum_of_depth_traces_equals_the_whole_trace(arch, kind, seq):
    """Identical layers dispatch identical operations: the weighted sum
    of the traces at two and three super-blocks (and encoder layers;
    for the recurrent-only xlstm, each at two lengths) equals the trace
    of the whole model, four of each, exactly, and so does the peak of
    live bytes above the arguments: a layer's short-lived bytes count
    once, what it leaves live once a layer."""
    cfg = get_reduced_config(arch)
    cfg = get_reduced_config(arch, n_layers=4 * len(cfg.block_pattern))
    if cfg.encoder is not None:
        cfg = replace(cfg, encoder=replace(cfg.encoder, n_layers=4))
    shape = ShapeConfig("t", seq, 4, kind)
    mesh = ShapeMesh((2, 1), ("data", "model"))
    from repro_torch.configs.base import TrainConfig

    parts = dryrun._model_phase(cfg, shape, mesh, ("data",), TrainConfig(),
                                True)
    if arch == "xlstm-125m":
        # the length path: traced on the grid of 16-token chunks from 32
        # until every figure grows linearly, then extrapolated
        assert "extrapolated to S 128" in parts["notes"][0]
    whole = _whole(cfg, shape, mesh)
    for k in ("flops", "bytes", "dot_bytes", "collectives", "kernels",
              "temp"):
        assert parts[k] == whole[k], k


def test_cli_writes_records_and_skips_cached(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "smollm-135m", "--shape", "decode_32k", "--out",
            str(out)]
    dryrun.main(argv)
    dryrun.main(argv + ["--both-meshes"])
    text = capsys.readouterr().out
    assert "[ OK ] smollm-135m × decode_32k (16x16)" in text
    assert "[CACHED] smollm-135m × decode_32k (16x16)" in text
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert recs[0]["placed_argument_bytes"] == EXPECTED_16x16["decode_32k"]
    dryrun.main(["--arch", "grok-1-314b", "--shape", "long_500k", "--out",
                 str(out)])
    assert "[SKIP] grok-1-314b × long_500k" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--moe2d", "--seq-shard"])
def test_cli_refuses_the_model_axis_layouts(flag, tmp_path):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "grok-1-314b", "--shape", "train_4k", flag,
                     "--out", str(tmp_path / "d.json")])


def test_fsdp_changes_only_the_placed_bytes():
    from repro_torch.sharding import reset_flags, set_flags

    plain = dryrun.lower_cell("smollm-135m", "decode_32k")
    set_flags(fsdp=True)
    try:
        fsdp = dryrun.lower_cell("smollm-135m", "decode_32k")
    finally:
        reset_flags()
    assert fsdp["placed_argument_bytes"] < plain["placed_argument_bytes"]
    for k in ("held_bytes", "memory", "cost", "collectives"):
        assert fsdp[k] == plain[k], k
    assert any("does not shard parameters" in n for n in fsdp["notes"])


def test_prefill_takes_kernel_8s_meta_route():
    r = dryrun.lower_cell("smollm-135m", "prefill_32k")
    k = r["kernels"]["flash_attention"]
    assert k["launches"] == 30 and k["flops"] > 0
    assert r["rows_per_rank"] == 2
