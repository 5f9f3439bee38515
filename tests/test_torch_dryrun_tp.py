"""The port's dry run under tensor parallelism, on the CPU.

Where the port's tensor parallelism covers the arch (the seven
attention archs), one rank of a production-mesh cell holds its shards of
the parameters, of the ZeRO-1 optimizer state and of the decode cache
by the placements' ``model`` entries: its ``held_bytes`` equal the
placements' ``placed_argument_bytes`` (without ``--fsdp``) in every
runnable cell at 16×16 and 2×16×16 (``launch.dryrun.cell_arguments``,
the arguments without the trace).  ``NOTE_NO_TP`` stands on exactly the
three archs it does not cover.  And the sum of the traces of cut models
(``_model_phase``) equals a trace of the whole reduced model at mesh
(data 1, model 2) under tensor parallelism, the peak of live bytes and
the collectives over ``model`` included."""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_tp_helpers as P  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_config,
    get_shape,
    runnable_cells,
)
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh  # noqa: E402

SEVEN = ["grok-1-314b", "h2o-danube-1.8b", "internvl2-2b",
         "llama4-maverick-400b-a17b", "olmo-1b", "qwen2.5-14b",
         "smollm-135m"]
WHOLE = {"recurrentgemma-2b": "the RG-LRU width",
         "whisper-base": "the encoder and the cross-attention",
         "xlstm-125m": "the xLSTM inner dimension"}
CELLS = [(a, s, mp) for a, s in runnable_cells() for mp in (False, True)]


def _args(arch, shape, mp):
    return dryrun.cell_arguments(get_config(arch), get_shape(shape),
                                 make_production_mesh(multi_pod=mp),
                                 TrainConfig())


def test_the_seven_and_the_three_make_up_the_registry():
    assert sorted(SEVEN + list(WHOLE)) == sorted({a for a, _ in
                                                   runnable_cells()})


@pytest.mark.parametrize("arch", SEVEN)
def test_held_bytes_equal_the_placed_bytes(arch):
    for a, shape, mp in CELLS:
        if a != arch:
            continue
        got = _args(arch, shape, mp)
        assert got["held"] == got["placed"], (shape, mp, got["held"],
                                              got["placed"])
        assert not any("does not cover" in n for n in got["notes"])


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_no_tp_note_names_what_stays_whole(arch):
    notes = _args(arch, next(s for a, s in runnable_cells() if a == arch),
                  False)["notes"]
    assert dryrun.NOTE_NO_TP.format(WHOLE[arch]) in notes


def _whole(cfg, shape, mesh):
    """A trace of the whole model's work at ``shape`` on the rank's
    shards under the tensor-parallel context (no sum of parts)."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.sharding import batch_axes_for_mesh, batch_partition_specs
    from repro_torch.sharding.tensor_parallel import shard_params
    from repro_torch.train.step import (
        init_train_state,
        make_train_step,
        tp_param_specs,
    )

    axes = batch_axes_for_mesh(mesh)
    model = build_model(cfg)
    batch = model.input_specs(shape)
    batch.pop("cache", None)
    local = dryrun._rows(batch, batch_partition_specs(batch, mesh, axes),
                         mesh)
    cut = lambda t: shard_params(t, tp_param_specs(model, mesh), mesh)
    if shape.kind == "train":
        acc = make_train_step(model, TrainConfig()).accumulate
        state = init_train_state(model, MetaGenerator(), TrainConfig())
        state = state._replace(params=cut(state.params))

        def run(m):
            with dryrun._ctx(m, axes, True):
                return acc(state, local)
        return dryrun._model_trace(mesh, (state.params, local), run)
    params = cut(model.param_specs())
    if shape.kind == "prefill":
        args = (params, local)
        call = lambda: model.prefill(params, local)
    else:
        with dryrun._ctx(mesh, axes, True):
            cache = model.init_cache(local["tokens"].shape[0],
                                     shape.seq_len,
                                     device=torch.device("meta"))
        args = (params, cache, local)
        call = lambda: model.decode_step(params, cache, local["tokens"],
                                         local["pos"])

    def run(m):
        return dryrun._serve(m, axes, True, True, call)
    return dryrun._model_trace(mesh, args, run)


@pytest.mark.parametrize("name,kind,seq", [
    ("smollm", "train", 64), ("llama4", "train", 32),
    ("danube", "prefill", 48), ("smollm", "decode", 64),
    ("danube_slots", "decode", 40), ("grok_dff", "train", 32)])
def test_sum_of_depth_traces_equals_the_whole_trace_under_tp(name, kind,
                                                             seq):
    """``tests/test_torch_dryrun.py``'s check of the cut-model sums, at
    mesh (data 1, model 2) on the reduced configs of
    ``tests/torch_tp_helpers.py``, four super-blocks deep."""
    cfg = P.port_config(name)
    cfg = replace(cfg, n_layers=4 * len(cfg.block_pattern), remat=True)
    shape = ShapeConfig("t", seq, 4, kind)
    mesh = ShapeMesh((1, 2), ("data", "model"))
    parts = dryrun._model_phase(cfg, shape, mesh, ("data",), TrainConfig(),
                                True)
    whole = _whole(cfg, shape, mesh)
    assert whole["collectives"], "no collective over model"
    for k in ("flops", "bytes", "dot_bytes", "collectives", "kernels",
              "temp"):
        assert parts[k] == whole[k], k
