"""The port's dry run at published width, on the CPU: the first runnable
cell (train_4k) of grok-1-314b and whisper-base on the 16×16 production
mesh traces on ``meta`` tensors with no error record, and nothing is
allocated off the ``meta`` device: grok-1's 316 billion parameters (some
630 GB in bf16) exist as shapes alone.  recurrentgemma-2b and xlstm-125m
run in ``..._rglru.py`` and ``..._xlstm.py``; smollm-135m in
``tests/test_torch_dryrun.py``; the other archs in ``chip_smoke.py``'s
``[dryrun]``."""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dryrun_helpers as D  # noqa: E402


def test_grok1_first_cell_traces_without_host_weights():
    rec, host = D.first_cell("grok-1-314b")
    D.check_record(rec, host)
    assert rec["shape"] == "train_4k"
    # the rank's shards over the model axis: the placements' share, a
    # sixteenth of grok-1's 316 billion bf16 parameters and then some
    # (the replicated norms and router)
    assert rec["held_bytes"] == rec["placed_argument_bytes"]
    assert 316e9 * 2 / 16 < rec["held_bytes"] < 316e9 * 2 / 8
    # the MoE's data-parallel dispatch gathers each layer's expert counts
    assert rec["collectives"]["all-gather"]["count"] >= 64


def test_whisper_first_cell_traces():
    rec, host = D.first_cell("whisper-base")
    D.check_record(rec, host)
    assert {"reduce-scatter", "all-gather"} <= set(rec["collectives"])
