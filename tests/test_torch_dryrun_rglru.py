"""The port's dry run at published width, on the CPU: recurrentgemma-2b's
first runnable cell (train_4k) on the 16×16 production mesh traces on
``meta`` tensors with no error record and nothing allocated off
``meta``; with the reference CLI's RG-LRU flags (``--rglru-chunk``,
``--rglru-block-gates``) its prefill takes the chunked scan and the
block-local gates."""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dryrun_helpers as D  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.sharding import reset_flags, set_flags  # noqa: E402


def test_recurrentgemma_first_cell_traces():
    rec, host = D.first_cell("recurrentgemma-2b")
    D.check_record(rec, host)
    assert rec["shape"] == "train_4k"


def test_rglru_flags_change_the_prefill():
    plain = lower_cell("recurrentgemma-2b", "prefill_32k")
    set_flags(rglru_chunk=2048, rglru_block_gates=True)
    try:
        flagged = lower_cell("recurrentgemma-2b", "prefill_32k")
    finally:
        reset_flags()
    # block-local gates: w_a and w_i hold W²/16 entries instead of W²
    w = 2560
    per_layer = 2 * (w * w - w * w // 16) * 2        # bf16
    n_rglru = 18
    assert plain["held_bytes"] - flagged["held_bytes"] == n_rglru * per_layer
    assert flagged["cost"]["flops"] < plain["cost"]["flops"]
    # the chunked scan's live set is a chunk's, not the prompt's
    assert flagged["memory"]["peak_est_bytes"] < \
        plain["memory"]["peak_est_bytes"]
