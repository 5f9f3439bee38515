"""The port's dry run at published width, on the CPU: xlstm-125m's first
runnable cell (train_4k) on the 16×16 production mesh traces on
``meta`` tensors with no error record.  (That nothing is allocated off
``meta`` is watched on the other archs' cells, grok-1's among them: the
watch would dispatch this cell's many sLSTM steps through a second
mode.)  Its layers are traced on a grid of lengths and extrapolated
to the cell's (``launch.dryrun._along``); ``tests/test_torch_dryrun.py``
holds that sum to a whole trace on the reduced config."""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dryrun_helpers as D  # noqa: E402


def test_xlstm_first_cell_traces():
    rec, host = D.first_cell("xlstm-125m", watch=False)
    D.check_record(rec, host)
    assert rec["shape"] == "train_4k"
    assert rec["kernels"] == {}          # no attention: kernel 8 unused
