"""Shared pieces of the port's dry-run files at published width
(``tests/test_torch_dryrun_archs.py``, ``..._rglru.py``,
``..._xlstm.py``): the first runnable cell of an arch traced on the
16×16 production mesh, and a check that nothing was allocated off the
``meta`` device meanwhile."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import runnable_cells
from repro_torch.launch.dryrun import lower_cell


class HostBytes(TorchDispatchMode):
    """The bytes of every tensor an operation outputs off the ``meta``
    device (a weight drawn on the host would show here)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.bytes += t.numel() * t.element_size()
        return out


def first_cell(arch: str, watch: bool = True) -> tuple:
    """(the record of the arch's first runnable cell at 16×16, the bytes
    allocated off ``meta`` while it was traced, or 0 unless ``watch``:
    the watch dispatches every operation through a second mode)."""
    shape = next(s for a, s in runnable_cells() if a == arch)
    if not watch:
        return lower_cell(arch, shape), 0
    with HostBytes() as hb:
        rec = lower_cell(arch, shape)
    return rec, hb.bytes


def check_record(rec: dict, host_bytes: int) -> None:
    assert "error" not in rec and "skipped" not in rec, rec
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["held_bytes"] > 0 and rec["placed_argument_bytes"] > 0
    m = rec["memory"]
    assert m["peak_est_bytes"] >= m["argument_bytes"] == rec["held_bytes"]
    # nothing but scalars off the meta device
    assert host_bytes < 1 << 16, host_bytes
