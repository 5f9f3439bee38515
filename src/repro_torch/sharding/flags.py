"""Perf-pass flags: the port's copy of ``repro/sharding/flags.py``.

Every flag is off by default, as in the reference.  Of them the port's
model code reads ``moe_groups`` (the MoE's group-local dispatch,
``models/layers/moe.py``), ``rglru_chunk`` and ``rglru_block_gates``
(``models/layers/rglru.py``), and the placements read ``fsdp``;
``moe_2d`` and ``seq_shard`` steer the reference's layout of
activations over the model axis, which the port does not shard
(``launch/dryrun.py`` refuses them): they are carried so that a
configuration that names them means the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class PerfFlags:
    fsdp: bool = False          # shard params over the data axis too
    moe_2d: bool = False        # (E, C, D) buffer: C over data, f over model
    moe_groups: int = 0         # group-local dispatch: one sort per group
                                # of rows; 0 = one global dispatch
    rglru_chunk: int = 0        # chunked associative scan (0 = whole)
    rglru_block_gates: bool = False  # block-local (W/16)² gate matrices
    seq_shard: bool = False     # sequence-parallel block boundaries


_FLAGS = PerfFlags()


def get_flags() -> PerfFlags:
    return _FLAGS


def set_flags(**kw) -> PerfFlags:
    global _FLAGS
    _FLAGS = replace(_FLAGS, **kw)
    return _FLAGS


def reset_flags() -> None:
    global _FLAGS
    _FLAGS = PerfFlags()
