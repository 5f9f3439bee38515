"""Mesh placements of parameters, caches and batches, the perf flags,
and the batch-axes context that makes the model code data-parallel."""

from repro_torch.sharding.cache_specs import (
    Zero1Part,
    batch_dim_spec,
    batch_partition_specs,
    cache_partition_specs,
    zero1_layout,
    zero1_specs,
)
from repro_torch.sharding.flags import (
    PerfFlags,
    get_flags,
    reset_flags,
    set_flags,
)
from repro_torch.sharding.partitioning import (
    activation_sharding_ctx,
    batch_axes_for_mesh,
    batch_group,
    param_partition_specs,
)

__all__ = [
    "PerfFlags",
    "Zero1Part",
    "activation_sharding_ctx",
    "batch_axes_for_mesh",
    "batch_dim_spec",
    "batch_group",
    "batch_partition_specs",
    "cache_partition_specs",
    "get_flags",
    "param_partition_specs",
    "reset_flags",
    "set_flags",
    "zero1_layout",
    "zero1_specs",
]
