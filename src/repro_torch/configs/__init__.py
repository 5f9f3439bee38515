"""Model configurations of the port (copies of the JAX package's)."""

from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    ShapeConfig,
    reduced,
)
from repro_torch.configs.registry import (
    cell_skip_reason,
    get_config,
    get_reduced_config,
    get_shape,
    list_archs,
    runnable_cells,
    skipped_cells,
)

__all__ = [
    "AttentionConfig",
    "ModelConfig",
    "ShapeConfig",
    "cell_skip_reason",
    "get_config",
    "get_reduced_config",
    "get_shape",
    "list_archs",
    "reduced",
    "runnable_cells",
    "skipped_cells",
]
