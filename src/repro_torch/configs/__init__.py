"""Model configurations of the port (copies of the JAX package's)."""

from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    ShapeConfig,
    reduced,
)
from repro_torch.configs.registry import (
    get_config,
    get_reduced_config,
    list_archs,
)

__all__ = [
    "AttentionConfig",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_reduced_config",
    "list_archs",
    "reduced",
]
