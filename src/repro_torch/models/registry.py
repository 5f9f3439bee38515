"""Model factory: ``build_model(cfg_or_arch_id)``."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model, check_supported


def build_model(cfg) -> Model:
    """The port's Model for a config or an arch id (every arch of the
    registry).  Raises ``ValueError`` for a block kind that no arch
    uses."""
    if isinstance(cfg, str):
        from repro_torch.configs.registry import get_config

        cfg = get_config(cfg)
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"expected a ModelConfig or an arch id, got "
                        f"{type(cfg).__name__}")
    check_supported(cfg)
    return Model(cfg.validate())
