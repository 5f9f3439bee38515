"""Architecture registry of the port: arch id → ModelConfig.

The port serves every arch of the JAX package's registry
(``repro/configs/registry.py``): the dense decoders h2o-danube-1.8b,
smollm-135m, olmo-1b and qwen2.5-14b, the MoE archs grok-1-314b and
llama4-maverick-400b-a17b, the RG-LRU hybrid recurrentgemma-2b, the
xLSTM stack xlstm-125m, the encoder-decoder whisper-base and the VLM
internvl2-2b (its image-token prefix).  ``runnable_cells()`` enumerates
the (arch × shape) grid of the dry run with the reference's documented
long_500k skips (``cell_skip_reason``).
"""

from __future__ import annotations

from repro_torch.configs import (
    grok1_314b,
    h2o_danube_1p8b,
    internvl2_2b,
    llama4_maverick_400b,
    olmo_1b,
    qwen2p5_14b,
    recurrentgemma_2b,
    smollm_135m,
    whisper_base,
    xlstm_125m,
)
from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    reduced,
)

_REGISTRY: dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        llama4_maverick_400b.CONFIG,
        grok1_314b.CONFIG,
        h2o_danube_1p8b.CONFIG,
        smollm_135m.CONFIG,
        olmo_1b.CONFIG,
        qwen2p5_14b.CONFIG,
        recurrentgemma_2b.CONFIG,
        whisper_base.CONFIG,
        xlstm_125m.CONFIG,
        internvl2_2b.CONFIG,
    )
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(list_archs())}"
        )
    return _REGISTRY[arch_id]


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """None if the (arch × shape) cell runs; otherwise the documented skip
    (the reference's text)."""
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (DESIGN.md §6)"
        )
    return None


def runnable_cells() -> list[tuple[str, str]]:
    """(arch, shape name) of every cell that runs, archs sorted, shapes in
    ``ALL_SHAPES`` order."""
    return [(arch, shape.name) for arch in list_archs()
            for shape in ALL_SHAPES
            if cell_skip_reason(get_config(arch), shape) is None]


def skipped_cells() -> list[tuple[str, str, str]]:
    """(arch, shape name, reason) of every skipped cell."""
    out = []
    for arch in list_archs():
        for shape in ALL_SHAPES:
            reason = cell_skip_reason(get_config(arch), shape)
            if reason:
                out.append((arch, shape.name, reason))
    return out


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]
