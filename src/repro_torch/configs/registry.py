"""Architecture registry of the port: arch id → ModelConfig.

The port serves every arch of the JAX package's registry
(``repro/configs/registry.py``): the dense decoders h2o-danube-1.8b,
smollm-135m, olmo-1b and qwen2.5-14b, the MoE archs grok-1-314b and
llama4-maverick-400b-a17b, the RG-LRU hybrid recurrentgemma-2b, the
xLSTM stack xlstm-125m, the encoder-decoder whisper-base and the VLM
internvl2-2b (its image-token prefix).
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
from repro_torch.configs.base import ModelConfig, reduced

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
