"""Architecture registry of the port: arch id → ModelConfig.

The port serves the decoder LMs of the JAX package's registry
(``repro/configs/registry.py``) whose blocks are attention (full or
local), RG-LRU, dense MLPs and MoE: h2o-danube-1.8b, smollm-135m,
olmo-1b, qwen2.5-14b, grok-1-314b, llama4-maverick-400b-a17b and
recurrentgemma-2b.  The other ids of that registry name archs whose
block kinds (xLSTM, encoder-decoder, vision) are not ported yet (ROADMAP
item 14); asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import (
    grok1_314b,
    h2o_danube_1p8b,
    llama4_maverick_400b,
    olmo_1b,
    qwen2p5_14b,
    recurrentgemma_2b,
    smollm_135m,
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
    )
}

# Archs of the JAX package's registry that the port does not serve yet.
NOT_PORTED = {
    "xlstm-125m": "xLSTM",
    "whisper-base": "encoder-decoder",
    "internvl2-2b": "vision",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP item 14: the "
        "port serves attention, RG-LRU, MLP and MoE blocks only)")


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise not_ported(f"arch {arch_id!r} ({NOT_PORTED[arch_id]})")
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(list_archs())}"
        )
    return _REGISTRY[arch_id]


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)
