"""Architecture registry of the port: arch id → ModelConfig.

The port serves the dense, attention-only decoder LMs of the JAX
package's registry (``repro/configs/registry.py``): h2o-danube-1.8b,
smollm-135m, olmo-1b and qwen2.5-14b.  The other ids of that registry
name archs whose block kinds (MoE, RG-LRU, xLSTM, encoder-decoder,
vision) are not ported yet (ROADMAP item 14); asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import (
    h2o_danube_1p8b,
    olmo_1b,
    qwen2p5_14b,
    smollm_135m,
)
from repro_torch.configs.base import ModelConfig, reduced

_REGISTRY: dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        h2o_danube_1p8b.CONFIG,
        smollm_135m.CONFIG,
        olmo_1b.CONFIG,
        qwen2p5_14b.CONFIG,
    )
}

# Archs of the JAX package's registry that the port does not serve yet.
NOT_PORTED = {
    "llama4-maverick-400b-a17b": "MoE",
    "grok-1-314b": "MoE",
    "recurrentgemma-2b": "RG-LRU",
    "xlstm-125m": "xLSTM",
    "whisper-base": "encoder-decoder",
    "internvl2-2b": "vision",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP item 14: the "
        "port serves dense attention-only LMs only)")


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
