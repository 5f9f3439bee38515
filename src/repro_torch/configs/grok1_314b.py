"""grok-1-314b — MoE, 8 experts top-2, attention logit softcap.

[hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Full attention → long_500k skipped (DESIGN.md §6).
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    attn=AttentionConfig(
        n_heads=48, n_kv_heads=8, head_dim=128, rope_theta=10000.0,
        softcap=30.0,
    ),
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="gelu",
    gated_mlp=True,
    max_seq=8192,
    notes="8-expert top-2 MoE; 30.0 attention logit softcap.",
).validate()
