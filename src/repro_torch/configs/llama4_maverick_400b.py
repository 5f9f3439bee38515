"""llama4-maverick-400b-a17b — MoE, 128 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Text backbone only (early-fusion modality frontends are out of assigned
scope).  Full attention → long_500k skipped (DESIGN.md §6).
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attn=AttentionConfig(
        n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=500000.0
    ),
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    max_seq=32768,
    notes="MoE top-1; active params ≈17B/token of ≈400B total.",
).validate()
