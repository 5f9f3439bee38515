"""qwen2.5-14b — dense, GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B (family); hf]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064; QKV bias.
Full attention → long_500k skipped.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab_size=152064,
    attn=AttentionConfig(
        n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=1000000.0,
        qkv_bias=True,
    ),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    max_seq=32768,
).validate()
