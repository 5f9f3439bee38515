"""olmo-1b — dense, non-parametric LayerNorm (no affine params).

[arXiv:2402.00838; hf]
16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=8192 vocab=50304.
Full attention → long_500k skipped.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),
    block_pattern=("attn",),
    norm="nonparametric",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    max_seq=2048,
    notes="Non-parametric LN: normalization without learned scale/bias.",
).validate()
