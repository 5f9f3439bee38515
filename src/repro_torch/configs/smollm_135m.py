"""smollm-135m — dense llama-arch small model.

[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Full attention → long_500k skipped.  9 heads do not divide the 16-wide
model axis: the sharding policy (DESIGN.md §5) shards attention weights on
d_model instead — no head padding, no fake FLOPs.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    d_ff=1536,
    vocab_size=49152,
    attn=AttentionConfig(n_heads=9, n_kv_heads=3, head_dim=64),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    max_seq=2048,
).validate()
