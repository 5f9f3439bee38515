"""internvl2-2b — VLM: InternViT frontend (STUB) + InternLM2 backbone.

[arXiv:2404.16821; hf]
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
``input_specs()`` provides precomputed patch embeddings (256 image tokens,
already projected to d_model) which are prepended to the text embeddings.
Full attention → long_500k skipped.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    attn=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=128),
    vision=VisionConfig(n_img_tokens=256, embed_dim=2048),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    max_seq=8192,
    notes="InternViT patch embeddings stubbed; backbone = InternLM2-1.8B.",
).validate()
