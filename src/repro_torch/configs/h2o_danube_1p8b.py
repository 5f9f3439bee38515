"""h2o-danube-1.8b — dense, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000; SWA window 4096.
Sliding window ⇒ sub-quadratic decode ⇒ long_500k RUNS for this arch.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attn=AttentionConfig(
        n_heads=32, n_kv_heads=8, head_dim=80, rope_theta=10000.0,
        window=4096,
    ),
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    max_seq=16384,
    notes="Mistral-style sliding-window attention (window=4096).",
).validate()
