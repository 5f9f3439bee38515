"""recurrentgemma-2b — hybrid: RG-LRU recurrence + local attention, 1:2.

[arXiv:2402.19427; hf]
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Pattern: (rglru, rglru, local_attn) repeating — expressed as a period-13
tuple so 26 layers = 2 periods (the real model's trailing layers are also
recurrent).  Bounded window + recurrent state ⇒ long_500k RUNS.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, RecurrentConfig

_PATTERN = (
    "rglru", "rglru", "local_attn",
    "rglru", "rglru", "local_attn",
    "rglru", "rglru", "local_attn",
    "rglru", "rglru", "local_attn",
    "rglru",
)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab_size=256000,
    attn=AttentionConfig(
        n_heads=10, n_kv_heads=1, head_dim=256, window=2048,
    ),
    recurrent=RecurrentConfig(width=2560, conv_width=4, c_exponent=8.0),
    block_pattern=_PATTERN,
    norm="rmsnorm",
    activation="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    max_seq=1 << 20,
    notes="RG-LRU associative-scan recurrence; local attention window 2048.",
).validate()
