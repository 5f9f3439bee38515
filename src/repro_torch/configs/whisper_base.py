"""whisper-base — encoder-decoder audio backbone; conv frontend is a STUB.

[arXiv:2212.04356; unverified]
6L decoder d_model=512 8H (kv=8) d_ff=2048 vocab=51865 + 6L encoder over
1500 (stub) frame embeddings — ``input_specs()`` provides the precomputed
frame embeddings, per the assignment's modality-stub rule.
Full attention → long_500k skipped.  Decode runs (enc-dec has a decoder).
"""

from repro_torch.configs.base import AttentionConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attn=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64),
    encoder=EncoderConfig(n_layers=6, src_len=1500, d_ff=2048),
    block_pattern=("attn",),
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    max_seq=4096,
    notes="Enc-dec; cross-attention in every decoder layer; audio "
          "frontend stubbed to precomputed frame embeddings.",
).validate()
