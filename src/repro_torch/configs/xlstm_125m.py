"""xlstm-125m — sLSTM + mLSTM blocks (xLSTM paper ~[7:1] ratio).

[arXiv:2405.04517; unverified]
12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry
their own (2×) up-projections instead of a separate MLP.
Pattern: (mlstm, mlstm, mlstm, slstm) — 9 mLSTM : 3 sLSTM over 12 layers.
Recurrent state ⇒ sub-quadratic ⇒ long_500k RUNS.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    d_ff=0,
    vocab_size=50304,
    attn=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=192),
    xlstm=XLSTMConfig(n_heads=4, head_dim=192, slstm_every=4, chunk_size=256),
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    norm="rmsnorm",
    activation="gelu",
    gated_mlp=False,
    tie_embeddings=True,
    max_seq=1 << 20,
    notes="mLSTM chunkwise-parallel training, O(1)-state decode; "
          "sLSTM sequential scan.",
).validate()
