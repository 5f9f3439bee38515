"""Architecture + shape + run configuration dataclasses.

The port's own copy of ``repro/configs/base.py`` (that module imports no
JAX, but the port imports nothing of the JAX package).  Every
architecture the port serves is a ``ModelConfig`` in its own module under
``repro_torch/configs/`` and is registered by id in
``repro_torch.configs.registry``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0            # 0 = full attention; >0 = sliding window
    qkv_bias: bool = False
    causal: bool = True
    softcap: float = 0.0       # logit soft-capping (grok-style); 0 = off


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    gated: bool = True         # gated (SwiGLU-style) expert MLPs


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (recurrentgemma) temporal-mixing block."""
    width: int                 # RNN state width (d_rnn)
    conv_width: int = 4
    c_exponent: float = 8.0    # a_t = a^{c·r_t}


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int
    head_dim: int
    slstm_every: int = 4       # every slstm_every-th block is an sLSTM
    chunk_size: int = 256      # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper).  The audio conv
    frontend is a STUB: input_specs provide precomputed frame embeddings."""
    n_layers: int
    src_len: int               # number of (precomputed) frames
    d_ff: int


@dataclass(frozen=True)
class VisionConfig:
    """VLM frontend STUB: input_specs provide precomputed patch embeddings."""
    n_img_tokens: int
    embed_dim: int             # dimension of the (stub) patch embeddings


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int                  # 0 for xlstm (blocks carry their own proj)
    vocab_size: int
    attn: AttentionConfig
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # Per-layer temporal-mixing pattern, cycled over layers.  Tokens:
    #   "attn" | "local_attn" | "rglru" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"      # rmsnorm | layernorm | nonparametric
    activation: str = "silu"   # silu (gated) | gelu (plain MLP)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    max_seq: int = 8192
    rope_scaling: float = 1.0
    dtype: str = "bfloat16"    # activation/compute dtype
    param_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512
    remat: bool = True         # checkpoint each layer in train_step
    notes: str = ""

    # ---- derived -------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def subquadratic(self) -> bool:
        """True iff every temporal-mixing block is O(seq) at decode time
        (bounded window or recurrent state) — the long_500k gate."""
        for b in self.block_pattern:
            if b == "attn" and self.attn.window == 0:
                return False
            if b == "local_attn" and self.attn.window == 0:
                return False
        return True

    def validate(self):
        assert self.n_layers % self.pattern_period == 0, (
            f"{self.name}: n_layers {self.n_layers} must be a multiple of "
            f"the block pattern period {self.pattern_period}"
        )
        assert self.attn.n_heads % self.attn.n_kv_heads == 0
        return self


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "long_decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1      # gradient-accumulation chunks per step
    zero1: bool = True         # shard optimizer state over data(+pod)
    grad_compression: str = "none"  # none | topk | int8 (pod-axis DCN)
    checkpoint_every: int = 100
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (CPU-runnable)."""
    attn = cfg.attn
    small_attn = replace(
        attn,
        n_heads=max(2, min(attn.n_heads, 4)),
        n_kv_heads=max(1, min(attn.n_kv_heads, 2)),
        head_dim=16,
        window=min(attn.window, 32) if attn.window else 0,
    )
    # keep head divisibility
    if small_attn.n_heads % small_attn.n_kv_heads:
        small_attn = replace(small_attn, n_kv_heads=1)
    kw = dict(
        n_layers=2 * cfg.pattern_period,
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        attn=small_attn,
        max_seq=128,
        dtype="float32",
        param_dtype="float32",
        vocab_pad_multiple=8,
        remat=False,
    )
    if cfg.moe:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.recurrent:
        kw["recurrent"] = replace(cfg.recurrent, width=64)
    if cfg.xlstm:
        kw["xlstm"] = replace(cfg.xlstm, n_heads=2, head_dim=16, chunk_size=16)
    if cfg.encoder:
        kw["encoder"] = replace(cfg.encoder, n_layers=2, src_len=16, d_ff=128)
    if cfg.vision:
        kw["vision"] = replace(cfg.vision, n_img_tokens=4, embed_dim=64)
    kw.update(overrides)
    return replace(cfg, **kw).validate()
