from repro_torch.kernels.flash_attention.ops import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    kernel_info,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

__all__ = ["KERNEL_HEAD_DIMS", "NEG_INF", "flash_attention",
           "flash_attention_ref", "kernel_info"]
