from repro_torch.kernels.flash_attention.ops import (
    KERNEL_HEAD_DIMS,
    count_valid_pairs,
    flash_attention,
    flash_cost,
    kernel_info,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

__all__ = ["KERNEL_HEAD_DIMS", "NEG_INF", "count_valid_pairs",
           "flash_attention", "flash_attention_ref", "flash_cost",
           "kernel_info"]
