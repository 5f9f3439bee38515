"""The port's optimizer: AdamW with an f32 master, the cosine schedule
and gradient compression with error feedback."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_gradients,
    decompress_gradients,
    init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "compress_gradients",
    "decompress_gradients",
    "init_error_feedback",
]
