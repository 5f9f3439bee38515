from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    checkpoint_steps,
    is_complete,
    latest_complete_step,
    latest_step,
    prune_checkpoints,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    to_host,
)

__all__ = [
    "CheckpointManager",
    "checkpoint_steps",
    "is_complete",
    "latest_complete_step",
    "latest_step",
    "prune_checkpoints",
    "read_manifest",
    "restore_checkpoint",
    "save_checkpoint",
    "to_host",
]
