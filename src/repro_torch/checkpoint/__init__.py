"""Atomic, async keep-N checkpointing in the reference's on-disk format."""

from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
