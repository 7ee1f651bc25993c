"""Pytree checkpoints in the reference's ``repro-ckpt-v1`` format."""

from repro_torch.checkpoint.checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "CorruptCheckpointError"]
