"""Checkpoints of nested dicts of tensors, with async save and restart
(port of the reference's ``checkpoint/``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager, restore_pytree, save_pytree,
)

__all__ = ["CheckpointManager", "restore_pytree", "save_pytree"]
