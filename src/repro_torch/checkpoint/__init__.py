"""Checkpointing, in the reference's on-disk format."""

from .manager import CheckpointManager, save_checkpoint, restore_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
