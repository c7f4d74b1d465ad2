"""Checkpoints of the port: a MessagePack manifest and one compressed blob
per leaf, atomic step directories, keep-last-k rotation, in the
reference's layout, so that either package reads the other's."""
from .store import (CheckpointManager, latest_step, load_manifest,
                    restore_checkpoint, save_checkpoint)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "load_manifest",
    "restore_checkpoint",
    "save_checkpoint",
]
