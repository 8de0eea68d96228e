"""Checkpointing of the port (reference: ``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointRestoreError,
                                            restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "CheckpointRestoreError",
           "save_pytree", "restore_pytree"]
