"""Checkpoints in torch.  Counterpart of ``repro.checkpoint``."""
from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                         restore_train_state,
                                         save_checkpoint, save_train_state)

__all__ = ["save_checkpoint", "restore_checkpoint", "save_train_state",
           "restore_train_state"]
