"""Checkpoints of the port (`repro_torch.ckpt.checkpoint`): the reference's
committed on-disk layout over trees of tensors."""
from repro_torch.ckpt.checkpoint import (
    committed_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["committed_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
