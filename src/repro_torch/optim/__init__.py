"""Optimizer of the port: the reference's AdamW on trees of tensors
(`repro_torch.optim.adamw`).  The reference's gradient compression
(`optim/compress.py`) belongs to its LM scaffold and is not ported."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "lr_schedule",
]
