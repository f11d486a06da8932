"""Optimizer of the port: the reference's AdamW on trees of tensors
(`repro_torch.optim.adamw`) and its ternary gradient compression with error
feedback (`repro_torch.optim.compress`)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)
from repro_torch.optim.compress import (
    CompressedGrad,
    compress_with_feedback,
    decompress,
    init_residuals,
    wire_bytes,
)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "lr_schedule",
    "CompressedGrad", "compress_with_feedback", "decompress", "init_residuals",
    "wire_bytes",
]
