"""Device resolution for the port's entry points.

Entry points default to the card.  Asking for CUDA on a host without one is
an error, never a quiet move to the CPU: a caller who wants the CPU says so.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a `torch.device`; raises
    RuntimeError when it names CUDA and no CUDA device is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path on the host"
        )
    return dev
