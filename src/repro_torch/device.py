"""Device resolution for the port's entry points.

Entry points default to the card.  Asking for CUDA on a host without one is
an error, never a quiet move to the CPU: a caller who wants the CPU says so.
"""
from __future__ import annotations

import subprocess
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


def device_meta(device: Union[str, torch.device]) -> Union[str, dict]:
    """What a bench records as ``meta.device``: ``"cpu"`` on the host; on a
    card its name, its power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` reports it, and the count of visible cards."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    line = smi[min(index, len(smi) - 1)]
    return {
        "name": torch.cuda.get_device_name(dev),
        "power_limit": line.rsplit(",", 1)[1].strip(),
        "nvidia_smi": line.strip(),
        "count": torch.cuda.device_count(),
    }
