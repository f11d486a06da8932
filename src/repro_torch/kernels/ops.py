"""Public wrapper over the fused ternary conv — counterpart of
`repro.kernels.ops.ternary_conv2d`.

Handles the channel pad to the 4-trit pack quantum, the scalar-threshold
splat / per-channel ``[C_out]`` vector check, and the dispatch:

  * a CPU tensor goes to the plain PyTorch version
    (`ternary_conv2d_native`);
  * a CUDA tensor launches the hand-written Hopper kernel
    (`ternary_conv2d_cuda`) **or raises** — it never reaches the plain
    version, and a failed build or launch is not caught.

Ragged C_out needs no padding here: the kernel masks its last channel tile
itself.  There is no ``block_cout`` argument — that was the TPU kernel's
lane tiling; the CUDA kernel picks its own tile.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ternary_conv2d import (
    ternary_conv2d_cuda,
    ternary_conv2d_native,
)


def ternary_conv2d(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    fuse_ternary: bool = False,
    threshold=0.5,
    fuse_pool: int = 0,
    out_dtype=None,
) -> torch.Tensor:
    """SAME ternary conv over x [B, H, W, C_in] with w_packed
    [KH, KW, C_in/4, C_out] and per-channel ``scale``.  With
    ``fuse_ternary`` (and optionally ``fuse_pool`` / ``out_dtype=
    torch.int8``) the whole CUTIE layer — conv, threshold unit, pooling —
    is one kernel launch emitting ternary activations.  ``threshold`` is
    the ThFU comparator constant: a scalar (splatted across channels) or a
    per-channel [C_out] vector."""
    kh, kw, c4, c_out = w_packed.shape
    c_in = x.shape[-1]
    if 4 * c4 > c_in:
        x = F.pad(x, (0, 4 * c4 - c_in))
    if isinstance(threshold, torch.Tensor) and threshold.ndim > 0:
        thr = threshold.to(device=x.device, dtype=torch.float32)
        if tuple(thr.shape) != (c_out,):
            raise ValueError(f"threshold shape {tuple(thr.shape)} != ({c_out},)")
    else:
        thr = torch.full((c_out,), float(threshold), dtype=torch.float32,
                         device=x.device)
    kwargs = dict(fuse_ternary=fuse_ternary, fuse_pool=fuse_pool,
                  out_dtype=out_dtype or x.dtype)
    if x.device.type == "cpu":
        return ternary_conv2d_native(x, w_packed, scale.reshape(-1), thr, **kwargs)
    if x.device.type == "cuda":
        return ternary_conv2d_cuda(
            x.contiguous(), w_packed.contiguous(), scale.reshape(-1).contiguous(),
            thr.contiguous(), **kwargs,
        )
    raise ValueError(f"ternary_conv2d has no implementation for device {x.device}")
