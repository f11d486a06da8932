"""Public wrappers over the packed kernels — counterpart of
`repro.kernels.ops` (`ternary_matmul`, `ternary_conv2d`).

They handle the pad to the 4-trit pack quantum (K for the matmul, C_in for
the conv), the conv's scalar-threshold splat / per-channel ``[C_out]``
vector check, and the dispatch by the tensor's device:

  * a CPU tensor goes to the plain PyTorch version (``*_native``);
  * a CUDA tensor launches the hand-written Hopper kernel (``*_cuda``)
    **or raises** — it never reaches the plain version, and a failed build
    or launch is not caught;
  * any other device raises.

Ragged M, N and C_out need no padding here: the kernels mask their last
tiles themselves.  The reference's TPU grid knobs are dropped — ``block_m``
/ ``block_n`` / ``block_k`` / ``block_cout`` (the Pallas block shapes; the
CUDA kernels pick their own tiles), ``impl`` and ``interpret`` (the Pallas
interpreter has no counterpart: the device of the input decides).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ternary_conv2d import (
    ternary_conv2d_cuda,
    ternary_conv2d_native,
)
from repro_torch.kernels.ternary_matmul import (
    ternary_matmul_cuda,
    ternary_matmul_native,
)


def ternary_matmul(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
) -> torch.Tensor:
    """y[..., N] = x[..., K] @ select_decode(w_packed)[K, N] * scale[N],
    float32 accumulation, output in x's dtype (float32 or bfloat16).
    ``w_packed`` is [ceil(K/4), N] uint8 packed along K; x is zero-padded up
    to 4 * K/4 (the pack quantum only ever pads, never truncates)."""
    *lead, k = x.shape
    k4, n = w_packed.shape
    if 4 * k4 < k:
        raise ValueError(
            f"packed weight carries K={4 * k4} < input K={k}: the pack "
            "quantum only ever pads, never truncates"
        )
    x2 = x.reshape(-1, k)
    if 4 * k4 != k:
        x2 = F.pad(x2, (0, 4 * k4 - k))
    sc = scale.reshape(-1)
    if x.device.type == "cpu":
        y = ternary_matmul_native(x2, w_packed, sc, out_dtype=x.dtype)
    elif x.device.type == "cuda":
        y = ternary_matmul_cuda(x2.contiguous(), w_packed.contiguous(),
                                sc.to(torch.float32).contiguous(), out_dtype=x.dtype)
    else:
        raise ValueError(f"ternary_matmul has no implementation for device {x.device}")
    return y.reshape(*lead, n)


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
