"""Plain-PyTorch oracles for the packed kernels — counterpart of
`repro.kernels.ref` (`ternary_matmul_ref`, `ternary_conv2d_ref`).

They define the semantics; each kernel and its plain version must match
them bit-exactly on ternary/dyadic data.  The exactness argument
(integer-valued partial sums are exact in float32 under any order) only
holds for true float32 arithmetic, so `exact_float32` switches off every
reduced-precision or transform-domain convolution path around the call:

  * TF32 (cuDNN convolutions default to it; it keeps 10 mantissa bits),
  * cuDNN altogether on the card — its Winograd/FFT algorithms multiply by
    non-dyadic constants and round where a direct sum would not.  With
    cuDNN off a CUDA `F.conv2d` is im2col + a float32 GEMM: a direct sum.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.ternary import unpack_ternary


@contextlib.contextmanager
def exact_float32():
    """Run the enclosed float32 convolutions and matmuls as direct float32
    sums: cuDNN off, TF32 off for both convolutions and matmuls.  Restores
    the previous settings on exit."""
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul


def ternary_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """y = x @ unpack(w_packed, axis=0) * scale (scale broadcast over N),
    a float32 product without TF32, cast to x's dtype."""
    w = unpack_ternary(w_packed, axis=0).to(torch.float32)
    with exact_float32():
        y = x.to(torch.float32) @ w
    return (y * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def ternary_conv2d_ref(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    fuse_ternary: bool = False,
    threshold=0.5,
    fuse_pool: int = 0,
    out_dtype=None,
) -> torch.Tensor:
    """SAME conv of x [B,H,W,C_in] with ternary packed weights
    [KH,KW,C_in/4,C_out] + per-channel scale.  ``threshold`` is a scalar or
    a [C_out] vector; ``fuse_pool`` > 1 appends a window/stride
    ``fuse_pool`` max-pool (VALID: a ragged edge is dropped) after the
    optional ternarization."""
    kh, kw = w_packed.shape[0], w_packed.shape[1]
    w = unpack_ternary(w_packed, axis=2).to(torch.float32)
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xn = F.pad(x.to(torch.float32).permute(0, 3, 1, 2),
               (left, kw - 1 - left, top, kh - 1 - top))
    with exact_float32():
        y = F.conv2d(xn, w.permute(3, 2, 0, 1))
    y = y.permute(0, 2, 3, 1) * scale.reshape(1, 1, 1, -1).to(torch.float32)
    if fuse_ternary:
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=y.device)
        y = torch.where(y.abs() > thr, torch.sign(y), torch.zeros_like(y))
    if fuse_pool > 1:
        p = fuse_pool
        b, h, wd, c = y.shape
        y = y[:, : h // p * p, : wd // p * p]
        y = y.reshape(b, h // p, p, wd // p, p, c).amax(dim=(2, 4))
    return y.contiguous().to(out_dtype or x.dtype)
