"""Packed-ternary matmul — CUTIE's arithmetic on packed weight operands.

Counterpart of `repro.kernels.ternary_matmul`.  Two implementations of one
semantics, ``y[M, N] = (x[M, K] @ decode(w_packed[K/4, N])) * scale[N]``,
float32 accumulation, output in x's dtype:

  * ``ternary_matmul_cuda`` — the wrapper of the hand-written Hopper kernel
    `repro_torch/csrc/ternary_matmul.cu` (CUDA C++, sm_90a, built by nvcc at
    first use and bound through ctypes; see `repro_torch.kernels.build`).
    It replaces the reference's Pallas kernel `_tmm_kernel`.
  * ``ternary_matmul_native`` — the plain PyTorch version: select-decode the
    packed words, one float32 product under `exact_float32`, scale, cast.
    It serves CPU tensors and is what the kernel is held against on the
    card; it is never a fallback for a CUDA tensor.

Weights arrive 2-bit packed **along K** (axis 0, ``[K/4, N]`` uint8): byte
row ``r`` holds K rows ``4r .. 4r+3`` at bit shifts 0/2/4/6 — not the conv's
C_in packing of axis 2.  The decode is the OCU's select algebra
(``plus = b1``, ``minus = NOR(b1, b0)``, operand ``plus - minus``); the
reference's `_select_tile` is `core.ternary.select_decode` along axis 0.

x may be float32 or bfloat16.  Where the reference casts the decoded
weights to bf16 and dots with a float32 accumulator, both implementations
here widen x to float32 instead: the products are the same values (a bf16
value times -1, 0 or +1 is exact either way) and the sums agree exactly on
ternary/dyadic data.  ``scale`` may be float32 or bf16; it is widened to
float32 (exact) before the epilogue.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ternary import select_decode
from repro_torch.kernels import build
from repro_torch.kernels.ref import exact_float32

SOURCE = "ternary_matmul.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _check_k(k: int, k4: int) -> None:
    if k != 4 * k4:
        raise ValueError(
            f"K={k} does not match packed K/4={k4}: pad x to the 4-trit "
            "pack quantum (kernels.ops.ternary_matmul pads)"
        )


def ternary_matmul_native(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    out_dtype=None,
) -> torch.Tensor:
    """The plain PyTorch version on x [M, K], w_packed [K/4, N], scale [N]:
    decode, one float32 product (no TF32), scale, cast to ``out_dtype``
    (default x's dtype).  Runs on the device of ``x``."""
    m, k = x.shape
    k4, n = w_packed.shape
    _check_k(k, k4)
    w = select_decode(w_packed, axis=0, dtype=torch.float32)
    with exact_float32():
        y = x.to(torch.float32) @ w
    y = y * scale.reshape(1, n).to(torch.float32)
    return y.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# The Hopper kernel's wrapper
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL):
    fn = lib.ternary_matmul_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def ternary_matmul_cuda(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    out_dtype=None,
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (same arguments as
    :func:`ternary_matmul_native`; ``out_dtype`` must be x's dtype).  x is
    float32 or bf16, contiguous; ``scale`` float32, contiguous, [N].
    Enqueues on PyTorch's current stream and does not synchronise.  Raises
    ValueError on arguments the kernel does not take and RuntimeError when
    the build or the launch fails; there is no fallback."""
    if x.device.type != "cuda":
        raise ValueError(f"ternary_matmul_cuda needs CUDA tensors, x lies on {x.device}")
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(
            f"x must be [M,K] and w_packed [K/4,N]; got {tuple(x.shape)} and "
            f"{tuple(w_packed.shape)}"
        )
    m, k = x.shape
    k4, n = w_packed.shape
    _check_k(k, k4)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {_DTYPES}")
    if (out_dtype or x.dtype) != x.dtype:
        raise ValueError(f"out_dtype {out_dtype} must be x's dtype {x.dtype}")
    for t, name, dtype in ((w_packed, "w_packed", torch.uint8), (scale, "scale", torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if scale.numel() != n:
        raise ValueError(f"scale needs {n} entries, got {scale.numel()}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty launch: M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    fn = _bind(build.load(SOURCE))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w_packed.data_ptr(),
                scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    if rc != 0:
        raise RuntimeError(
            f"ternary_matmul kernel launch refused (code {rc}) for x"
            f"{tuple(x.shape)} {x.dtype} w{tuple(w_packed.shape)}"
        )
    ternary_matmul_cuda.launches += 1
    return out


# Kernel launches made through the wrapper; incremented only where the kernel
# was launched.  A run resets it to 0 and reads it to prove its path.
ternary_matmul_cuda.launches = 0
