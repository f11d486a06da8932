"""Fused ternary conv2d — the CUTIE OCU array on packed operands.

Counterpart of `repro.kernels.ternary_conv2d`.  Two implementations of one
semantics:

  * ``ternary_conv2d_cuda`` — the wrapper of the hand-written Hopper kernel
    `repro_torch/csrc/ternary_conv2d.cu` (CUDA C++, sm_90a, built by nvcc at
    first use and bound through ctypes; see `repro_torch.kernels.build`).
    It replaces the reference's Pallas kernel `_tconv_kernel`.
  * ``ternary_conv2d_native`` — the plain PyTorch version: the reference's
    ``ternary_conv2d_native`` tap walk (select decode, KH*KW shifted
    ``[B*H*W, C_in] @ [C_in, C_out]`` float32 products in the same order,
    the shared epilogue).  It serves CPU tensors and is what the kernel is
    held against on the card; it is never a fallback for a CUDA tensor.

Weights arrive 2-bit packed along C_in, ``[KH, KW, C_in/4, C_out]`` uint8 —
the quantizer's deploy-table bytes, consumed verbatim and decoded inside the
kernel (``plus = b1``, ``minus = NOR(b1, b0)``, operand ``plus - minus``).
The epilogue applies the per-channel scale, optionally the ThFU ternarize
``|y| > thr ? sign(y) : 0`` (strict ``>``) and optionally a ``p x p``
max-pool, so a whole TNN layer is one launch emitting int8 trits.

With ternary or dyadic inputs every partial sum is an integer (or a
multiple of 1/4) and exact in float32 under any summation order, so both
implementations — and the reference's — agree bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import exact_float32

SOURCE = "ternary_conv2d.cu"
_SHIFTS = (0, 2, 4, 6)
_TILE_PIXELS = 64  # kTilePix of the kernel: output pixels per block at most
_TILE_CHOICES = (64, 32, 16)  # pixel tiles of the plan, largest first
_TILE_N = 32       # kTileN of the kernel: output channels per block
_WARPS = 4         # warps per block
_MAX_POOL = 8      # largest pool window a 64-pixel tile can hold square
TARGET_BLOCKS = 132  # one block per SM of an H100
# route 1, the persistent wgmma kernel: its constants (kWg* in the source)
_WG_TILE = 8          # a warpgroup's tile: 8 x 8 output pixels
_WG_GROUPS = 4        # consumer warpgroups per block
_WG_WIDTHS = (64, 96)  # C_out that one wgmma covers (its N)
_WG_MAX_SMEM = 232448  # dynamic shared memory a block may use
# the crossover: the wgmma kernel takes a launch that fills the card, at
# least one 8 x 8 tile per SM and 1024 output pixels.  Launch by launch it is
# the faster from 32 tiles on (PERF.md section 6), but in the pool-8 tick its
# two launches of 128 and 32 tiles made the served tick slower, not faster
WG_MIN_TILES = TARGET_BLOCKS
WG_MIN_PIXELS = 1024


def _select_w(wp: torch.Tensor, dtype) -> torch.Tensor:
    """[KH, KW, C4, N] uint8 -> [KH, KW, 4*C4, N] add/subtract-select
    operands in ``dtype``: per 2-bit code ``plus = b1``, ``minus =
    NOR(b1, b0)``, operand = plus - minus in {-1, 0, +1}."""
    kh, kw, c4, n = wp.shape
    parts = []
    for s in _SHIFTS:
        code = (wp >> s) & 3
        plus = (code >> 1) & 1
        minus = ((code | (code >> 1)) & 1) ^ 1
        parts.append(plus.to(torch.int8) - minus.to(torch.int8))
    w = torch.stack(parts, dim=3)  # (kh, kw, c4, 4, n)
    return w.reshape(kh, kw, c4 * 4, n).to(dtype)


def _epilogue(y, scale, thr, *, h: int, w: int, bn: int,
              fuse_ternary: bool, fuse_pool: int):
    """Scale -> optional ThFU ternarize -> optional max-pool, on a
    (pixels, bn) float32 accumulator (pixels row-major over (h, w))."""
    y = y * scale.to(torch.float32)
    if fuse_ternary:
        y = torch.where(y.abs() > thr.to(torch.float32), torch.sign(y),
                        torch.zeros_like(y))
    if fuse_pool > 1:
        p = fuse_pool
        return y.reshape(h // p, p, w // p, p, bn).amax(dim=(1, 3))
    return y.reshape(h, w, bn)


def _check_geometry(c_in, c4, h, w, fuse_pool):
    if c_in != 4 * c4:
        raise ValueError(
            f"C_in={c_in} does not match packed C_in/4={c4}: activations "
            "must be channel-padded to the 4-trit pack quantum "
            "(kernels.ops.ternary_conv2d pads)"
        )
    if fuse_pool > 1 and (h % fuse_pool or w % fuse_pool):
        raise ValueError(
            f"fuse_pool={fuse_pool} does not divide the {h}x{w} feature map"
        )


def ternary_conv2d_native(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    threshold: torch.Tensor,
    *,
    fuse_ternary: bool = False,
    fuse_pool: int = 0,
    out_dtype=None,
) -> torch.Tensor:
    """The plain PyTorch version: SAME conv of x [B,H,W,C_in] with
    w_packed [KH,KW,C_in/4,C_out], scale [C_out], threshold [C_out] (read
    only when ``fuse_ternary``).  Runs on the device of ``x``."""
    b, h, w, c_in = x.shape
    kh, kw, c4, c_out = w_packed.shape
    _check_geometry(c_in, c4, h, w, fuse_pool)
    out_dtype = out_dtype or x.dtype
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    wt = _select_w(w_packed, torch.float32)

    acc = torch.zeros((b * h * w, c_out), dtype=torch.float32, device=x.device)
    with exact_float32():
        for dy in range(kh):
            for dx in range(kw):
                xs = xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, c_in)
                acc += xs.to(torch.float32) @ wt[dy, dx]

    # batch rides as extra leading pixel rows (h' = b*h): fuse_pool divides
    # h, so the pool grouping stays inside each sample
    y = _epilogue(
        acc, scale.reshape(1, c_out), threshold.reshape(1, c_out),
        h=b * h, w=w, bn=c_out, fuse_ternary=fuse_ternary, fuse_pool=fuse_pool,
    )
    oh, ow = (h // fuse_pool, w // fuse_pool) if fuse_pool > 1 else (h, w)
    return y.reshape(b, oh, ow, c_out).to(out_dtype)


# ---------------------------------------------------------------------------
# The Hopper kernel's wrapper
# ---------------------------------------------------------------------------

def tile_shape(h: int, w: int, fuse_pool: int, pixels: int = _TILE_PIXELS) -> Tuple[int, int]:
    """The (rows, cols) of output pixels one block of the kernel owns: at
    most ``pixels`` (64, 32 or 16), both sides multiples of the pool window
    so a window never straddles two blocks.  Narrow maps (the TCN-mapped
    25x1, 13x2, 7x4) get tall tiles instead of mostly-empty square ones."""
    p = fuse_pool if fuse_pool > 1 else 1
    if p > _MAX_POOL:
        raise ValueError(
            f"fuse_pool={fuse_pool}: the CUDA kernel holds pool windows up to "
            f"{_MAX_POOL}x{_MAX_POOL} in one {_TILE_PIXELS}-pixel tile"
        )
    if pixels not in _TILE_CHOICES or p * p > pixels:
        raise ValueError(f"no {pixels}-pixel tile holds a {p}x{p} pool window")
    if p & (p - 1):  # not a power of two: the largest square of whole windows
        side = (math.isqrt(pixels) // p) * p
        return side, side
    tw = 1
    while tw < min(w, 8):
        tw *= 2
    tw = min(max(tw, p), pixels // p)
    return pixels // tw, tw


class ConvPlan(NamedTuple):
    """What the wrapper passes to the kernel, which checks every field."""
    route: int         # 0: the mma.sync kernel; 1: the persistent wgmma kernel
    tile_h: int        # output pixels per block (route 0) or warpgroup (route 1): rows ...
    tile_w: int        # ... and columns, multiples of the pool window
    k_padded: int      # KH*KW*C_in padded with zero trits to whole mmas (32 int8, 16 bf16 deep)
    warps_per_rows: int  # warps that share one 16-pixel row group (split the reduction)
    blocks: int        # grid size


def _round16(v: int) -> int:
    return (v + 15) & ~15


def wg_smem_bytes(kh: int, kw: int, c_in: int, c_out: int) -> int:
    """Dynamic shared memory of one block of the wgmma kernel (`wg_layout`
    in the source): the decoded B operand (k-steps x 32 x C_out bytes), the
    k-step table, scales and thresholds, and per warpgroup two input patches
    and its warps' output staging rows."""
    k_steps = kh * kw * c_in // 32
    fixed = _round16(k_steps * 32 * c_out) + _round16(k_steps * 4) + 2 * _round16(c_out * 4)
    patch = _round16((_WG_TILE + kh - 1) * (_WG_TILE + kw - 1) * (c_in + 16))
    staging = 4 * 16 * (c_out + 16)
    return fixed + _WG_GROUPS * (2 * patch + staging)


def wg_tiles(b: int, h: int, w: int) -> int:
    """The wgmma kernel's 8 x 8 output tiles of a launch: B*H*W in whole tiles."""
    return b * -(-h // _WG_TILE) * -(-w // _WG_TILE)


def conv_route(b: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int,
               fuse_pool: int, x_dtype=torch.int8) -> int:
    """The kernel a launch of this shape takes, from the shape alone: 1, the
    persistent wgmma kernel, for int8 x whose k32 steps each stay inside one
    tap (C_in % 32 == 0), C_out one wgmma covers, no pool or a 2x2 one, the
    decoded weights and patches within a block's shared memory, and at least
    ``WG_MIN_TILES`` tiles and ``WG_MIN_PIXELS`` output pixels; else 0, the
    mma.sync kernel."""
    return int(
        x_dtype == torch.int8 and c_in % 32 == 0 and c_out in _WG_WIDTHS
        and fuse_pool in (0, 1, 2) and wg_tiles(b, h, w) >= WG_MIN_TILES
        and b * h * w >= WG_MIN_PIXELS
        and wg_smem_bytes(kh, kw, c_in, c_out) <= _WG_MAX_SMEM
    )


def _mma_plan(b: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int,
              fuse_pool: int, x_dtype) -> ConvPlan:
    """Route 0's tiling: M = output pixels in tiles of 64, 32 or 16 (the
    largest that still gives ``TARGET_BLOCKS`` blocks, else the smallest that
    holds a pool window), N = 32-channel tiles, and the reduction (tap,
    channel) flattened with the channel fastest and padded once to the mma
    depth.  Four warps per block; a tile of fewer than 64 pixels splits its
    reduction across the warps that share a 16-pixel row group."""
    p = fuse_pool if fuse_pool > 1 else 1
    n_tiles = -(-c_out // _TILE_N)
    choices = [px for px in _TILE_CHOICES if px >= p * p]
    if not choices:
        tile_shape(h, w, fuse_pool)  # raises with the reason
    for pixels in choices:
        th, tw = tile_shape(h, w, fuse_pool, pixels)
        blocks = b * -(-h // th) * -(-w // tw) * n_tiles
        if blocks >= TARGET_BLOCKS:
            break
    mma_k = 32 if x_dtype == torch.int8 else 16
    k_padded = -(-kh * kw * c_in // mma_k) * mma_k
    row_groups = -(-th * tw // 16)
    return ConvPlan(0, th, tw, k_padded, _WARPS // row_groups, blocks)


def _wgmma_plan(b: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int) -> ConvPlan:
    """Route 1's tiling: 8 x 8 output-pixel tiles (a 64-row wgmma, each warp
    16 rows = 2 image rows x 8 columns, so a 2x2 window is two registers and
    a neighbour lane), all of C_out in one wgmma, the reduction in k32 steps
    with no padding, and one block per tile up to one per SM: tile t goes to
    block ``t % blocks``, and a block's ``_WG_GROUPS`` warpgroups take its
    tiles in turn."""
    blocks = min(TARGET_BLOCKS, wg_tiles(b, h, w))
    return ConvPlan(1, _WG_TILE, _WG_TILE, kh * kw * c_in, 1, blocks)


def conv_plan(b: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int,
              fuse_pool: int, x_dtype=torch.int8) -> ConvPlan:
    """The kernel's tiling of one launch as an implicit GEMM (M = output
    pixels, N = output channels, K = (tap, channel) with the channel
    fastest), on the route `conv_route` picks from the shape: the persistent
    wgmma kernel's (`_wgmma_plan`) or the mma.sync kernel's (`_mma_plan`)."""
    if x_dtype not in (torch.float32, torch.int8):
        raise ValueError(f"x dtype {x_dtype} not in (float32, int8)")
    if conv_route(b, h, w, c_in, c_out, kh, kw, fuse_pool, x_dtype):
        return _wgmma_plan(b, h, w, c_in, c_out, kh, kw)
    return _mma_plan(b, h, w, c_in, c_out, kh, kw, fuse_pool, x_dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.ternary_conv2d_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _require(t: torch.Tensor, name: str, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {tuple(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ternary_conv2d_cuda(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    threshold: torch.Tensor,
    *,
    fuse_ternary: bool = False,
    fuse_pool: int = 0,
    out_dtype=None,
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (same arguments as
    :func:`ternary_conv2d_native`).  x is float32 or int8; the output is
    float32, or int8 when ``fuse_ternary``.  The launch's shape picks the
    route (`conv_plan`).  Enqueues on PyTorch's current stream and does not
    synchronise.  Raises ValueError on arguments the kernel does not take
    and RuntimeError when the build or the launch fails; there is no
    fallback."""
    return _launch_planned(x, w_packed, scale, threshold, None, fuse_ternary=fuse_ternary,
                           fuse_pool=fuse_pool, out_dtype=out_dtype)


def _launch_planned(x, w_packed, scale, threshold, plan, *, fuse_ternary=False, fuse_pool=0,
                    out_dtype=None) -> torch.Tensor:
    """`ternary_conv2d_cuda` with a given plan (None: `conv_plan`'s), for the
    card's tests and the crossover measurement, which hold both routes
    against each other at one shape."""
    if x.device.type != "cuda":
        raise ValueError(f"ternary_conv2d_cuda needs CUDA tensors, x lies on {x.device}")
    if x.ndim != 4 or w_packed.ndim != 4:
        raise ValueError(
            f"x must be [B,H,W,C_in] and w_packed [KH,KW,C_in/4,C_out]; got "
            f"{tuple(x.shape)} and {tuple(w_packed.shape)}"
        )
    b, h, w, c_in = x.shape
    kh, kw, c4, c_out = w_packed.shape
    _check_geometry(c_in, c4, h, w, fuse_pool)
    out_dtype = out_dtype or x.dtype
    _require(x, "x", (torch.float32, torch.int8), x.device)
    _require(w_packed, "w_packed", (torch.uint8,), x.device)
    _require(scale, "scale", (torch.float32,), x.device)
    _require(threshold, "threshold", (torch.float32,), x.device)
    if scale.numel() != c_out or threshold.numel() != c_out:
        raise ValueError(
            f"scale/threshold need {c_out} entries, got {scale.numel()} and "
            f"{threshold.numel()}"
        )
    if out_dtype not in (torch.float32, torch.int8):
        raise ValueError(f"out_dtype {out_dtype} not in (float32, int8)")
    if out_dtype == torch.int8 and not fuse_ternary:
        raise ValueError("int8 output carries trits only: it needs fuse_ternary=True")
    if min(b, h, w, c_out) < 1 or b > 65535:
        raise ValueError(f"empty or oversized launch: B={b} H={h} W={w} C_out={c_out}")
    plan = plan or conv_plan(b, h, w, c_in, c_out, kh, kw, fuse_pool, x.dtype)
    # cp.async copies 4 B of int8 x (16 B of float32 x) and 4 B of packed
    # bytes: a view that starts off that alignment is copied first
    if x.data_ptr() % 16:
        x = x.clone()
    if w_packed.data_ptr() % 4:
        w_packed = w_packed.clone()
    oh, ow = (h // fuse_pool, w // fuse_pool) if fuse_pool > 1 else (h, w)
    out = torch.empty((b, oh, ow, c_out), dtype=out_dtype, device=x.device)

    fn = _bind(build.load(SOURCE))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.int8), w_packed.data_ptr(),
            scale.data_ptr(), threshold.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.int8), b, h, w, c_in, kh, kw, c_out, *plan,
            int(bool(fuse_ternary)), int(fuse_pool), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ternary_conv2d kernel launch refused (code {rc}) for x"
            f"{tuple(x.shape)} w{tuple(w_packed.shape)} pool={fuse_pool} {plan}"
        )
    wg = int(plan.route == 1)
    if capturing:
        ternary_conv2d_cuda.recorded += 1
        ternary_conv2d_cuda.recorded_wgmma += wg
    else:
        ternary_conv2d_cuda.launches += 1
        ternary_conv2d_cuda.launches_wgmma += wg
    return out


# Kernel launches made through the wrapper; incremented only where the kernel
# was launched.  A run resets it to 0 and reads it to prove its path.  A call
# made while the stream is capturing a CUDA graph launches nothing: it counts
# in ``recorded``, and the graph's owner adds the launches its graph holds to
# ``launches`` on every replay (`repro_torch.capture.CapturedStep`).  The
# ``_wgmma`` pair counts the launches among them that took route 1.
ternary_conv2d_cuda.launches = 0
ternary_conv2d_cuda.recorded = 0
ternary_conv2d_cuda.launches_wgmma = 0
ternary_conv2d_cuda.recorded_wgmma = 0
