"""Ternary quantization core — the paper's compute paradigm, in PyTorch.

Counterpart of `repro.core.ternary`:

  * ``ternary_quantize_weights`` — TWN threshold quantizer: per-group
    threshold ``delta = nu * mean(|w|)`` and scale
    ``alpha = mean(|w| : |w| > delta)``.
  * ``ternary_quantize_acts`` — symmetric activation ternarizer.
  * ``ste_ternary_weights`` / ``ste_ternary_acts`` — the QAT fake-quant as
    straight-through estimators (`torch.autograd.Function`s built from
    plain tensor ops): the forward sees the quantized value, the backward
    is the reference's — clip-STE on the weights, a hard-tanh window on
    the activations plus a surrogate gradient on a trainable threshold.
  * 2-bit packing codec and its select-mask reading, bit-identical to the
    reference: t in {-1,0,+1} -> code (t+1) in {0,1,2}, 4 codes per byte,
    value ``i`` in bits ``2i..2i+1``.

All functions are plain tensor functions and run on whatever device their
input lies on.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

TERNARY_NU_DEFAULT = 0.7  # TWN threshold factor (0.7 * E|w|)

Axis = Union[None, int, Sequence[int]]


def _axes(axis: Axis) -> Optional[Tuple[int, ...]]:
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def ternary_quantize_weights(
    w: torch.Tensor, *, nu: float = TERNARY_NU_DEFAULT, axis: Axis = None,
    total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None, n_total: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TWN quantizer.  Returns ``(t, alpha)`` with ``t`` in {-1,0,1} (int8)
    and ``alpha`` the positive per-group scale so that ``w ~= alpha * t``.

    ``axis``: axes to *reduce* over for the threshold/scale (None = whole
    tensor); reduced axes are kept with length 1, as in the reference.

    ``total`` (with ``axis=None``): ``w`` is one block of a tensor of
    ``n_total`` values split across devices, and ``total`` sums a tensor
    over the blocks (an all-reduce).  The threshold and the scale are then
    the whole tensor's — ``sum|w|`` and, past the threshold, the masked sum
    and the count, each summed over the blocks — and ``t`` is this block's.
    """
    axes = _axes(axis)
    absw = w.abs()
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    if total is not None:
        if axes is not None:
            raise ValueError("a threshold over blocks is over the whole tensor (axis=None)")
        delta = nu * (total(absw.sum()) / n_total)
        mask = absw > delta
        # float64 keeps a count of more than 2**24 values exact
        sums = total(torch.stack([torch.where(mask, absw, zero).sum().to(torch.float64),
                                  mask.sum().to(torch.float64)]))
        num, den = sums[0].to(w.dtype), sums[1].clamp(min=1).to(w.dtype)
    elif axes is None:
        delta = nu * absw.mean()
        mask = absw > delta
        num = torch.where(mask, absw, zero).sum()
        den = mask.sum().clamp(min=1)
    else:
        delta = nu * absw.mean(dim=axes, keepdim=True)
        mask = absw > delta
        num = torch.where(mask, absw, zero).sum(dim=axes, keepdim=True)
        den = mask.sum(dim=axes, keepdim=True).clamp(min=1)
    t = torch.where(mask, torch.sign(w), zero)
    alpha = num / den
    return t.to(torch.int8), alpha.to(w.dtype)


def ternary_quantize_acts(x: torch.Tensor, *, threshold=0.5) -> torch.Tensor:
    """CUTIE activation ternarizer: sign(x) where |x| > threshold else 0
    (strict ``>``).  ``threshold`` is a float or a tensor broadcastable
    against ``x``.  Same dtype as ``x``, values in {-1, 0, +1}."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x.abs() > threshold, torch.sign(x), zero)


# ---------------------------------------------------------------------------
# Straight-through estimators (QAT)
# ---------------------------------------------------------------------------

class _STEWeights(torch.autograd.Function):
    """Forward ``alpha * ternary(w)``; backward passes ``g`` through inside
    the ``|w| <= max(max|w|, 1e-6)`` band (clip-STE).  ``nu``, ``axis`` and
    the block reduction take no gradient.  The band holds every finite
    value of ``w``, so a block's own max gives the whole tensor's
    gradient."""

    @staticmethod
    def forward(ctx, w, nu, axis, total, n_total):
        ctx.save_for_backward(w)
        t, alpha = ternary_quantize_weights(w, nu=nu, axis=axis, total=total,
                                            n_total=n_total)
        return alpha * t.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        absw = w.abs()
        bound = torch.clamp(absw.max(), min=1e-6)
        return torch.where(absw <= bound, g, torch.zeros_like(g)), None, None, None, None


def ste_ternary_weights(w: torch.Tensor, nu: float, axis: Axis = None, *,
                        total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                        n_total: int = 0) -> torch.Tensor:
    """Weight fake-quant: ``alpha * ternary(w)`` on the grouping
    :func:`ternary_quantize_weights` uses (``axis=(0,1,2)`` on a conv weight
    is the per-OCU scale the silicon applies), with the reference's
    clip-STE backward on ``w``.  ``total`` and ``n_total``: ``w`` is one
    device's block of a weight split across devices, quantized with the
    whole weight's threshold and scale (see `ternary_quantize_weights`)."""
    return _STEWeights.apply(w, nu, axis, total, n_total)


class _STEActs(torch.autograd.Function):
    """Forward: ternarize with ``threshold``.  Backward: ``g`` passes to
    ``x`` where ``|x| <= 2*t + 1``; the threshold gets the surrogate
    ``-sum(g * sign(x) * [||x| - t| <= 0.5])`` — over everything for a
    scalar ``t`` divided by ``sqrt(g.numel())``, over the leading axes for
    a ``[C]`` vector divided by ``sqrt(g.numel() // C)``."""

    @staticmethod
    def forward(ctx, x, threshold):
        ctx.threshold_is_tensor = isinstance(threshold, torch.Tensor)
        # a fill on the device, not a tensor made from Python data: no
        # host-to-device copy inside a captured step
        t = threshold if ctx.threshold_is_tensor else torch.full(
            (), float(threshold), dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, t)
        return ternary_quantize_acts(x, threshold=threshold)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        dx = torch.where(x.abs() <= 2.0 * t + 1.0, g, zero) if ctx.needs_input_grad[0] else None
        if not (ctx.threshold_is_tensor and ctx.needs_input_grad[1]):
            return dx, None
        near = ((x.abs() - t).abs() <= 0.5).to(g.dtype)
        contrib = g * torch.sign(x) * near
        if t.ndim == 0:
            n = g.numel()
            dt = -contrib.sum()
        else:
            n = g.numel() // t.numel()
            dt = -contrib.sum(dim=tuple(range(contrib.ndim - t.ndim))).reshape(t.shape)
        dt = dt / torch.sqrt(torch.full((), float(n), dtype=g.dtype, device=g.device))
        return dx, dt.to(t.dtype)


def ste_ternary_acts(x: torch.Tensor, threshold) -> torch.Tensor:
    """Activation fake-quant: ternarize with ``threshold`` (a Python float,
    a 0-d tensor, or a per-channel ``[C]`` vector over the last axis).  A
    float threshold, or a tensor that does not require grad, takes no
    gradient; a trainable one takes the reference's surrogate."""
    return _STEActs.apply(x, threshold)


def clamp_threshold(t, lo: float = 0.05, hi: float = 2.0):
    """Keep a learned activation threshold in its meaningful band; QAT and
    deployment folding apply the SAME clamp so the values round-trip.  The
    gradient passes unchanged inside the band."""
    return torch.clamp(torch.as_tensor(t), lo, hi)


# ---------------------------------------------------------------------------
# 2-bit packing codec
# ---------------------------------------------------------------------------

def _shifts(device) -> torch.Tensor:
    # made on the device (no host-to-device copy), so a captured CUDA graph
    # may decode weights inside its step
    return torch.arange(0, 8, 2, dtype=torch.uint8, device=device)


def pack_ternary(t: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {-1,0,1} integer tensor into uint8, 4 values per byte along
    ``axis`` (length must be a multiple of 4; pad upstream with zeros)."""
    axis = axis % t.ndim
    if t.shape[axis] % 4 != 0:
        raise ValueError(f"pack axis length {t.shape[axis]} not a multiple of 4")
    u = (t.to(torch.int8) + 1).to(torch.uint8)  # {0,1,2}
    u = torch.movedim(u, axis, -1)
    u = u.reshape(*u.shape[:-1], u.shape[-1] // 4, 4)
    # the four 2-bit fields never overlap, so OR == the reference's sum
    packed = (u[..., 0] | (u[..., 1] << 2) | (u[..., 2] << 4) | (u[..., 3] << 6))
    return torch.movedim(packed, -1, axis).contiguous()


def _codes(p: torch.Tensor, axis: int) -> torch.Tensor:
    """uint8 packed words -> uint8 2-bit codes with the packed axis last,
    expanded to 4x its length."""
    p = torch.movedim(p, axis, -1)
    u = (p.unsqueeze(-1) >> _shifts(p.device)) & 3  # [..., K//4, 4]
    return u.reshape(*u.shape[:-2], u.shape[-2] * 4)


def unpack_ternary(p: torch.Tensor, axis: int = -1, *, dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`; returns values in {-1,0,1}."""
    axis = axis % p.ndim
    t = _codes(p, axis).to(torch.int8) - 1
    return torch.movedim(t.to(dtype), -1, axis).contiguous()


def select_masks(p: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode packed trits to ``(plus, minus)`` select masks — the OCU's
    add/subtract-select decode.  Per 2-bit code ``b1b0``: ``plus = b1``,
    ``minus = NOR(b1, b0)``; ``plus - minus`` reproduces the trit.  The
    code 11 never occurs in :func:`pack_ternary` output (it decodes to +1)."""
    axis = axis % p.ndim
    code = _codes(p, axis)
    plus = (code >> 1) & 1
    minus = ((code | (code >> 1)) & 1) ^ 1
    return (torch.movedim(plus, -1, axis).contiguous(),
            torch.movedim(minus, -1, axis).contiguous())


def select_decode(p: torch.Tensor, axis: int = -1, *, dtype=torch.int8) -> torch.Tensor:
    """``plus - minus`` over :func:`select_masks` — bit-identical to
    :func:`unpack_ternary` on valid packed words; the form the packed
    kernels consume."""
    plus, minus = select_masks(p, axis)
    return (plus.to(torch.int8) - minus.to(torch.int8)).to(dtype)


def packed_nbytes(shape, axis: int = -1) -> int:
    """Bytes of the packed representation of a ternary tensor of ``shape``."""
    shape = list(shape)
    axis = axis % len(shape)
    shape[axis] = -(-shape[axis] // 4)  # ceil div
    n = 1
    for s in shape:
        n *= s
    return n


def sparsity(t: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (a float32 scalar tensor)."""
    return (t == 0).to(torch.float32).mean()
