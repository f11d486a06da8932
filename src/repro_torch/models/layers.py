"""Shared layer primitives: linear (dense / QAT-ternary / packed-ternary),
norms, rotary embeddings, embedding tables.  Counterpart of
`repro.models.layers`.

Every projection in every architecture funnels through :func:`linear`, which
is where the paper's technique plugs in (cfg.quant / cfg.act_quant).

Init functions take a `torch.Generator` (its draws cannot reproduce the
reference's ``jax.random`` streams; parity tests hand the reference's params
across with `repro_torch.convert.lm_params_from_reference`), a ``device``,
and ``lead``: leading axes of stacked layers, so a segment's params are made
already stacked as the reference's vmapped init makes them.  On the meta
device they allocate nothing and give the tree's shapes and dtypes.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ternary import (
    pack_ternary,
    ste_ternary_acts,
    ste_ternary_weights,
    ternary_quantize_weights,
    unpack_ternary,
)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def normal(gen: Optional[torch.Generator], shape, std: float, device) -> torch.Tensor:
    """``std * N(0, 1)`` in float32, drawn from ``gen`` on the generator's
    device and moved to ``device``; an empty tensor on the meta device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device if gen is not None else device)
    return (w * std).to(device)


def meta(shape, dtype) -> torch.Tensor:
    """A tensor on the meta device: a shape and dtype of a spec tree."""
    return torch.empty(shape, dtype=dtype, device="meta")


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum with the reference's dtype promotion (bf16 with
    float32 computes in float32); `torch.einsum` itself refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


@functools.lru_cache(maxsize=256)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``: a Python scalar meets a bf16 array in the
    reference as a weakly typed bf16 value, so ``x * weak_scalar(c, x.dtype)``
    rounds as the reference's ``x * c`` does.  Cached per ``(c, dtype)``: a
    step calls it for the same few constants every time, and the rounding
    makes a tensor from Python data and reads it back."""
    return float(torch.tensor(c, dtype=dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, each step
    rounded in x's dtype as the reference's ``jax.nn.silu`` rounds in bf16
    (`F.silu` and `torch.sigmoid` round once, which differs by an ulp in
    about a third of bf16 values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# Linear with quantization modes
# ---------------------------------------------------------------------------

def linear_from_weight(w: torch.Tensor, *, bias: bool = False, quant: str = "none",
                       dtype=torch.float32):
    """Linear params over a float32 weight ``w [*lead, d_in, d_out]``.
    ``quant='ternary_packed'`` stores 2-bit weights packed along d_in (padded
    to a multiple of 4) with a per-column scale, per stacked layer."""
    d_in = w.shape[-2]
    lead = tuple(w.shape[:-2])
    if quant == "ternary_packed":
        t, alpha = ternary_quantize_weights(w, axis=w.ndim - 2)
        k_pad = -(-d_in // 4) * 4
        if k_pad != d_in:
            t = F.pad(t, (0, 0, 0, k_pad - d_in))
        p = {"packed": pack_ternary(t, axis=w.ndim - 2),
             "scale": alpha.reshape(*lead, -1).to(dtype)}
    else:
        p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, w.shape[-1]), dtype=dtype, device=w.device)
    return p


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False, quant: str = "none",
                dtype=torch.float32, lead: Tuple[int, ...] = (), device="cpu"):
    """Create linear params.  ``quant='ternary_packed'`` stores 2-bit weights."""
    w = normal(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in), device)
    return linear_from_weight(w, bias=bias, quant=quant, dtype=dtype)


def linear(p, x: torch.Tensor, *, quant: str = "none", act_quant: str = "none") -> torch.Tensor:
    """y = act_q(x) @ W_q (+ b) under the configured quantization mode."""
    if act_quant == "ternary":
        x = ste_ternary_acts(x, 0.5)
    if quant == "ternary_packed":
        # 2-bit weights expanded on the fly: HBM traffic is uint8/4 per value.
        w = unpack_ternary(p["packed"], axis=0).to(x.dtype)
        w = w[: x.shape[-1], :] if w.shape[0] != x.shape[-1] else w
        y = (x @ w) * p["scale"].to(x.dtype)
    elif quant == "ternary":
        w = ste_ternary_weights(p["w"], 0.7).to(x.dtype)
        y = x @ w
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, *, norm_type: str = "rmsnorm", dtype=torch.float32,
              lead: Tuple[int, ...] = (), device="cpu"):
    p = {"g": torch.ones((*lead, d), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["b"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, *, norm_type: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    if norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["g"].to(torch.float32) + p["b"].to(torch.float32)
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["g"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, partial: float = 1.0, device="cpu") -> torch.Tensor:
    rot_dim = int(head_dim * partial) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, *, partial: float = 1.0
) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int.  Rotates interleaved pairs
    (``0::2``, ``1::2``) of the first ``int(hd * partial)`` (even) dims."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, partial=partial, device=x.device)
    rot_dim = inv.shape[0] * 2
    ang = positions[..., None].to(torch.float32) * inv  # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot_dim].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(*x.shape[:-1], rot_dim)
    if rot_dim < hd:
        rotated = torch.cat([rotated, x[..., rot_dim:].to(torch.float32)], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device="cpu"):
    return {"table": normal(gen, (vocab, d), 0.02, device).to(dtype)}


def embed_lookup(p, ids: torch.Tensor, *, scale: bool = False) -> torch.Tensor:
    x = F.embedding(ids, p["table"])
    if scale:
        x = x * math.sqrt(x.shape[-1])
    return x


def logits_from_embedding(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].to(x.dtype).T
