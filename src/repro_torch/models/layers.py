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
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.core.ternary import (
    pack_ternary,
    ste_ternary_acts,
    ste_ternary_weights,
    ternary_quantize_weights,
    unpack_ternary,
)
from repro_torch.launch.sharding import (
    einsum_placements,
    matmul_placements,
    vector_beside,
    weights_beside,
)
from repro_torch.models.spmd import (
    batch_split,
    is_dtensor,
    local_block,
    reshape,
    shard_index,
    sum_over,
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
    float32 computes in float32); `torch.einsum` itself refuses mixed dtypes.
    On DTensors each device contracts its blocks
    (`launch/sharding.einsum_placements`), where DTensor would refuse to flatten
    a sharded batch dim."""
    if is_dtensor(a) and is_dtensor(b):
        ap, bp, op = einsum_placements(eq, a, b)
        return local_block(lambda a, b: einsum(eq, a, b), (a, b), (ap, bp), op)
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
    """y = act_q(x) @ W_q (+ b) under the configured quantization mode.  On
    DTensor params each device multiplies its blocks, laid out as Megatron's
    linears (`launch/sharding.matmul_placements`, a `local_block`): a
    ternary weight takes the whole weight's threshold and scale, a packed
    row-parallel block is unpacked on its own rows, and a row-parallel
    bias is added once to the partial sums."""
    w = p.get("w", p.get("packed"))
    if is_dtensor(w):
        xp, wp, op = matmul_placements(x, w, 0, 1)
        if "packed" in p and 4 * w.shape[0] != x.shape[-1]:
            # the packed rows carry padding past d_in: a row block would not
            # line up with the activation's, so the weight is gathered there
            rows = [q == Shard(0) for q in wp]
            xp, wp, op = (tuple(Replicate() if r else a for r, a in zip(rows, pl))
                          for pl in (xp, wp, op))
        keys = list(p)
        pp = [wp if k in ("w", "packed") else vector_beside(wp, 1) for k in keys]
        mesh = w.device_mesh
        split = [i for i, q in enumerate(wp) if q.is_shard()]
        total = (lambda t: sum_over(t, mesh, split)) if split else None
        coord = mesh.get_coordinate()
        bias_here = all(coord[i] == 0 for i, o in enumerate(op) if o.is_partial())
        return local_block(
            lambda x, *leaves: _linear(dict(zip(keys, leaves)), x, quant, act_quant,
                                       total, w.numel(), bias_here),
            (x, *p.values()), (xp, *pp), op)
    return _linear(p, x, quant, act_quant)


def _linear(p, x, quant, act_quant, total=None, n_total: int = 0, bias: bool = True):
    """`linear` on plain tensors.  On one device's blocks: ``total`` sums
    over the blocks of a weight of ``n_total`` values (`ste_ternary_weights`),
    and ``bias`` is False on the devices whose partial sums take no bias."""
    if act_quant == "ternary":
        x = ste_ternary_acts(x, 0.5)
    if quant == "ternary_packed":
        # 2-bit weights expanded on the fly: HBM traffic is uint8/4 per value.
        w = unpack_ternary(p["packed"], axis=0).to(x.dtype)
        w = w[: x.shape[-1], :] if w.shape[0] != x.shape[-1] else w
        y = (x @ w) * p["scale"].to(x.dtype)
    elif quant == "ternary":
        w = ste_ternary_weights(p["w"], 0.7, total=total, n_total=n_total).to(x.dtype)
        y = x @ w
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        # a device without the bias still adds it times zero: every device
        # runs the same backward (the bias's gradient is a partial sum)
        y = y + (p["b"] if bias else p["b"] * 0.0).to(y.dtype)
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
    rotated = reshape(torch.stack([out1, out2], dim=-1), *x.shape[:-1], rot_dim)
    if rot_dim < hd:
        rotated = torch.cat([rotated, x[..., rot_dim:].to(torch.float32)], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device="cpu"):
    return {"table": normal(gen, (vocab, d), 0.02, device).to(dtype)}


def embed_lookup(p, ids: torch.Tensor, *, scale: bool = False) -> torch.Tensor:
    """The rows of ``p["table"]`` at ``ids``.  On DTensors each device
    looks its batch rows up in its vocabulary shard — the ids shifted by the
    shard's first row, zero rows for ids outside it — and the output is a
    partial sum over the axes that shard the vocabulary, as an SPMD
    partitioner's masked gather (`models/spmd.local_block`)."""
    table = p["table"]
    if is_dtensor(table):
        ip = batch_split(ids)
        tp = weights_beside(ip, table, 0)
        op = tuple(i if i.is_shard() else Partial() if t == Shard(0) else
                   Shard(2) if t == Shard(1) else t for i, t in zip(ip, tp))
        dims = [i for i, t in enumerate(tp) if t == Shard(0)]
        index = shard_index(table.device_mesh, dims)
        x = local_block(lambda ids, t: _embed_rows(ids, t, index * t.shape[0]) if dims
                        else F.embedding(ids, t), (ids, table), (ip, tp), op)
    else:
        x = F.embedding(ids, table)
    if scale:
        x = x * math.sqrt(x.shape[-1])
    return x


def _embed_rows(ids: torch.Tensor, table: torch.Tensor, first: int) -> torch.Tensor:
    """The rows ``ids - first`` of ``table`` (a block of a vocabulary that
    starts at row ``first``); zero rows where an id falls outside it."""
    local = ids - first
    here = (local >= 0) & (local < table.shape[0])
    x = F.embedding(torch.clamp(local, 0, table.shape[0] - 1), table)
    return torch.where(here[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def logits_from_embedding(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ table.T``; on a DTensor table as a column-parallel linear over
    the vocabulary shards (`launch/sharding.matmul_placements`)."""
    table = p["table"]
    if is_dtensor(table):
        xp, tp, op = matmul_placements(x, table, 1, 0)
        return local_block(lambda x, t: x @ t.to(x.dtype).T, (x, table), (xp, tp), op)
    return x @ table.to(x.dtype).T
