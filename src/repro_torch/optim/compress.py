"""Ternary gradient compression with error feedback (TernGrad-style, +
EF-SGD residuals).  Counterpart of `repro.optim.compress`.

Each float gradient leaf (plus its residual) becomes {-1, 0, +1} trits at
``|x| > scale / 2`` with ``scale = mean|x|``, packed 4 per byte, and one
float32 least-squares scale ``alpha = <x, t> / max(<t, t>, 1)``: 2 bits per
value on the wire instead of 32.  What the trits miss is kept as the next
step's residual, so the optimizer's trajectory stays unbiased.

    cg, residuals = compress_with_feedback(grads, residuals)
    grads_hat = decompress(cg, grads)     # what the optimizer consumes

Non-float and 0-d leaves pass through untouched.  With ``donate=True`` the
new residuals are written into the given ones (the counterpart of a jitted
step that donates its whole state), so a captured step finds them where it
left them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ternary import pack_ternary, unpack_ternary
from repro_torch.models.spmd import like, shard_dims, sum_over, to_local
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class CompressedGrad(NamedTuple):
    packed: torch.Tensor   # uint8, flat [ceil(n/4)]
    scale: torch.Tensor    # float32 scalar
    n: int                 # original element count


def _is_compressed(x) -> bool:
    return isinstance(x, CompressedGrad)


def _compress_leaf(g: torch.Tensor, residual: torch.Tensor, total=None,
                   n_total: int = 0, donate: bool = False
                   ) -> Tuple[CompressedGrad, torch.Tensor]:
    """One leaf's trits, scale and new residual (with ``donate`` written
    into ``residual``, which is returned).  With ``total`` (a sum over the
    other blocks of a leaf split across devices) ``g`` and ``residual`` are
    this device's blocks of a leaf of ``n_total`` values: the scale and
    alpha are the whole leaf's, the trits and the residual this block's."""
    gf = g.to(torch.float32) + residual
    flat = gf.reshape(-1)
    n = flat.shape[0]
    if total is None:
        scale = torch.mean(torch.abs(flat)) + 1e-12
    else:
        scale = total(torch.sum(torch.abs(flat))) / n_total + 1e-12
    # deterministic ternarization at threshold = scale/2
    t = torch.where(torch.abs(flat) > 0.5 * scale, torch.sign(flat), 0.0)
    # alpha = <g, t> / <t, t>  (least-squares optimal scale for this support)
    if total is None:
        tt = torch.clamp(torch.sum(t * t), min=1.0)
        alpha = torch.sum(flat * t) / tt
    else:
        sums = total(torch.stack([torch.sum(t * t), torch.sum(flat * t)]))
        alpha = sums[1] / torch.clamp(sums[0], min=1.0)
    new_residual = (gf - (alpha * t).reshape(gf.shape)).to(residual.dtype)
    if donate:
        new_residual = residual.copy_(new_residual)
    tp = F.pad(t.to(torch.int8), (0, (-n) % 4))
    return CompressedGrad(pack_ternary(tp, axis=0), alpha.to(torch.float32), n), new_residual


def _decompress_leaf(c: CompressedGrad, shape, dtype) -> torch.Tensor:
    t = unpack_ternary(c.packed, axis=0).to(torch.float32)[: c.n]
    return (c.scale * t).reshape(shape).to(dtype)


def init_residuals(params) -> Any:
    """Zero float32 residuals like ``params`` (a 0-d zero for a non-float
    leaf)."""
    return tree_map(
        lambda p: torch.zeros(p.shape if p.is_floating_point() else (), dtype=torch.float32,
                              device=p.device),
        params,
    )


def compress_with_feedback(grads, residuals, *, donate: bool = False):
    """Returns (compressed tree, new residuals).  Non-float and 0-d leaves
    pass through untouched.  A DTensor leaf is compressed block by block
    with the whole leaf's scale and alpha (each sum all-reduced over the
    mesh dims that split it), its residual kept per block: the numbers of
    the leaf compressed whole.  With ``donate`` every new residual is
    written into its old tensor and the returned tree holds the given
    tensors (the same bits as without)."""
    comp, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        if not g.is_floating_point() or g.ndim == 0:
            comp.append(g)
            new_r.append(r)
            continue
        dims = shard_dims(g)
        total = (None if not dims
                 else lambda t, g=g, dims=dims: sum_over(t, g.device_mesh, dims))
        c, nr = _compress_leaf(to_local(g), to_local(r), total, g.numel(), donate)
        comp.append(c)
        new_r.append(r if donate else like(r, nr))
    return tree_unflatten(grads, comp), tree_unflatten(residuals, new_r)


def decompress(compressed, grads_like):
    """The dense gradients ``compressed`` stands for, in ``grads_like``'s
    shapes, dtypes and (for DTensors) placements."""
    out = [
        like(g, _decompress_leaf(c, to_local(g).shape, g.dtype)) if _is_compressed(c) else c
        for c, g in zip(tree_leaves(compressed, _is_compressed), tree_leaves(grads_like))
    ]
    return tree_unflatten(grads_like, out)


def wire_bytes(grads) -> Tuple[int, int]:
    """(float32 bytes, compressed bytes) of ``grads`` on the wire: 2 bits
    per value plus a 4-byte scale per leaf."""
    leaves = tree_leaves(grads)
    return (sum(x.numel() * 4 for x in leaves),
            sum(-(-x.numel() // 4) + 4 for x in leaves))
