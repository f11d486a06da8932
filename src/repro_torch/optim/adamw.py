"""AdamW + LR schedule + global-norm clipping on trees of tensors.
Counterpart of `repro.optim.adamw`.

Plain functions over the params tree (dicts, lists and tensors), not
`torch.optim.AdamW`, because the reference's update differs from it:

  * gradients are clipped by their global norm first;
  * ``step`` is an int32 scalar tensor inside the state;
  * the bias corrections ``1 - b**step`` are computed in float32;
  * the update is ``(m / b1c) / (sqrt(v / b2c) + eps)``, with decoupled
    weight decay only on leaves with ``ndim >= 2``, at a linear-warmup then
    cosine learning rate that decays to ``min_lr_frac * lr``.

On DTensors (a train state laid out by `launch/sharding.py`) every leaf's
update runs on each device's block; only the clipping norm crosses devices.

Every function returns new tensors and leaves its inputs untouched, so a
train state can be checkpointed or compared at any step — except
``adamw_update(..., donate=True)``, the counterpart of a jitted step that
donates its state: it scales the gradients and writes params, m, v and the
step counter in place, by the same operations in the same order, so its
results are the same bits.  A full-width LM state (params + m + v) is three
times the params; without donation the old and the new state would be alive
at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.spmd import like, shard_dims, sum_over, to_local
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr (float32)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf of ``tree`` together.  Of DTensor leaves each
    device squares and sums its blocks, and the sums of leaves sharded over
    the same mesh dims are all-reduced over them once: the norm of the
    whole (global) tree, a plain tensor, the same on every device."""
    leaves = tree_leaves(tree)
    sq = [torch.sum(torch.square(to_local(x).to(torch.float32))) for x in leaves]
    groups: dict = {}
    for x, s in zip(leaves, sq):
        groups.setdefault(shard_dims(x), []).append(s)
    if list(groups) == [()]:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    mesh = next(x.device_mesh for x in leaves if shard_dims(x))
    total = sum(sum_over(torch.sum(torch.stack(ss)), mesh, dims)
                for dims, ss in groups.items())
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, *, donate: bool = False):
    """``(grads scaled to a global norm <= max_norm, the norm)``; with
    ``donate`` the grads are scaled in place.  DTensor grads are scaled
    block by block."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    if donate:
        return tree_map(lambda g: like(g, to_local(g).mul_(scale)), grads), gn
    return tree_map(lambda g: like(g, (to_local(g) * scale).to(g.dtype)), grads), gn


def distinct_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """``grads`` with every tensor its own contiguous storage: autograd may
    hand two inputs one tensor, or an expanded one, and a donating update
    scales each gradient in place."""
    seen, out = set(), []
    for g in grads:
        block = to_local(g)
        if block.untyped_storage().data_ptr() in seen or not block.is_contiguous():
            g = like(g, block.clone(memory_format=torch.contiguous_format))
            block = to_local(g)
        seen.add(block.untyped_storage().data_ptr())
        out.append(g)
    return out


def adamw_init(params) -> AdamWState:
    """Zero moments like ``params`` — float32, and a scalar zero for a
    non-float leaf (frozen packed weights take no update)."""
    def mom(p):
        if p.is_floating_point():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros((), dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(mom, params),
        v=tree_map(mom, params),
    )


def adamw_update(
    cfg: AdamWConfig, params, grads, state: AdamWState, *, donate: bool = False
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step: ``(new params, new state, {"lr", "grad_norm"})``.
    With ``donate`` the grads, params, m, v and the step counter are
    overwritten and the returned trees hold the same tensors (bit-equal to
    ``donate=False``), so a captured step finds its state where it left it.
    On DTensors (params, grads, m and v laid out alike) each device updates
    its own blocks; the clipping norm is the global one."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, donate=donate)
    step_block = to_local(state.step)
    step_block = step_block.add_(1) if donate else step_block + 1
    step = state.step if donate else like(state.step, step_block)
    lr = lr_schedule(cfg, step_block)
    b1c = 1 - cfg.b1 ** step_block.to(torch.float32)
    b2c = 1 - cfg.b2 ** step_block.to(torch.float32)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v  # frozen (packed) weights
        if isinstance(p, DTensor) and (g.placements != p.placements
                                       or m.placements != p.placements):
            raise ValueError(f"a parameter placed {p.placements} with its gradient "
                             f"placed {g.placements} and moments {m.placements}")
        pb, mb, vb = to_local(p), to_local(m), to_local(v)
        gf = to_local(g).to(torch.float32)
        if donate:
            m_new = mb.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v_new = vb.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        else:
            m_new = cfg.b1 * mb + (1 - cfg.b1) * gf
            v_new = cfg.b2 * vb + (1 - cfg.b2) * gf * gf
        upd_ = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        pf = pb.to(torch.float32)
        p_new = pf - lr * (upd_ + wd * pf)
        if donate:
            pb.copy_(p_new)
            return p, m, v
        return like(p, p_new.to(p.dtype)), like(m, m_new), like(v, v_new)

    out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), {"lr": lr, "grad_norm": gn}
