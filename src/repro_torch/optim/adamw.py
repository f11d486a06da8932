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

Every function returns new tensors and leaves its inputs untouched, so a
train state can be checkpointed or compared at any step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

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
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


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
    cfg: AdamWConfig, params, grads, state: AdamWState
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step: ``(new params, new state, {"lr", "grad_norm"})``."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v  # frozen (packed) weights
        gf = g.to(torch.float32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        upd_ = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        pf = p.to(torch.float32)
        p_new = pf - lr * (upd_ + wd * pf)
        return p_new.to(p.dtype), m_new, v_new

    out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), {"lr": lr, "grad_norm": gn}
