"""Mixture-of-Experts FFN with capacity-based token dispatch.  Counterpart
of `repro.models.moe`.

Routed expert weights carry a leading [E] axis.  Token dispatch is a
scatter into per-expert buffers [B, E, C, D] per batch row (the dispatch
group), every expert runs on its C slots, and a gather combines the
outputs weighted by the renormalized gates.  The capacity is
``int(S * top_k * capacity_factor / E) or 1`` — a floor, as the reference's
code computes it (its module docstring says ceil).

Router: float32 softmax-then-top-k (deepseek style) with renormalized
gates; a Switch-style auxiliary load-balancing loss is returned.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import weights_beside
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, linear, linear_init, normal, silu
from repro_torch.models.spmd import batch_split, is_dtensor, local_block
from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten


def moe_init(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=(), device="cpu"):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    gated = cfg.mlp_type in ("swiglu", "geglu")

    def expert_bank(d_in, d_out):
        return normal(gen, (*lead, e, d_in, d_out), 1.0 / math.sqrt(d_in), device).to(dtype)

    p = {
        "router": linear_init(gen, d, e, quant="none", dtype=torch.float32, lead=lead,
                              device=device),
        "w_up": expert_bank(d, f),
        "w_down": expert_bank(f, d),
    }
    if gated:
        p["w_gate"] = expert_bank(d, f)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        kw = dict(quant=cfg.quant, dtype=dtype, lead=lead, device=device)
        p["shared_up"] = linear_init(gen, d, fs, **kw)
        p["shared_down"] = linear_init(gen, fs, d, **kw)
        if gated:
            p["shared_gate"] = linear_init(gen, d, fs, **kw)
    return p


def _act(cfg, gate, up):
    if cfg.mlp_type == "swiglu":
        return silu(gate) * up
    if cfg.mlp_type == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(up, approximate="tanh")


MOE_SEQ_CHUNK = 1024  # dispatch-group length along the sequence


def moe_forward(p, cfg: ModelConfig, x: torch.Tensor, *,
                shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss).

    The sequence is processed in chunks of MOE_SEQ_CHUNK tokens (one chunk
    when S is not a multiple): capacity is per (batch row x seq chunk)
    group, and the aux loss is the mean over chunks.  With autograd on, each
    of several chunks runs under `torch.utils.checkpoint`, as the
    reference's ``jax.checkpoint`` around its scanned chunk: one chunk's
    dispatch buffers are live in the backward at a time."""
    b, s, d = x.shape
    c = min(MOE_SEQ_CHUNK, s)
    if s % c:
        c = s  # odd lengths: single chunk
    if s == c:
        return _moe_chunk(p, cfg, x, shard)
    n = s // c
    remat = torch.is_grad_enabled()
    ys, auxs = [], []
    for i in range(n):
        xc = x[:, i * c:(i + 1) * c]
        y, aux = (checkpoint(lambda xc: _moe_chunk(p, cfg, xc, shard), xc,
                             use_reentrant=False)
                  if remat else _moe_chunk(p, cfg, xc, shard))
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()


def _moe_chunk(p, cfg: ModelConfig, x: torch.Tensor,
               shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-local dispatch (group = batch row): the position-in-expert is a
    cumsum along the flattened (token, choice) axis of each row.  On
    DTensors the router runs as DTensor ops, and the dispatch, the experts
    and the combine run on each device's batch rows against its shards of
    the experts' d_ff (`models/spmd.local_block`): tokens stay data-sharded,
    the weights are gathered over the data axes (FSDP), and the output is a
    partial sum over the axes that split d_ff, as a row-parallel MLP's."""
    # ---- routing (float32 for numerical stability) ----
    logits = linear(p["router"], x.to(torch.float32))  # [B, S, E]
    experts = {k: v for k, v in p.items() if k != "router"}
    if not is_dtensor(x):
        y, aux, _, _ = _moe_dispatch(experts, cfg, x, logits, shard)
        return y, aux
    xp = batch_split(x)
    ws = tree_leaves(experts)
    tp_dims = tree_leaves(tree_map_with_path(_tp_dim, experts))
    wps = [weights_beside(xp, w, d) for w, d in zip(ws, tp_dims)]
    yp = tuple(xp[i] if xp[i].is_shard() else
               Partial() if any(wp[i].is_shard() for wp in wps) else Replicate()
               for i in range(len(xp)))
    # the aux loss's factors from each device's rows: their mean over the
    # batch shards is the step's (an all-reduce each, as an SPMD partitioner
    # reduces them), and the aux is their product's sum
    mp = tuple(Partial("avg") if q.is_shard() else Replicate() for q in xp)

    def local(x, logits, *ws):
        y, _, me, ce = _moe_dispatch(tree_unflatten(experts, list(ws)), cfg, x, logits, shard)
        return y, me, ce

    y, me, ce = local_block(local, (x, logits, *ws), (xp, xp, *wps), (yp, mp, mp))
    return y, cfg.n_experts * torch.sum(me * ce)


def _tp_dim(path, w) -> int:
    """The tensor-parallel (d_ff) dim of an expert leaf: the banks' F in
    [E, D, F] / [E, F, D], the shared experts' column-parallel output and
    row-parallel input (-1: none)."""
    keys = [k.key for k in path]
    if keys[0] in ("w_up", "w_gate"):
        return 2
    if keys[0] == "w_down":
        return 1
    if keys[0] == "shared_down":
        return 0 if keys[-1] in ("w", "packed") else -1
    return 1 if keys[-1] in ("w", "packed") else 0


def _moe_dispatch(p, cfg: ModelConfig, x: torch.Tensor, logits: torch.Tensor,
                  shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_moe_chunk` from the router logits on: top-k, dispatch, the experts,
    combine and the shared experts.  Returns (y, the Switch aux loss, and
    its factors: the mean router probability per expert [E] and the
    fraction of choices routed to each expert [E])."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)  # [B, S, k], descending
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style aux loss: mean prob per expert * fraction routed per expert
    flat_ids = expert_ids.reshape(b, s * k)                        # [B, S*k]
    # == F.one_hot(flat_ids, e), whose range check reads the ids on the host
    onehot = (flat_ids[..., None] == torch.arange(e, device=x.device)).to(torch.int32)
    me = probs.mean(dim=(0, 1))                                    # [E]
    ce = onehot.sum(dim=(0, 1)).to(torch.float32) / (b * s * k)
    aux = e * torch.sum(me * ce)

    # ---- group-local capacity dispatch (group = batch row) ----
    cap = int(s * k * cfg.capacity_factor / e) or 1
    pos_in_e = torch.cumsum(onehot, dim=1) - 1                     # [B, S*k, E]
    pos = torch.gather(pos_in_e, 2, flat_ids[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos, e * cap)       # overflow -> drop row

    xk = x.repeat_interleave(k, dim=1)                             # [B, S*k, D]
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    # Deterministic although a scatter-add: positions within an expert are
    # distinct (the cumsum), so every kept slot receives exactly one token
    # and holds 0 + x exactly whatever the order; only the overflow row sums
    # several tokens, and it is sliced off below.
    buf.index_put_((rows, slot), xk, accumulate=True)
    expert_in = buf[:, : e * cap].reshape(b, e, cap, d)
    # tokens stay data-sharded; the experts' d_ff shards over "model"
    if shard is not None:
        expert_in = shard(expert_in, "moe_tokens", "moe_experts", None, None)

    # ---- expert FFN (tokens x all experts) ----
    up = einsum("becd,edf->becf", expert_in, p["w_up"].to(expert_in.dtype))
    if "w_gate" in p:
        gate = einsum("becd,edf->becf", expert_in, p["w_gate"].to(expert_in.dtype))
        h = _act(cfg, gate, up)
    else:
        h = _act(cfg, None, up)
    if shard is not None:
        h = shard(h, "moe_tokens", "moe_experts", None, "mlp")
    out = einsum("becf,efd->becd", h, p["w_down"].to(h.dtype))

    # ---- combine (gather per group) ----
    out_b = out.reshape(b, e * cap, d)
    if shard is not None:
        out_b = shard(out_b, "moe_tokens", None, None)
    out_pad = torch.cat([out_b, torch.zeros((b, 1, d), dtype=out_b.dtype, device=x.device)],
                        dim=1)
    gathered = torch.gather(out_pad, 1, slot[..., None].expand(b, s * k, d))  # [B, S*k, D]
    w = (gate_vals.reshape(b, s * k) * keep).to(gathered.dtype)
    y = (gathered * w[..., None]).reshape(b, s, k, d).sum(dim=2)

    # ---- shared experts (deepseek/jamba): always-on dense path ----
    if "shared_up" in p:
        supv = linear(p["shared_up"], x, quant=cfg.quant, act_quant=cfg.act_quant)
        if "shared_gate" in p:
            sg = linear(p["shared_gate"], x, quant=cfg.quant, act_quant=cfg.act_quant)
            sh = _act(cfg, sg, supv)
        else:
            sh = _act(cfg, None, supv)
        y = y + linear(p["shared_down"], sh, quant=cfg.quant, act_quant=cfg.act_quant)

    return y.to(x.dtype), aux, me, ce
