"""Step functions: train / prefill / decode, and the input specs of a cell.
Counterpart of `repro.launch.steps`.

The steps are plain Python over trees of tensors (no compilation).  The
train step takes gradients with `torch.autograd.grad` (the reference's
``jax.value_and_grad``); ``make_train_step(..., donate=True)`` is the
counterpart of ``jax.jit(step, donate_argnums=(0,))``: the optimizer writes
params, m, v and the step counter in place, gradient compression its
residuals, so every leaf of the state keeps its address (what
`repro_torch.capture.CapturedStep` needs to capture the step), and the
caller must not reuse the old state.  With ``donate=False`` the step leaves
its input state untouched.
The serving steps run without autograd; ``make_decode_step(..., donate=True)`` is the
counterpart of ``jax.jit(decode, donate_argnums=(2,))``: the cache is written
in place (its addresses never change, so `repro_torch.capture.CapturedStep`
can capture the step), and without ``donate`` the step returns a new cache.

``train_state_specs`` and ``input_specs`` build on the meta device: shapes
and dtypes, no allocation.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import cache_spec, forward, init_cache, init_params, lm_loss
from repro_torch.models.spmd import microbatch, replicate, replicated_context, to_local
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    distinct_grads,
)
from repro_torch.optim.compress import compress_with_feedback, decompress, init_residuals
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    """params, AdamW state and the optional ternary grad-compression
    residuals.  A NamedTuple, so `repro_torch.tree` walks it in the leaf
    order of the reference's ``TrainState`` dataclass and checkpoints cross
    packages."""
    params: Any
    opt: AdamWState
    residuals: Any = None


def make_train_state(cfg: ModelConfig, gen: Optional[torch.Generator], *,
                     compress: bool = False, device=None) -> TrainState:
    """float32 params drawn from ``gen`` on ``device`` (default ``"cuda"``),
    zero AdamW moments and, with ``compress``, zero residuals."""
    params = init_params(cfg, gen, dtype=torch.float32, device=device)
    return TrainState(
        params=params,
        opt=adamw_init(params),
        residuals=init_residuals(params) if compress else None,
    )


def train_state_specs(cfg: ModelConfig, *, compress: bool = False) -> TrainState:
    """The TrainState as meta tensors (shapes and dtypes, no storage)."""
    return make_train_state(cfg, None, compress=compress, device="meta")


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (`LMTokenPipeline`) or tensors, on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree`` (None: plain)."""
    return next((x.device_mesh for x in tree_leaves(tree) if isinstance(x, DTensor)), None)


def place_batch(batch: Dict, mesh, shard=None) -> Dict:
    """A batch of plain tensors (the same on every device) laid out beside
    params on ``mesh``: each leaf replicated, then placed on the plan's
    batch axes by ``shard`` (a local cut, no collective).  A DTensor leaf is
    kept as it is; with ``mesh`` None the batch is returned unchanged."""
    if mesh is None:
        return batch

    def one(v):
        if isinstance(v, DTensor):
            return v
        v = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return shard(v, "batch", *[None] * (v.ndim - 1)) if shard is not None else v

    return {k: one(v) for k, v in batch.items()}


def full(x) -> torch.Tensor:
    """A step's output as a plain tensor, the same on every device: a
    DTensor gathered whole; a plain tensor as it is."""
    return to_local(replicate(x))


def _logits_out(logits):
    """The logits a serving step returns: whole on every device (`full`);
    on a planned mesh's fake process group (`launch.mesh.fake_device_mesh`)
    as the step left them, as the reference's out_shardings keep them in
    the dry-run (no caller reads them there)."""
    if isinstance(logits, DTensor) and dist.get_backend(
            logits.device_mesh.get_group(0)) == "fake":
        return logits
    return full(logits)


def value_and_grad(cfg: ModelConfig, params, batch: Dict, *, shard=None):
    """``((loss, metrics), grads)`` of `lm_loss` at ``params``: the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``.  ``batch``
    holds tensors on the params' device.  Every grad is a tensor of its own
    (autograd may hand two inputs one tensor, or an expanded one), so a
    donating step may scale it in place; a non-float leaf gets a 0-d float32
    zero.  On DTensor params every grad is laid out as its param (a partial
    sum over the batch shards is all-reduced, or reduce-scattered onto a
    sharded param: the gradient of the whole batch's mean loss), and the
    loss and metrics are plain full scalars."""
    req = [p.detach().requires_grad_() if p.is_floating_point() else p
           for p in tree_leaves(params)]
    with replicated_context():
        loss, metrics = lm_loss(
            tree_unflatten(params, req), cfg, batch["tokens"], batch["targets"],
            frontend_embeds=batch.get("frontend_embeds"), enc_embeds=batch.get("enc_embeds"),
            shard=shard,
        )
        it = iter(torch.autograd.grad(loss, [x for x in req if x.requires_grad],
                                      allow_unused=True, materialize_grads=True))
        grads = [_as_param(next(it), x) if x.requires_grad
                 else torch.zeros((), dtype=torch.float32, device=x.device) for x in req]
    metrics = {k: to_local(v.detach()) for k, v in metrics.items()}
    return (to_local(loss.detach()), metrics), tree_unflatten(params, distinct_grads(grads))


def _as_param(g, p):
    """A gradient laid out as its DTensor param ``p`` (plain: as it is)."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    shard=None,
    compress_grads: bool = False,
    accum_steps: int = 1,
    donate: bool = False,
) -> Callable:
    """(state, batch) -> (state, metrics).  batch keys: tokens, targets
    [, frontend_embeds, enc_embeds], numpy arrays or tensors; the step moves
    them to the params' device.  ``accum_steps > 1`` splits the batch into
    that many micro-batches (rows ``i*B/n .. (i+1)*B/n``), sums their
    float32 grads and divides.  Metrics: ``{"loss", "aux"}`` (``{"loss"}``,
    the mean total loss, when accumulating), then AdamW's ``lr`` and
    ``grad_norm``.  ``shard`` is the shard function of
    `launch/sharding.py` (the identity on one device)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = tree_leaves(state.params)[0].device
        batch = place_batch(_batch_to(batch, device), _mesh_of(state.params), shard)
        if accum_steps > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) if p.is_floating_point()
                   else torch.zeros((), dtype=torch.float32, device=device)
                   for p in tree_leaves(state.params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum_steps):
                mb = {k: microbatch(v, accum_steps, i) for k, v in batch.items()}
                (loss, _), g = value_and_grad(cfg, state.params, mb, shard=shard)
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi)
                loss_sum = loss_sum + loss
            grads = tree_unflatten(state.params, [a.div_(accum_steps) for a in acc])
            metrics = {"loss": loss_sum / accum_steps}
        else:
            (_, m), grads = value_and_grad(cfg, state.params, batch, shard=shard)
            metrics = {"loss": m["loss"], "aux": m["aux"]}

        residuals = state.residuals
        if compress_grads:
            # ternary-compress before the DP all-reduce (16x wire reduction);
            # error feedback keeps the optimizer trajectory unbiased.  On
            # DTensors the reduced gradients are compressed (the reference's
            # numbers), each block with the whole leaf's scale.
            cg, residuals = compress_with_feedback(grads, residuals, donate=donate)
            grads = decompress(cg, grads)

        new_params, new_opt, om = adamw_update(opt_cfg, state.params, grads, state.opt,
                                               donate=donate)
        metrics.update(om)
        return TrainState(params=new_params, opt=new_opt, residuals=residuals), metrics

    return train_step


def prefill_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Cache length for prefill: tokens + stub frontend patches (vlm)."""
    return seq_len + (cfg.frontend_seq if cfg.frontend == "vision" else 0)


def make_prefill_step(cfg: ModelConfig, max_len: int, *, shard=None,
                      cache_dtype=torch.bfloat16,
                      cache_init: Optional[Callable] = None) -> Callable:
    """(params, batch) -> (last_logits [B,V], cache).  Builds the cache
    in-step, on the device of ``batch["tokens"]``: ``cache_init(cfg, batch,
    max_len, dtype, device=...)`` (default `init_cache`; on a mesh
    `ShardingRules.cache_init` lays it out by the sharding plan).  On DTensor
    params the batch may be plain (`place_batch` lays it out), and the
    logits come back whole on every device."""
    max_len = prefill_cache_len(cfg, max_len)
    cache_init = cache_init or init_cache

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = place_batch(batch, _mesh_of(params), shard)
        tokens = batch["tokens"]
        cache0 = cache_init(cfg, tokens.shape[0], max_len, cache_dtype, device=tokens.device)
        with replicated_context():
            out = forward(
                params, cfg, tokens, mode="prefill", cache=cache0, logits_mode="last",
                frontend_embeds=batch.get("frontend_embeds"),
                enc_embeds=batch.get("enc_embeds"),
                shard=shard,
            )
            return _logits_out(out.logits[:, -1, :]), out.cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, shard=None, donate: bool = False) -> Callable:
    """(params, tokens [B,1], cache) -> (logits [B,V], cache).  With
    ``donate=False`` the given cache is left untouched and a new one is
    returned; ``donate=True`` is the counterpart of ``donate_argnums=(2,)``:
    every cache leaf, ``len`` included, is written in place and the returned
    cache is the given one (bit-equal to ``donate=False``).  On DTensor
    params and cache the tokens may be plain (the same on every device), and
    the logits come back whole on every device."""

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        if not donate:
            cache = tree_map(torch.clone, cache)
        tokens = place_batch({"tokens": tokens}, _mesh_of(params), shard)["tokens"]
        with replicated_context():
            out = forward(params, cfg, tokens, mode="decode", cache=cache, shard=shard)
            return _logits_out(out.logits[:, 0, :]), out.cache

    return decode_step


# ---------------------------------------------------------------------------
# Input specs (the dry-run contract)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of this cell's step.

    train:   {batch: {tokens, targets [, frontend_embeds, enc_embeds]}}
    prefill: {batch: {tokens [, ...]}}
    decode:  {tokens: [B, 1], cache: <full cache at seq_len>}
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    extras: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        extras["frontend_embeds"] = spec((b, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        extras["enc_embeds"] = spec((b, cfg.enc_seq_len, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        return {"batch": {"tokens": spec((b, s), torch.int32),
                          "targets": spec((b, s), torch.int32), **extras}}
    if shape.kind == "prefill":
        return {"batch": {"tokens": spec((b, s), torch.int32), **extras}}
    # decode: one new token against a full cache of length seq_len
    return {"tokens": spec((b, 1), torch.int32),
            "cache": cache_spec(cfg, b, s, cache_dtype)}
