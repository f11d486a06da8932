"""Step functions: train / prefill / decode, and the input specs of a cell.
Counterpart of `repro.launch.steps`.

The steps are plain Python over trees of tensors (no compilation).  The
train step takes gradients with `torch.autograd.grad` (the reference's
``jax.value_and_grad``); ``make_train_step(..., donate=True)`` is the
counterpart of ``jax.jit(step, donate_argnums=(0,))``: the optimizer writes
params, m, v and the step counter in place and the caller must not reuse the
old state.  With ``donate=False`` the step leaves its input state untouched.
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

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import cache_spec, forward, init_cache, init_params, lm_loss
from repro_torch.models.spmd import microbatch
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


def value_and_grad(cfg: ModelConfig, params, batch: Dict, *, shard=None):
    """``((loss, metrics), grads)`` of `lm_loss` at ``params``: the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``.  ``batch``
    holds tensors on the params' device.  Every grad is a tensor of its own
    (autograd may hand two inputs one tensor, or an expanded one), so a
    donating step may scale it in place; a non-float leaf gets a 0-d float32
    zero."""
    req = [p.detach().requires_grad_() if p.is_floating_point() else p
           for p in tree_leaves(params)]
    loss, metrics = lm_loss(
        tree_unflatten(params, req), cfg, batch["tokens"], batch["targets"],
        frontend_embeds=batch.get("frontend_embeds"), enc_embeds=batch.get("enc_embeds"),
        shard=shard,
    )
    it = iter(torch.autograd.grad(loss, [x for x in req if x.requires_grad],
                                  allow_unused=True, materialize_grads=True))
    grads = [next(it) if x.requires_grad
             else torch.zeros((), dtype=torch.float32, device=x.device) for x in req]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, distinct_grads(grads))


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
        batch = _batch_to(batch, device)
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
            # error feedback keeps the optimizer trajectory unbiased.
            cg, residuals = compress_with_feedback(grads, residuals)
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
    max_len, dtype, device=...)`` (default `init_cache`; the dry-run's lays
    it out by the sharding plan)."""
    max_len = prefill_cache_len(cfg, max_len)
    cache_init = cache_init or init_cache

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache0 = cache_init(cfg, tokens.shape[0], max_len, cache_dtype, device=tokens.device)
        out = forward(
            params, cfg, tokens, mode="prefill", cache=cache0, logits_mode="last",
            frontend_embeds=batch.get("frontend_embeds"),
            enc_embeds=batch.get("enc_embeds"),
            shard=shard,
        )
        return out.logits[:, -1, :], out.cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, shard=None, donate: bool = False) -> Callable:
    """(params, tokens [B,1], cache) -> (logits [B,V], cache).  With
    ``donate=False`` the given cache is left untouched and a new one is
    returned; ``donate=True`` is the counterpart of ``donate_argnums=(2,)``:
    every cache leaf, ``len`` included, is written in place and the returned
    cache is the given one (bit-equal to ``donate=False``)."""

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        if not donate:
            cache = tree_map(torch.clone, cache)
        out = forward(params, cfg, tokens, mode="decode", cache=cache, shard=shard)
        return out.logits[:, 0, :], out.cache

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
