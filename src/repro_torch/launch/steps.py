"""Step functions for LM serving: prefill and decode.  Counterpart of the
serving half of `repro.launch.steps` (``prefill_cache_len``,
``make_prefill_step``, ``make_decode_step``); the train state and step come
with the training slice.

The steps run without autograd.  They are plain Python over tensors (no
compilation), so the reference's donation of the decode cache has no
counterpart: a decode step returns a new cache tree.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_cache


def prefill_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Cache length for prefill: tokens + stub frontend patches (vlm)."""
    return seq_len + (cfg.frontend_seq if cfg.frontend == "vision" else 0)


def make_prefill_step(cfg: ModelConfig, max_len: int, *, shard=None,
                      cache_dtype=torch.bfloat16) -> Callable:
    """(params, batch) -> (last_logits [B,V], cache).  Builds the cache
    in-step, on the device of ``batch["tokens"]``."""
    max_len = prefill_cache_len(cfg, max_len)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache0 = init_cache(cfg, tokens.shape[0], max_len, cache_dtype, device=tokens.device)
        out = forward(
            params, cfg, tokens, mode="prefill", cache=cache0, logits_mode="last",
            frontend_embeds=batch.get("frontend_embeds"),
            enc_embeds=batch.get("enc_embeds"),
            shard=shard,
        )
        return out.logits[:, -1, :], out.cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, shard=None) -> Callable:
    """(params, tokens [B,1], cache) -> (logits [B,V], cache)."""

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        out = forward(params, cfg, tokens, mode="decode", cache=cache, shard=shard)
        return out.logits[:, 0, :], out.cache

    return decode_step
