"""Unified LM: one model definition covering all 10 assigned architectures.
Counterpart of `repro.models.model`: train-mode logits, prefill and decode,
and the training loss (`lm_loss`, a sequence-chunked cross-entropy).

An architecture is compiled into *segments*: maximal runs of identical layer
structure.  A segment's params are stacked along a leading layer axis,
exactly as the reference's scanned segments hold them, so both packages
share paths and leaf order (`repro_torch.tree`); a Python loop over that
axis takes the place of the reference's ``lax.scan``.  Each stacked leaf is
unbound once per forward (autograd's backward of ``unbind`` is one
``stack``; indexing layer by layer would add a zero tensor of the whole
stacked leaf into its gradient per layer).  With ``cfg.remat`` and autograd
on, each layer runs under `torch.utils.checkpoint` (non-reentrant), the
counterpart of the reference's ``jax.checkpoint`` around the scanned body:
only its input is kept for the backward, which recomputes the layer.
``scan_unroll`` has no counterpart and is ignored.

    dense (qwen/glm/gemma/coder/internvl): [L x {attn + dense-ffn}]
    dbrx:                                  [40 x {attn + moe}]
    deepseek-v2-lite: [1 x {mla + dense}] + [26 x {mla + moe}]
    jamba:            [4 x {7x(mamba+ffn) + 1x(attn+ffn), moe period 2}]
    mamba2:           [48 x {mamba}]
    seamless (enc-dec): encoder [12 x {bidir attn + ffn}] +
                        decoder [12 x {causal attn + cross-attn + ffn}]

Modes: ``train`` (logits of every position), ``prefill`` (fills caches),
``decode`` (one token; O(1)-state for SSM, cache-append for attention).
Decode writes the cache it is given in place — each layer into its slice of
the stacked segment cache, ``len`` advanced by one — and returns that same
cache; `launch.steps.make_decode_step` copies it first unless it donates it.
``shard`` is the activation-constraint function of `launch/sharding.py`,
applied where the reference applies it, with the same logical axis names;
`_noshard` (the default) leaves every activation as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ternary import ste_ternary_weights, unpack_ternary
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import weights_beside
from repro_torch.models.attention import (
    attn_init,
    cross_attention,
    cross_attn_init,
    gqa_cache_spec,
    gqa_forward,
    mla_cache_spec,
    mla_forward,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    embed_init,
    embed_lookup,
    linear,
    linear_init,
    logits_from_embedding,
    norm_init,
    torch_dtype,
    weak_scalar,
)
from repro_torch.models.mamba2 import mamba_forward, mamba_init, mamba_state_spec
from repro_torch.models.mlp import mlp_forward, mlp_init
from repro_torch.models.moe import moe_forward, moe_init
from repro_torch.models.spmd import (
    VocabShards,
    batch_like,
    batch_split,
    is_dtensor,
    local_block,
    replicate,
    stack,
    unbind,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

AUX_LOSS_COEF = 0.01


def _noshard(x, *names):
    return x

# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    n_steps: int
    mixers: Tuple[str, ...]   # per sublayer in one period: attn | mla | mamba
    ffns: Tuple[str, ...]     # dense | moe | none
    causal: bool = True
    cross_attn: bool = False

    @property
    def period(self) -> int:
        return len(self.mixers)


def build_segments(cfg: ModelConfig) -> List[Segment]:
    cross = cfg.is_encdec
    if cfg.is_ssm:
        return [Segment(cfg.n_layers, ("mamba",), ("none",))]
    if cfg.is_hybrid:
        period = cfg.attn_layer_period
        mixers = tuple(
            "attn" if j == cfg.attn_layer_offset else "mamba" for j in range(period)
        )
        ffns = tuple(
            "moe" if (cfg.is_moe and j % cfg.moe_layer_period == 1) else "dense"
            for j in range(period)
        )
        assert cfg.n_layers % period == 0
        return [Segment(cfg.n_layers // period, mixers, ffns)]
    mixer = "mla" if cfg.attn_type == "mla" else "attn"
    if cfg.is_moe:
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment(cfg.first_dense_layers, (mixer,), ("dense",)))
        segs.append(Segment(cfg.n_layers - cfg.first_dense_layers, (mixer,), ("moe",)))
        return segs
    return [Segment(cfg.n_layers, (mixer,), ("dense",), cross_attn=cross)]


def encoder_segments(cfg: ModelConfig) -> List[Segment]:
    return [Segment(cfg.n_enc_layers, ("attn",), ("dense",), causal=False)]


# ---------------------------------------------------------------------------
# Sublayer init / forward
# ---------------------------------------------------------------------------

def _sublayer_init(gen, cfg: ModelConfig, mixer: str, ffn: str, cross: bool, dtype,
                   lead, device):
    kw = dict(lead=lead, device=device)
    nkw = dict(norm_type=cfg.norm_type, dtype=dtype, **kw)
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, **nkw)}
    if mixer == "mamba":
        p["mamba"] = mamba_init(gen, cfg, dtype, **kw)
    else:
        p["attn"] = attn_init(gen, cfg, dtype, **kw)
    if cross:
        p["norm_x"] = norm_init(cfg.d_model, **nkw)
        p["cross"] = cross_attn_init(gen, cfg, dtype, **kw)
    if ffn == "dense":
        p["norm2"] = norm_init(cfg.d_model, **nkw)
        p["mlp"] = mlp_init(gen, cfg, dtype=dtype, **kw)
    elif ffn == "moe":
        p["norm2"] = norm_init(cfg.d_model, **nkw)
        p["moe"] = moe_init(gen, cfg, dtype, **kw)
    return p


def _sublayer_forward(
    p, cfg: ModelConfig, mixer: str, ffn: str, x, positions, *,
    causal=True, cache=None, cache_len=None, enc_out=None, shard=_noshard,
):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["norm1"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    # sequence parallelism ends at the mixer: the sequence is gathered once,
    # before the QKV / SSM projections
    h = shard(h, "batch", None, "embed")
    if mixer == "mamba":
        mix, new_cache = mamba_forward(p["mamba"], cfg, h, state=cache, shard=shard)
    elif mixer == "mla":
        mix, new_cache = mla_forward(
            p["attn"], cfg, h, positions, cache=cache, cache_len=cache_len,
            absorbed_decode=cfg.mla_absorbed, shard=shard,
        )
    else:
        mix, new_cache = gqa_forward(
            p["attn"], cfg, h, positions, causal=causal,
            cache=cache, cache_len=cache_len, shard=shard,
        )
    x = x + mix
    if "cross" in p and enc_out is not None:
        hx = apply_norm(p["norm_x"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        x = x + cross_attention(p["cross"], cfg, hx, enc_out)
    if ffn != "none":
        h2 = apply_norm(p["norm2"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        if ffn == "moe":
            # the dispatch cumsums along the sequence: gather it first
            h2 = shard(h2, "batch", None, "embed")
            y, aux = moe_forward(p["moe"], cfg, h2, shard=shard)
        else:
            y = mlp_forward(p["mlp"], cfg, h2, shard=shard)
        x = x + y
    x = shard(x, "batch", "res_seq", "embed")
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Segment execution (a loop over the stacked layer axis)
# ---------------------------------------------------------------------------

def _segment_init(gen, cfg: ModelConfig, seg: Segment, dtype, device):
    return {
        f"sub{j}": _sublayer_init(gen, cfg, seg.mixers[j], seg.ffns[j], seg.cross_attn,
                                  dtype, (seg.n_steps,), device)
        for j in range(seg.period)
    }


def _segment_cache_spec(cfg: ModelConfig, seg: Segment, batch: int, max_len: int, dtype):
    out = {}
    for j in range(seg.period):
        m = seg.mixers[j]
        if m == "mamba":
            out[f"sub{j}"] = mamba_state_spec(cfg, batch, dtype)
        elif m == "mla":
            out[f"sub{j}"] = mla_cache_spec(cfg, batch, max_len, dtype)
        else:
            out[f"sub{j}"] = gqa_cache_spec(cfg, batch, max_len, dtype)
    return tree_map(
        lambda s: torch.empty((seg.n_steps, *s.shape), dtype=s.dtype, device="meta"), out
    )


def _stack_trees(trees: List[Any]):
    """Per-layer trees of equal structure -> one tree stacked on axis 0."""
    columns = zip(*(tree_leaves(t) for t in trees))
    return tree_unflatten(trees[0], [stack(col) for col in columns])


def _unstack(tree, n: int) -> List[Any]:
    """A tree stacked on axis 0 -> its ``n`` per-layer trees (views)."""
    columns = [unbind(a) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, [col[i] for col in columns]) for i in range(n)]


def _segment_forward(
    seg_params, cfg: ModelConfig, seg: Segment, x, positions, *,
    cache=None, cache_len=None, enc_out=None, shard=_noshard,
):
    def layer(lp, x, aux, cache_in):
        layer_cache = {}
        for j in range(seg.period):
            sub_cache = None if cache_in is None else cache_in.get(f"sub{j}")
            x, c_out, aux_j = _sublayer_forward(
                lp[f"sub{j}"], cfg, seg.mixers[j], seg.ffns[j], x, positions,
                causal=seg.causal, cache=sub_cache, cache_len=cache_len,
                enc_out=enc_out, shard=shard,
            )
            layer_cache[f"sub{j}"] = c_out if c_out is not None else {}
            aux = aux + aux_j
        return x, aux, layer_cache

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches_in = [None] * seg.n_steps if cache is None else _unstack(cache, seg.n_steps)
    new_caches = []
    for lp, cache_in in zip(_unstack(seg_params, seg.n_steps), caches_in):
        if remat:
            x, aux = checkpoint(lambda x, aux, lp=lp: layer(lp, x, aux, None)[:2], x, aux,
                                use_reentrant=False)
        else:
            x, aux, layer_cache = layer(lp, x, aux, cache_in)
            new_caches.append(layer_cache)
    if cache is None:
        return x, None, aux
    if cache_len is not None:
        # decode wrote each layer's cache in place, into its slice (a view)
        # of the stacked segment cache
        return x, cache, aux
    return x, _stack_trees(new_caches), aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                dtype=torch.float32, *, device=None):
    """Random params in the reference's tree layout.  Draws come from
    ``gen`` (on its own device; create it on the card to initialise there)
    and land on ``device`` (default ``"cuda"``; an error without a card).
    On ``torch.device("meta")`` nothing is allocated and ``gen`` is unused:
    the tree gives the shapes and dtypes."""
    device = resolve_device(device)
    if gen is None and device.type != "meta":
        raise ValueError("init_params needs a torch.Generator (or device='meta')")
    segs = build_segments(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=dtype,
                                device=device),
    }
    for i, seg in enumerate(segs):
        params[f"seg{i}"] = _segment_init(gen, cfg, seg, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(
            gen, cfg.d_model, cfg.vocab_size, quant=cfg.quant, dtype=dtype, device=device
        )
    if cfg.is_encdec:
        params["enc"] = {
            "norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=dtype,
                              device=device),
        }
        for i, seg in enumerate(encoder_segments(cfg)):
            params["enc"][f"seg{i}"] = _segment_init(gen, cfg, seg, dtype, device)
    return params


def cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache tree as meta tensors (shapes and dtypes, no storage)."""
    spec: Dict[str, Any] = {
        f"seg{i}": _segment_cache_spec(cfg, seg, batch, max_len, dtype)
        for i, seg in enumerate(build_segments(cfg))
    }
    spec["len"] = torch.empty((), dtype=torch.int32, device="meta")
    if cfg.is_encdec:
        spec["enc_out"] = torch.empty((batch, cfg.enc_seq_len, cfg.d_model), dtype=dtype,
                                      device="meta")
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None):
    """A zero cache on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_spec(cfg, batch, max_len, dtype),
    )


def _encode(params, cfg: ModelConfig, enc_embeds, shard=_noshard):
    x = enc_embeds
    b, s, _ = x.shape
    positions = batch_like(torch.arange(s, device=x.device)[None].expand(b, s), x)
    for i, seg in enumerate(encoder_segments(cfg)):
        x, _, _ = _segment_forward(
            params["enc"][f"seg{i}"], cfg, seg, x, positions, shard=shard
        )
    return apply_norm(params["enc"]["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor
    cache: Optional[dict]
    aux_loss: torch.Tensor


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    frontend_embeds: Optional[torch.Tensor] = None,
    enc_embeds: Optional[torch.Tensor] = None,
    shard=None,
    logits_mode: str = "all",
) -> ModelOutput:
    """tokens: [B, S] integer (S=1 for decode).

    frontend_embeds: [B, P, D] stub patch/frame embeddings (vlm/audio),
    prepended to the token sequence in train/prefill.
    enc_embeds: [B, S_enc, D] stub audio frames for the enc-dec encoder.
    logits_mode: "all" | "last" (prefill wants only the sampling position) |
    "hidden" (return final hidden states in .logits).
    shard: the activation-constraint function (None: `_noshard`).
    """
    shard = shard or _noshard
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, scale=cfg.embed_scale)
    x = x.to(torch_dtype(cfg.dtype))
    n_front = 0
    if frontend_embeds is not None and mode != "decode":
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        n_front = frontend_embeds.shape[1]
    x = shard(x, "batch", "res_seq", "embed")
    seq = x.shape[1]

    enc_out = None
    if cfg.is_encdec:
        if mode == "decode":
            enc_out = cache["enc_out"].to(x.dtype)
        else:
            assert enc_embeds is not None, "enc-dec model needs enc_embeds"
            enc_out = _encode(params, cfg, enc_embeds.to(x.dtype), shard=shard)

    if mode == "decode":
        cache_len = cache["len"]
        positions = cache_len.reshape(1, 1).expand(b, 1)
    else:
        cache_len = None
        positions = batch_like(torch.arange(seq, device=x.device)[None].expand(b, seq), x)

    new_cache = {} if cache is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(build_segments(cfg)):
        seg_cache = None if cache is None else cache[f"seg{i}"]
        x, seg_new, aux = _segment_forward(
            params[f"seg{i}"], cfg, seg, x, positions,
            cache=seg_cache, cache_len=cache_len, enc_out=enc_out, shard=shard,
        )
        aux_total = aux_total + aux
        if new_cache is not None:
            new_cache[f"seg{i}"] = seg_new

    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    if n_front:
        x = x[:, n_front:, :]
    if logits_mode == "hidden":
        logits = x
    else:
        if logits_mode == "last":
            x = x[:, -1:, :]
        if cfg.tie_embeddings:
            logits = logits_from_embedding(params["embed"], x)
        else:
            logits = linear(params["lm_head"], x, quant=cfg.quant)
        if cfg.logit_softcap:
            cap = weak_scalar(cfg.logit_softcap, logits.dtype)
            logits = torch.tanh(logits / cap) * cap
        logits = shard(logits, "batch", "seq", "vocab")

    if mode == "decode":
        cache["len"].add_(1)
        new_cache = cache
    elif new_cache is not None:
        new_cache["len"] = torch.tensor(seq, dtype=torch.int32, device=x.device)
        if cfg.is_encdec:
            new_cache["enc_out"] = enc_out.to(cache["enc_out"].dtype)

    return ModelOutput(logits=logits, cache=new_cache, aux_loss=aux_total)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def _ce_chunk(hidden_c, targets_c, head_w, softcap, vocab=None):
    """CE over one sequence chunk.  hidden_c: [B, c, D]; head_w: [D, V]
    (with ``vocab``, a `VocabShards`, this device's shard of the columns).
    Returns (summed NLL float32, unmasked targets int32)."""
    logits = (hidden_c @ head_w.to(hidden_c.dtype)).to(torch.float32)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask = targets_c >= 0
    tgt = torch.clamp(targets_c, min=0).long()
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    else:
        logz, gold = vocab.logz_gold(logits, tgt)
    return torch.sum((logz - gold) * mask), torch.sum(mask, dtype=torch.int32)


def chunked_ce_loss(hidden, targets, head_w, *, softcap=0.0, chunk: int = 512):
    """Sequence-chunked cross-entropy: the full [B, S, V] logits tensor never
    materializes.  With autograd on, each chunk runs under
    `torch.utils.checkpoint`, so its logits are recomputed in the backward
    instead of kept (a ``gemma-2b`` step at S = 4096 would otherwise keep 8
    chunks of [1, 512, 256000] float32 logits and their softmax).  Returns
    (mean NLL over targets >= 0, their count)."""
    nll, ntok = _ce_sums(hidden, targets, head_w, softcap, chunk)
    return nll / torch.clamp(ntok, min=1), ntok


def _ce_sums(hidden, targets, head_w, softcap, chunk, vocab=None):
    """(summed NLL, count) of `chunked_ce_loss`.  On DTensors each device
    runs its batch rows against its vocabulary shard of ``head_w``
    (`models/spmd.local_block`), the log-normaliser and the target's logit
    all-reduced over the vocabulary shards (`models/spmd.VocabShards`, as
    Megatron's vocab-parallel cross-entropy); both sums come out as partial
    sums over the batch shards."""
    if is_dtensor(hidden):
        hp = batch_split(hidden)
        wp = weights_beside(hp, head_w, 1)
        mesh = hidden.device_mesh
        dims = [i for i, p in enumerate(wp) if p.is_shard()]
        out = tuple(Partial() if p.is_shard() else Replicate() for p in hp)
        return local_block(
            lambda h, t, w: _ce_sums(h, t, w, softcap, chunk,
                                     VocabShards(mesh, dims, w.shape[1]) if dims else None),
            (hidden, targets, head_w), (hp, hp if is_dtensor(targets) else None, wp),
            (out, out))
    b, s, d = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ntok = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(hidden.shape[1] // c):
        args = (hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c], head_w, softcap,
                vocab)
        nll_i, nt_i = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                       else _ce_chunk(*args))
        nll, ntok = nll + nll_i, ntok + nt_i
    return nll, ntok


def lm_loss(
    params, cfg: ModelConfig, tokens, targets, *,
    frontend_embeds=None, enc_embeds=None, shard=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux).  targets: [B, S] integer,
    already shifted by the data pipeline; -1 entries are masked.  Returns
    (loss + AUX_LOSS_COEF * aux, {"loss", "aux", "ntok"}); on DTensors each
    is replicated, a full scalar on every device."""
    out = forward(
        params, cfg, tokens, mode="train", logits_mode="hidden",
        frontend_embeds=frontend_embeds, enc_embeds=enc_embeds, shard=shard,
    )
    head_w = (
        params["embed"]["table"].T if cfg.tie_embeddings else _dense_w(params["lm_head"])
    )
    if cfg.quant == "ternary" and not cfg.tie_embeddings:
        head_w = ste_ternary_weights(head_w, 0.7)
    loss, ntok = chunked_ce_loss(out.logits, targets, head_w, softcap=cfg.logit_softcap)
    total = loss + AUX_LOSS_COEF * out.aux_loss
    # on DTensors: full scalars on every device
    total, loss, aux, ntok = (replicate(v) for v in (total, loss, out.aux_loss, ntok))
    return total, {"loss": loss, "aux": aux, "ntok": ntok}


def _dense_w(p):
    if "w" in p:
        return p["w"]
    w = unpack_ternary(p["packed"], axis=0).to(torch.float32)
    return w * p["scale"].to(torch.float32)[None, :]
