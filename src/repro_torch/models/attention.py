"""Attention: GQA/MQA/MHA with RoPE + KV cache, chunked (online-softmax)
prefill path, and DeepSeek-style MLA (Multi-head Latent Attention).
Counterpart of `repro.models.attention` (inference: no custom backward).

The chunked path keeps the score matrix at [.., q_chunk, kv_chunk], so a
long prefill never materializes an S x S score tensor; it is taken for
causal S >= 4096 and encoder S >= 2048, as in the reference.  Decode writes
the new position into the cache it is given, in place, at the device index
``cache_len`` (the reference's masked select writes the same values into a
new cache; `launch.steps.make_decode_step` copies the cache first unless it
donates it), and reads it with a masked softmax.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    einsum,
    linear,
    linear_init,
    meta,
    weak_scalar,
)
from repro_torch.models.spmd import batch_like, batch_split, is_dtensor, local_block, reshape

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=(), device="cpu"):
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(quant=cfg.quant, dtype=dtype, lead=lead, device=device)
    if cfg.attn_type == "mla":
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        p = {
            "w_dkv": linear_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw),
            "w_uk": linear_init(gen, cfg.kv_lora_rank, h * cfg.qk_nope_head_dim, **kw),
            "w_uv": linear_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim, **kw),
            "wo": linear_init(gen, h * cfg.v_head_dim, d, **kw),
            "ckv_norm": {"g": torch.ones((*lead, cfg.kv_lora_rank), dtype=dtype,
                                         device=device)},
        }
        if cfg.q_lora_rank:
            p["w_dq"] = linear_init(gen, d, cfg.q_lora_rank, **kw)
            p["w_uq"] = linear_init(gen, cfg.q_lora_rank, h * qk_dim, **kw)
        else:
            p["wq"] = linear_init(gen, d, h * qk_dim, **kw)
        return p
    return {
        "wq": linear_init(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, h * hd, d, **kw),
    }


# ---------------------------------------------------------------------------
# Core softmax-attention paths
# ---------------------------------------------------------------------------

def _gqa_scores_full(q, k, scale):
    """q: [B,Sq,KV,G,hd], k: [B,Skv,KV,hd] -> [B,KV,G,Sq,Skv]."""
    s = einsum("bqkgd,bskd->bkgqs", q, k)
    return s * weak_scalar(scale, s.dtype)


def full_attention(q, k, v, mask, scale):
    """Reference full-materialization path (short sequences).

    q: [B, Sq, H, hd] with H = KV*G; k,v: [B, Skv, KV, hd];
    mask: broadcastable to [B, 1, 1, Sq, Skv] (True = attend).  On DTensors
    each device attends its batch rows and heads (`_per_device_heads`).
    """
    if is_dtensor(q):
        return _per_device_heads(lambda q, k, v, mask: full_attention(q, k, v, mask, scale),
                                 q, k, v, mask)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = _gqa_scores_full(qg, k, scale).to(torch.float32)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dv)


def chunked_causal_attention(q, k, v, scale, *, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash attention wrapper: [B,S,H,hd] x [B,S,KV,hd] -> [B,S,H,dv]."""
    return _grouped_flash(q, k, v, scale, q_chunk, kv_chunk, causal=True)


def _grouped_flash(q, k, v, scale, q_chunk: int = 1024, kv_chunk: int = 1024, *,
                   causal: bool):
    """Flash attention of [B,S,H,hd] queries in KV groups over [B,Sk,KV,hd]
    keys and values -> [B,S,H,dv]; on DTensors per device's batch rows and
    heads (`_per_device_heads`)."""
    if is_dtensor(q):
        return _per_device_heads(
            lambda q, k, v: _grouped_flash(q, k, v, scale, q_chunk, kv_chunk, causal=causal),
            q, k, v)
    b, sq, h, hd = q.shape
    qg = q.reshape(b, sq, k.shape[2], h // k.shape[2], hd)
    o = flash_attention(qg, k, v, scale, q_chunk, kv_chunk, causal)
    return o.reshape(b, sq, h, v.shape[-1])


def _per_device_heads(fn, q, k, v, mask=None):
    """``fn(q, k, v[, mask])`` of [B,Sq,H,d] queries over [B,Sk,KV,d] keys
    and values, run on each device's batch rows and heads
    (`models/spmd.local_block`), as an SPMD partitioner splits attention:
    where the mesh dim that shards the heads divides the KV heads too, the
    keys split with them; where it is a multiple of the KV heads, each
    device's heads lie in one KV group and it attends with that group (its
    block of keys and values is the group's); any other shard of the queries
    is gathered first.  The output is placed as the queries."""
    kvh, g = k.shape[2], q.shape[2] // k.shape[2]
    qp, kp = [], []
    for i, p in enumerate(q.placements):
        n = q.device_mesh.size(i)
        if p == Shard(0) or (p == Shard(2) and kvh % n == 0):
            qp.append(p), kp.append(p)
        elif p == Shard(2) and n % kvh == 0:
            qp.append(p), kp.append(Replicate())
        else:
            qp.append(Replicate()), kp.append(Replicate())
    qp, kp = tuple(qp), tuple(kp)

    def local(q, k, v, *mask):
        groups = max(1, q.shape[2] // g)
        return fn(q, k[:, :, :groups], v[:, :, :groups], *mask)

    if mask is None:
        return local_block(local, (q, k, v), (qp, kp, kp), qp)
    mp = None
    if mask.shape[0] > 1:
        mask = mask if is_dtensor(mask) else batch_like(mask, q)
        mp = tuple(p if p == Shard(0) else Replicate() for p in qp)
    return local_block(local, (q, k, v, mask), (qp, kp, kp, mp), qp)


def _dynamic_slice_seq(x, start: int, size: int):
    """``x[:, start:start+size]`` with the start clamped into range, as the
    reference's ``dynamic_slice_in_dim`` clamps it."""
    start = max(0, min(start, x.shape[1] - size))
    return x[:, start:start + size]


def _chunked_reference(q, k, v, scale, *, q_chunk: int = 2048, kv_chunk: int = 2048):
    """Naive online-softmax attention — test oracle only.  Like the
    reference's it needs S % kv_chunk == 0 (its kv slices clamp)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    n_q = -(-sq // q_chunk)
    outs = []
    for i in range(n_q):
        q0 = i * q_chunk
        cq = min(q_chunk, sq - q0)
        qi = q[:, q0:q0 + cq].reshape(b, cq, kvh, g, hd)
        q_pos = q0 + torch.arange(cq, device=q.device)
        n_kv = -(-min((i + 1) * q_chunk, sq) // kv_chunk)
        m = torch.full((b, kvh, g, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, cq, dv), dtype=torch.float32, device=q.device)
        for j in range(n_kv):
            k0 = j * kv_chunk
            kj = _dynamic_slice_seq(k, k0, kv_chunk)
            vj = _dynamic_slice_seq(v, k0, kv_chunk)
            s = einsum("bqkgd,bskd->bkgqs", qi, kj).to(torch.float32) * scale
            kv_pos = k0 + torch.arange(kv_chunk, device=q.device)
            causal = q_pos[:, None] >= kv_pos[None, :]
            valid = kv_pos[None, :] < sq
            s = torch.where(causal & valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum(
                "bkgqs,bskd->bkgqd", p.to(vj.dtype), vj
            ).to(torch.float32)
            m = m_new
        oi = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(oi.permute(0, 3, 1, 2, 4).reshape(b, cq, h, dv))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, cache_len, scale, shard=None):
    """Single-token attention over the cache.

    q: [B, H, hd]; caches: [B, S, KV, hd]; cache_len: scalar or [B] —
    number of valid positions (the rest is masked out of the softmax).
    The cache sequence axis is sharded over "model"; as the reference's,
    the constraints pin the flash-decode schedule: the scores stay
    seq-sharded, and the softmax max/sum and the PV partial outputs are what
    cross the wire.
    """
    b, s, kvh, hd = k_cache.shape
    h = q.shape[1]
    g = h // kvh
    qg = reshape(q, b, kvh, g, hd)
    scores = einsum("bkgd,bskd->bkgs", qg, k_cache).to(torch.float32) * scale
    if shard is not None:
        scores = shard(scores, "batch", None, None, "cache_seq")
    pos = torch.arange(s, device=q.device)
    n_valid = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None] < n_valid  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if shard is not None:
        p = shard(p, "batch", None, None, "cache_seq")
    o = einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    if shard is not None:
        o = shard(o, "batch", None, None, None)
    return reshape(o, b, h, hd)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_forward(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cache: Optional[dict] = None,
    cache_len=None,
    shard=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, S, D].  Returns (out [B,S,D], updated cache or None).

    Prefill (cache given, S>1): fills a copy's cache[0:S], returns it.
    Decode (cache given, S==1): writes position cache_len of the given cache
    in place, reads cache[:cache_len + 1], returns the given cache.
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    q = reshape(linear(p["wq"], x, quant=cfg.quant, act_quant=cfg.act_quant), b, s, h, hd)
    k = reshape(linear(p["wk"], x, quant=cfg.quant, act_quant=cfg.act_quant), b, s, kvh, hd)
    v = reshape(linear(p["wv"], x, quant=cfg.quant, act_quant=cfg.act_quant), b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta, partial=cfg.partial_rotary_factor)
    k = apply_rope(k, positions, cfg.rope_theta, partial=cfg.partial_rotary_factor)
    if shard is not None:
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)

    new_cache = None
    if cache is not None and s == 1:
        # ---- decode: append then attend over the cache ----
        idx = torch.as_tensor(cache_len, device=x.device).reshape(())
        _cache_write_(cache["k"], k, idx)
        _cache_write_(cache["v"], v, idx)
        o = decode_attention(q[:, 0], cache["k"], cache["v"], idx + 1, scale, shard=shard)
        o = reshape(o, b, 1, h * hd)
        new_cache = cache
    else:
        if causal:
            if s >= 4096:
                o = chunked_causal_attention(q, k, v, scale)
            else:
                mask = (positions[:, :, None] >= positions[:, None, :])[:, None, None]
                o = full_attention(q, k, v, mask, scale)
        else:
            if s >= 2048:
                # encoder self-attention at long S: non-causal flash
                o = _grouped_flash(q, k, v, scale, causal=False)
            else:
                mask = torch.ones((b, 1, 1, s, s), dtype=torch.bool, device=x.device)
                o = full_attention(q, k, v, mask, scale)
        o = reshape(o, b, s, h * hd)
        if cache is not None:
            kc = _cache_fill(cache["k"], k)
            vc = _cache_fill(cache["v"], v)
            new_cache = {"k": kc, "v": vc}
    out = linear(p["wo"], o, quant=cfg.quant, act_quant=cfg.act_quant)
    return out, new_cache


def _cache_write_(cache, new, idx):
    """Write one step at sequence position ``idx`` (a 0-d device tensor) of
    ``cache`` [B, S, ...] in place; ``new`` is [B, 1, ...].  The index stays
    on the device, so a captured step writes where the cache length says.
    Past the end (``idx >= S``) nothing changes, as the reference's masked
    select writes nothing there: the last position is written with itself.
    On a DTensor cache each device writes its own block (of a sequence
    sharded over the mesh, the block that holds position ``idx``)."""
    if is_dtensor(cache):
        pl = cache.placements
        local_block(_cache_write_, (cache, new, idx),
                    (pl, batch_split(cache), (Replicate(),) * len(pl)), None)
        return
    s = cache.shape[1]
    pos = torch.clamp(idx, max=s - 1).reshape(1).to(torch.long)
    keep = cache.index_select(1, pos)
    cache.index_copy_(1, pos, torch.where(idx < s, new.to(cache.dtype), keep))


def _cache_fill(cache, kv):
    """Prefill: write kv[0:S] into the cache prefix.  On a DTensor cache,
    laid out by the plan, each device fills its own block: the prefill
    fills the whole cache there."""
    if is_dtensor(cache):
        if kv.shape[1] != cache.shape[1]:
            raise NotImplementedError(
                f"a DTensor cache of {cache.shape[1]} positions filled with {kv.shape[1]}")
        pl = cache.placements
        return local_block(_cache_fill, (cache, kv), (pl, pl), pl)
    out = cache.clone()
    out[:, : kv.shape[1]] = kv.to(cache.dtype)
    return out


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": meta((batch, max_len, kvh, hd), dtype),
        "v": meta((batch, max_len, kvh, hd), dtype),
    }


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=(), device="cpu"):
    h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(quant=cfg.quant, dtype=dtype, lead=lead, device=device)
    return {
        "wq": linear_init(gen, d, h * hd, **kw),
        "wk": linear_init(gen, d, kvh * hd, **kw),
        "wv": linear_init(gen, d, kvh * hd, **kw),
        "wo": linear_init(gen, h * hd, d, **kw),
    }


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over (stub-)encoder output [B, S_enc, D]."""
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = reshape(linear(p["wq"], x, quant=cfg.quant), b, s, h, hd)
    k = reshape(linear(p["wk"], enc_out, quant=cfg.quant), b, -1, kvh, hd)
    v = reshape(linear(p["wv"], enc_out, quant=cfg.quant), b, -1, kvh, hd)
    scale = 1.0 / math.sqrt(hd)
    if s * k.shape[1] >= 2048 * 1024:
        o = reshape(_grouped_flash(q, k, v, scale, causal=False), b, s, h * hd)
    else:
        mask = torch.ones((b, 1, 1, s, k.shape[1]), dtype=torch.bool, device=x.device)
        o = reshape(full_attention(q, k, v, mask, scale), b, s, h * hd)
    return linear(p["wo"], o, quant=cfg.quant)


# ---------------------------------------------------------------------------
# MLA — DeepSeek multi-head latent attention
# ---------------------------------------------------------------------------

def mla_forward(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    cache_len=None,
    absorbed_decode: bool = False,
    shard=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA: the KV cache holds only [c_kv (kv_lora) ; k_rope] per token.

    ``absorbed_decode``: the W_uk/W_uv-absorption decode path (scores
    computed directly in latent space); off by default, as in the reference.
    """
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    if cfg.q_lora_rank:
        qc = linear(p["w_dq"], x, quant=cfg.quant)
        q = reshape(linear(p["w_uq"], qc, quant=cfg.quant), b, s, h, dn + dr)
    else:
        q = reshape(linear(p["wq"], x, quant=cfg.quant), b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = linear(p["w_dkv"], x, quant=cfg.quant)
    ckv, k_rope = dkv[..., :r], dkv[..., r:]
    ckv = _rms(ckv, p["ckv_norm"]["g"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    if cache is not None and s == 1:
        idx = torch.as_tensor(cache_len, device=x.device).reshape(())
        _cache_write_(cache["ckv"], ckv, idx)
        _cache_write_(cache["krope"], k_rope, idx)
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        new_cache = cache
        s_kv = ckv_c.shape[1]
        valid = torch.arange(s_kv, device=x.device)[None] < (idx + 1)  # [1, S]
        if absorbed_decode:
            # score = q_nope^T W_uk c + q_rope^T k_rope, all in latent space
            wuk = _mat(p["w_uk"]).reshape(r, h, dn)
            q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0], wuk)  # [B,H,r]
            s_lat = einsum("bhr,bsr->bhs", q_lat, ckv_c.to(q_lat.dtype))
            s_rope = einsum("bhd,bsd->bhs", q_rope[:, 0], kr_c.to(q_rope.dtype))
            scores = (s_lat + s_rope).to(torch.float32) * scale
            scores = torch.where(valid[:, None, :], scores, NEG_INF)
            pr = _seq_sharded_softmax(scores, shard)
            o_lat = einsum("bhs,bsr->bhr", pr.to(ckv_c.dtype), ckv_c)  # [B,H,r]
            wuv = _mat(p["w_uv"]).reshape(r, h, dv)
            o = einsum("bhr,rhd->bhd", o_lat.to(x.dtype), wuv.to(x.dtype))
            o = reshape(o, b, 1, h * dv)
        else:
            # paper-faithful naive decode: expand K/V for the whole cache
            k_nope = reshape(linear(p["w_uk"], ckv_c.to(x.dtype), quant=cfg.quant),
                             b, s_kv, h, dn)
            vv = reshape(linear(p["w_uv"], ckv_c.to(x.dtype), quant=cfg.quant), b, s_kv, h, dv)
            kr = kr_c.to(x.dtype)[:, :, None, :].expand(b, s_kv, h, dr)
            kk = torch.cat([k_nope, kr], dim=-1)
            qq = torch.cat([q_nope, q_rope], dim=-1)[:, 0]  # [B,H,dn+dr]
            scores = einsum("bhd,bshd->bhs", qq, kk).to(torch.float32) * scale
            scores = torch.where(valid[:, None, :], scores, NEG_INF)
            pr = _seq_sharded_softmax(scores, shard)
            o = reshape(einsum("bhs,bshd->bhd", pr.to(vv.dtype), vv), b, 1, h * dv)
    else:
        k_nope = reshape(linear(p["w_uk"], ckv, quant=cfg.quant), b, s, h, dn)
        vv = reshape(linear(p["w_uv"], ckv, quant=cfg.quant), b, s, h, dv)
        kr = k_rope[:, :, None, :].expand(b, s, h, dr)
        kk = torch.cat([k_nope, kr], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if shard is not None:
            qq = shard(qq, "batch", "seq", "heads", None)
            kk = shard(kk, "batch", "seq", "heads", None)
            vv = shard(vv, "batch", "seq", "heads", None)
        if s >= 4096:
            # heads are uniform here (no GQA grouping): reuse chunked path
            o = chunked_causal_attention(qq, kk, vv, scale, q_chunk=2048, kv_chunk=2048)
        else:
            mask = (positions[:, :, None] >= positions[:, None, :])[:, None, None]
            o = full_attention(qq, kk, vv, mask, scale)
        # v_head_dim may differ from qk dim; full_attention returned v dims
        o = reshape(o, b, s, h * dv)
        if cache is not None:
            new_cache = {"ckv": _cache_fill(cache["ckv"], ckv),
                         "krope": _cache_fill(cache["krope"], k_rope)}
    out = linear(p["wo"], o, quant=cfg.quant)
    return out, new_cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    return {
        "ckv": meta((batch, max_len, cfg.kv_lora_rank), dtype),
        "krope": meta((batch, max_len, cfg.qk_rope_head_dim), dtype),
    }


def _seq_sharded_softmax(scores, shard):
    """Softmax over a cache_seq-sharded last axis [B, H, S]: an explicit
    max, exp and sum, with the scores and the probabilities constrained to
    stay seq-sharded, so only the [B, H, 1] max and sum cross the wire
    (flash-decode), never the scores.  The reference's formula, on plain
    tensors and DTensors alike."""
    if shard is not None:
        scores = shard(scores, "batch", None, "cache_seq")
    m = scores.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if shard is not None:
        p = shard(p, "batch", None, "cache_seq")
    return p


def _rms(x, g, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * g.to(torch.float32)).to(x.dtype)


def _mat(p):
    """Dense weight view of a (possibly packed) linear param."""
    if "w" in p:
        return p["w"]
    from repro_torch.core.ternary import unpack_ternary

    w = unpack_ternary(p["packed"], axis=0).to(torch.float32)
    return w * p["scale"].to(torch.float32)[None, :]
