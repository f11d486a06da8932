"""The LM layers of the port held against `repro.models` on the CPU.

Inputs are made with numpy from a seed; params are the reference's, made
with ``jax.random`` and handed across as numpy
(`repro_torch.convert.lm_params_from_reference`).  Tolerances (rtol = atol):
1e-5 for single projections, norms and rotary embeddings; 1e-4 for
attention, flash, MoE and the SSD scan; packed bytes exact.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import flash as RF
from repro.models import layers as RL
from repro.models import mamba2 as RMB
from repro.models import mlp as RMLP
from repro.models import moe as RMOE
from repro.models.config import ModelConfig as ModelConfigJ
from repro_torch.convert import lm_cache_from_reference, lm_params_from_reference
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TMB
from repro_torch.models import mlp as TMLP
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig

TOL_PROJ = 1e-5
TOL_ATTN = 1e-4


def rng(seed):
    return np.random.default_rng(seed)


def gauss(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def params(p_jax):
    return lm_params_from_reference(jax.tree_util.tree_map(np.asarray, p_jax), device="cpu")


def close(got, want, tol):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def cfg_pair(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=48, vocab_size=64, dtype="float32", remat=False)
    base.update(kw)
    return ModelConfigJ(**base), ModelConfig(**base)


# ---------------------------------------------------------------------------
# linear, norms, rope, embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "ternary", "ternary_packed"])
@pytest.mark.parametrize("act_quant", ["none", "ternary"])
def test_linear_matches_reference(quant, act_quant):
    d_in, d_out = 30, 20   # d_in not a multiple of 4: the packed path pads K
    key = jax.random.PRNGKey(3)
    pj = RL.linear_init(key, d_in, d_out, bias=True, quant=quant)
    x = gauss(rng(0), 2, 5, d_in) * 1.5
    want = RL.linear(pj, jnp.asarray(x), quant=quant, act_quant=act_quant)
    got = TL.linear(params(pj), t(x), quant=quant, act_quant=act_quant)
    close(got, want, TOL_PROJ)


def test_packed_linear_bytes_equal_reference():
    """The port's packing of the reference's float weight gives the
    reference's bytes, padded K included; the scales agree to float32."""
    for d_in, d_out, lead in ((30, 20, ()), (64, 48, ()), (18, 12, (3,))):
        key = jax.random.PRNGKey(d_in)
        keys = jax.random.split(key, lead[0]) if lead else [key]
        pjs = [RL.linear_init(k, d_in, d_out, quant="ternary_packed") for k in keys]
        ws = [jax.random.normal(k, (d_in, d_out), jnp.float32) / math.sqrt(d_in) for k in keys]
        w = np.stack([np.asarray(a) for a in ws]) if lead else np.asarray(ws[0])
        pt = TL.linear_from_weight(t(w), quant="ternary_packed")
        want_packed = np.stack([np.asarray(p["packed"]) for p in pjs]) if lead else \
            np.asarray(pjs[0]["packed"])
        want_scale = np.stack([np.asarray(p["scale"]) for p in pjs]) if lead else \
            np.asarray(pjs[0]["scale"])
        assert pt["packed"].dtype == torch.uint8
        np.testing.assert_array_equal(pt["packed"].numpy(), want_packed)
        close(pt["scale"], want_scale, 1e-6)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(norm_type, dtype):
    r = rng(1)
    d = 24
    pj = {"g": jnp.asarray(gauss(r, d) + 1.0)}
    if norm_type == "layernorm":
        pj["b"] = jnp.asarray(gauss(r, d))
    x = gauss(r, 2, 3, d) * 3 + 0.5
    want = RL.apply_norm(pj, jnp.asarray(x).astype(dtype), norm_type=norm_type, eps=1e-5)
    got = TL.apply_norm(params(pj), t(x).to(getattr(torch, dtype)), norm_type=norm_type,
                        eps=1e-5)
    assert got.dtype == getattr(torch, dtype)
    close(got, want.astype(jnp.float32), TOL_PROJ if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("partial", [1.0, 0.5])
def test_rope_matches_reference(partial):
    r = rng(2)
    x = gauss(r, 2, 7, 3, 16)
    pos = np.stack([np.arange(7), np.arange(7) + 40]).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, partial=partial)
    got = TL.apply_rope(t(x), t(pos), 10000.0, partial=partial)
    close(got, want, TOL_PROJ)
    if partial < 1.0:   # the tail past the rotary dims passes unchanged
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


def test_embeddings_match_reference():
    r = rng(3)
    pj = {"table": jnp.asarray(gauss(r, 50, 16))}
    ids = r.integers(0, 50, (2, 6)).astype(np.int32)
    for scale in (False, True):
        want = RL.embed_lookup(pj, jnp.asarray(ids), scale=scale)
        got = TL.embed_lookup(params(pj), t(ids).long(), scale=scale)
        close(got, want, TOL_PROJ)
    x = gauss(r, 2, 6, 16)
    close(TL.logits_from_embedding(params(pj), t(x)),
          RL.logits_from_embedding(pj, jnp.asarray(x)), TOL_PROJ)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cj, ct = cfg_pair(mlp_type=mlp_type, mlp_bias=mlp_type == "gelu")
    pj = RMLP.mlp_init(jax.random.PRNGKey(4), cj)
    x = gauss(rng(4), 2, 5, 32)
    close(TMLP.mlp_forward(params(pj), ct, t(x)), RMLP.mlp_forward(pj, cj, jnp.asarray(x)),
          TOL_PROJ)


# ---------------------------------------------------------------------------
# flash and attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, KV, G, hd, q_chunk, kv_chunk, causal
    (2, 100, 100, 2, 3, 16, 32, 24, True),    # neither chunk divides S
    (1, 77, 77, 1, 4, 8, 64, 64, True),       # MQA, one ragged chunk each
    (1, 50, 50, 2, 2, 8, 128, 128, True),     # S smaller than one chunk
    (2, 60, 60, 2, 2, 16, 16, 20, False),     # encoder self-attention
    (1, 40, 70, 2, 1, 8, 16, 32, False),      # cross-attention: Sk != Sq
]


@pytest.mark.parametrize("b,sq,sk,kvh,g,hd,qc,kc,causal", FLASH_CASES)
def test_flash_forward_matches_reference(b, sq, sk, kvh, g, hd, qc, kc, causal):
    r = rng(5)
    q = gauss(r, b, sq, kvh, g, hd)
    k, v = gauss(r, b, sk, kvh, hd), gauss(r, b, sk, kvh, hd)
    scale = hd ** -0.5
    want = RF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, qc, kc,
                              causal)
    got = TF.flash_attention(t(q), t(k), t(v), scale, qc, kc, causal)
    close(got, want, TOL_ATTN)


def test_chunked_reference_and_full_attention_match_reference():
    r = rng(6)
    b, s, kvh, g, hd = 1, 96, 2, 2, 16
    q, k, v = gauss(r, b, s, kvh * g, hd), gauss(r, b, s, kvh, hd), gauss(r, b, s, kvh, hd)
    scale = hd ** -0.5
    want = RA._chunked_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                 q_chunk=40, kv_chunk=32)
    got = TA._chunked_reference(t(q), t(k), t(v), scale, q_chunk=40, kv_chunk=32)
    close(got, want, TOL_ATTN)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    mask = (pos[:, :, None] >= pos[:, None, :])[:, None, None]
    full_j = RA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), scale)
    full_t = TA.full_attention(t(q), t(k), t(v), t(mask), scale)
    close(full_t, full_j, TOL_ATTN)
    close(TA.chunked_causal_attention(t(q), t(k), t(v), scale, q_chunk=40, kv_chunk=24),
          full_j, TOL_ATTN)


def test_decode_attention_matches_reference():
    r = rng(7)
    b, s, kvh, g, hd = 3, 20, 2, 2, 8
    q = gauss(r, b, kvh * g, hd)
    kc, vc = gauss(r, b, s, kvh, hd), gauss(r, b, s, kvh, hd)
    for cache_len in (np.int32(11), np.array([3, 20, 7], np.int32)):
        want = RA.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(cache_len), hd ** -0.5)
        got = TA.decode_attention(t(q), t(kc), t(vc), t(cache_len), hd ** -0.5)
        close(got, want, TOL_ATTN)


def _cache_np(c):
    return lm_cache_from_reference(jax.tree_util.tree_map(np.asarray, c), device="cpu")


@pytest.mark.parametrize("variant", ["gqa", "gqa_bias_partial", "mha_encoder"])
def test_gqa_prefill_and_decode_match_reference(variant):
    kw = {"gqa": {}, "gqa_bias_partial": dict(qkv_bias=True, partial_rotary_factor=0.5),
          "mha_encoder": dict(n_kv_heads=4)}[variant]
    causal = variant != "mha_encoder"
    cj, ct = cfg_pair(**kw)
    pj = RA.attn_init(jax.random.PRNGKey(5), cj)
    if "b" in pj["wq"]:   # non-zero biases, so they count
        for name in ("wq", "wk", "wv"):
            pj[name]["b"] = jnp.asarray(gauss(rng(8), pj[name]["b"].shape[0]))
    pt = params(pj)
    b, s, max_len = 2, 9, 12
    x = gauss(rng(9), b, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    cache_j = RA.gqa_cache_spec(cj, b, max_len, jnp.float32)
    cache_j = jax.tree_util.tree_map(lambda sd: jnp.zeros(sd.shape, sd.dtype), cache_j)
    oj, cj_new = RA.gqa_forward(pj, cj, jnp.asarray(x), jnp.asarray(pos), causal=causal,
                                cache=cache_j)
    ot, ct_new = TA.gqa_forward(pt, ct, t(x), t(pos), causal=causal, cache=_cache_np(cache_j))
    close(ot, oj, TOL_ATTN)
    for name in ("k", "v"):
        close(ct_new[name], cj_new[name], TOL_ATTN)
    if not causal:
        return
    # two decode steps on the prefilled cache
    for step in range(2):
        xd = gauss(rng(10 + step), b, 1, 32)
        idx = s + step
        pos_d = np.full((b, 1), idx, np.int32)
        oj, cj_new = RA.gqa_forward(pj, cj, jnp.asarray(xd), jnp.asarray(pos_d),
                                    cache=cj_new, cache_len=jnp.int32(idx))
        ot, ct_new = TA.gqa_forward(pt, ct, t(xd), t(pos_d), cache=ct_new,
                                    cache_len=torch.tensor(idx, dtype=torch.int32))
        close(ot, oj, TOL_ATTN)
        for name in ("k", "v"):
            close(ct_new[name], cj_new[name], TOL_ATTN)


@pytest.mark.parametrize("q_lora_rank", [0, 12])
def test_mla_prefill_and_both_decodes_match_reference(q_lora_rank):
    cj, ct = cfg_pair(attn_type="mla", n_kv_heads=4, q_lora_rank=q_lora_rank,
                      kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=8,
                      v_head_dim=12)
    pj = RA.attn_init(jax.random.PRNGKey(6), cj)
    pt = params(pj)
    b, s, max_len = 2, 7, 10
    x = gauss(rng(11), b, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    cache_j = jax.tree_util.tree_map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                                     RA.mla_cache_spec(cj, b, max_len, jnp.float32))
    oj, cache_j = RA.mla_forward(pj, cj, jnp.asarray(x), jnp.asarray(pos), cache=cache_j)
    ot, cache_t = TA.mla_forward(pt, ct, t(x), t(pos), cache=_cache_np(
        jax.tree_util.tree_map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                               RA.mla_cache_spec(cj, b, max_len, jnp.float32))))
    close(ot, oj, TOL_ATTN)
    for name in ("ckv", "krope"):
        close(cache_t[name], cache_j[name], TOL_ATTN)
    xd = gauss(rng(12), b, 1, 32)
    pos_d = np.full((b, 1), s, np.int32)
    for absorbed in (False, True):
        want, cj2 = RA.mla_forward(pj, cj, jnp.asarray(xd), jnp.asarray(pos_d), cache=cache_j,
                                   cache_len=jnp.int32(s), absorbed_decode=absorbed)
        got, ct2 = TA.mla_forward(pt, ct, t(xd), t(pos_d), cache=cache_t,
                                  cache_len=torch.tensor(s, dtype=torch.int32),
                                  absorbed_decode=absorbed)
        close(got, want, TOL_ATTN)
        close(ct2["ckv"], cj2["ckv"], TOL_ATTN)


def test_cross_attention_matches_reference():
    cj, ct = cfg_pair()
    pj = RA.cross_attn_init(jax.random.PRNGKey(7), cj)
    x, enc = gauss(rng(13), 2, 5, 32), gauss(rng(14), 2, 11, 32)
    close(TA.cross_attention(params(pj), ct, t(x), t(enc)),
          RA.cross_attention(pj, cj, jnp.asarray(x), jnp.asarray(enc)), TOL_ATTN)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_BASE = dict(family="moe", n_experts=4, experts_per_tok=2, moe_d_ff=16, d_model=16)


@pytest.mark.parametrize("case", ["no_drops", "drops", "shared_geglu", "chunked"])
def test_moe_matches_reference(case):
    kw = dict(MOE_BASE, capacity_factor=8.0)
    b, s = 2, 12
    if case == "drops":        # capacity int(12*2*0.25/4) = 1: most tokens dropped
        kw["capacity_factor"] = 0.25
    if case == "shared_geglu":
        kw.update(n_shared_experts=2, mlp_type="geglu", capacity_factor=1.0)
    if case == "chunked":      # 2 dispatch groups of 1024 tokens
        b, s = 1, 2048
        kw["capacity_factor"] = 1.0
    cj, ct = cfg_pair(**kw)
    pj = RMOE.moe_init(jax.random.PRNGKey(8), cj)
    x = gauss(rng(15), b, s, 16)
    yj, auxj = RMOE.moe_forward(pj, cj, jnp.asarray(x))
    yt, auxt = TMOE.moe_forward(params(pj), ct, t(x))
    close(yt, yj, TOL_ATTN)
    close(auxt, auxj, TOL_ATTN)
    if case == "drops":
        y_hi, _ = TMOE.moe_forward(params(pj), dataclasses.replace(ct, capacity_factor=8.0),
                                   t(x))
        assert not torch.allclose(yt, y_hi)   # tokens really were dropped


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def mamba_cfgs(**kw):
    base = dict(family="ssm", d_model=16, n_heads=0, n_kv_heads=0, head_dim=1, d_ff=0,
                ssm_state=8, ssm_conv=4, ssm_expand=2, ssm_head_dim=8, ssm_chunk=5)
    base.update(kw)
    return cfg_pair(**base)


@pytest.mark.parametrize("use_tcn_mapping", [False, True], ids=["conv1d", "tcn_2d"])
def test_causal_depthwise_conv_matches_reference(use_tcn_mapping):
    r = rng(16)
    x, w, b = gauss(r, 2, 13, 6), gauss(r, 4, 6), gauss(r, 6)
    want = RMB._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      use_tcn_mapping)
    got = TMB._causal_depthwise_conv(t(x), t(w), t(b), use_tcn_mapping)
    close(got, want, TOL_PROJ)
    # both routes are the same function
    close(TMB._causal_depthwise_conv(t(x), t(w), t(b), not use_tcn_mapping), want, TOL_PROJ)


def test_ssd_scan_matches_reference():
    r = rng(17)
    bsz, tt, h, p, n = 2, 13, 3, 4, 5   # 13 steps, chunk 5: a padded last chunk
    x, bm, cm = gauss(r, bsz, tt, h, p), gauss(r, bsz, tt, n), gauss(r, bsz, tt, n)
    dt = np.abs(gauss(r, bsz, tt, h)) * 0.5
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    h0 = gauss(r, bsz, h, p, n)
    yj, hj = RMB._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, h0)), 5)
    yt, ht = TMB._ssd_chunked(*(t(a) for a in (x, dt, a_log, bm, cm, h0)), 5)
    close(yt, yj, TOL_ATTN)
    close(ht, hj, TOL_ATTN)


@pytest.mark.parametrize("use_tcn_mapping", [False, True], ids=["conv1d", "tcn_2d"])
def test_mamba_prefill_and_decode_match_reference(use_tcn_mapping):
    cj, ct = mamba_cfgs(use_tcn_mapping=use_tcn_mapping)
    pj = RMB.mamba_init(jax.random.PRNGKey(9), cj)
    pt = params(pj)
    b, s = 2, 11
    x = gauss(rng(18), b, s, 16)
    # train mode (no state), then prefill into a zero state, then 2 decode steps
    close(TMB.mamba_forward(pt, ct, t(x))[0], RMB.mamba_forward(pj, cj, jnp.asarray(x))[0],
          TOL_ATTN)
    st_j = jax.tree_util.tree_map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                                  RMB.mamba_state_spec(cj, b, jnp.float32))
    st_t = _cache_np(st_j)
    yj, st_j = RMB.mamba_forward(pj, cj, jnp.asarray(x), state=st_j)
    yt, st_t = TMB.mamba_forward(pt, ct, t(x), state=st_t)
    close(yt, yj, TOL_ATTN)
    for step in range(2):
        xd = gauss(rng(19 + step), b, 1, 16)
        yj, st_j = RMB.mamba_forward(pj, cj, jnp.asarray(xd), state=st_j)
        yt, st_t = TMB.mamba_forward(pt, ct, t(xd), state=st_t)
        close(yt, yj, TOL_ATTN)
        for name in ("h", "conv_x", "conv_B", "conv_C"):
            close(st_t[name], st_j[name], TOL_ATTN)
