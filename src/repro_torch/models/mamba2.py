"""Mamba2 (SSD — state-space duality) block: chunked-scan prefill path and
O(1)-state decode path.  Counterpart of `repro.models.mamba2`.

Per-head scalar decay A, grouped B/C (G=1), depthwise causal conv1d on
[x, B, C], gated RMSNorm.  The chunked algorithm (chunk length L):
    s[t]      = cumsum(dt*A) within the chunk                (log decay)
    Y_intra   = ((C B^T) ∘ exp(s_t - s_τ) ∘ dt_τ, τ<=t) X    (quadratic in L)
    h_out     = exp(s_L)*h_in + Σ_τ exp(s_L - s_τ) dt_τ B_τ ⊗ X_τ
    Y_inter   = C_t exp(s_t) h_in
The in-projection is split into separate projections (w_z, w_x, w_B, w_C,
w_dt), as in the reference's param tree.

The depthwise conv1d optionally routes through the paper's §4 dilated->2D
mapping (cfg.use_tcn_mapping) — a D=1 wrap through `repro_torch.core.tcn`.
Both routes run under `kernels.ref.exact_float32`: on the card cuDNN is off
(it would allow TF32 for float32 convolutions) and the convolution is a
direct sum.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.tcn import unwrap_time_axis, wrap_time_axis
from repro_torch.kernels.ref import exact_float32
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, linear_init, meta, normal, silu
from repro_torch.models.spmd import is_dtensor, local_block, reshape


def mamba_init(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=(), device="cpu"):
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    kw = dict(quant=cfg.quant, dtype=dtype, lead=lead, device=device)

    def conv(ch):
        return normal(gen, (*lead, k, ch), 0.1, device).to(dtype)

    def const(values, dt):
        return values.to(device=device, dtype=dt).expand(*lead, nh).clone()

    return {
        "w_z": linear_init(gen, d, di, **kw),
        "w_x": linear_init(gen, d, di, **kw),
        "w_B": linear_init(gen, d, n, **kw),
        "w_C": linear_init(gen, d, n, **kw),
        "w_dt": linear_init(gen, d, nh, **{**kw, "quant": "none"}),
        "conv_x_w": conv(di),
        "conv_x_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "conv_B_w": conv(n),
        "conv_B_b": torch.zeros((*lead, n), dtype=dtype, device=device),
        "conv_C_w": conv(n),
        "conv_C_b": torch.zeros((*lead, n), dtype=dtype, device=device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh)), torch.float32),
        "D": const(torch.ones(nh), torch.float32),
        "dt_bias": const(torch.zeros(nh), torch.float32),
        "norm_g": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": linear_init(gen, di, d, **kw),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           use_tcn_mapping: bool = False) -> torch.Tensor:
    """x: [B, T, C]; w: [K, C] depthwise causal (cross-correlation:
    y[t] = sum_j w[j] x[t - K + 1 + j]).  On DTensors each device convolves
    its batch rows and channels (`models/spmd.local_block`)."""
    if is_dtensor(x):
        xp = tuple(Shard(0) if p == Shard(0) else p if p == Shard(2) else Replicate()
                   for p in x.placements)
        wp = tuple(Shard(1) if p == Shard(2) else Replicate() for p in xp)
        bp = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xp)
        return local_block(lambda x, w, b: _causal_depthwise_conv(x, w, b, use_tcn_mapping),
                           (x, w, b), (xp, wp, bp), xp)
    w = w.to(x.dtype)  # f32 master weights vs bf16 activations
    b = b.to(x.dtype)
    k, c = w.shape
    with exact_float32():
        if use_tcn_mapping:
            # §4 path: wrap(time, D=1) -> undilated 2-D depthwise conv -> unwrap.
            z = wrap_time_axis(x, 1)                       # [B, T, 1, C]
            k2d = torch.zeros((k, 3, 1, c), dtype=w.dtype, device=w.device)
            k2d[:, 1, 0, :] = w
            zn = F.pad(z.permute(0, 3, 1, 2), (1, 1, k - 1, 0))   # NCHW, causal rows
            y = F.conv2d(zn, k2d.permute(3, 2, 0, 1), groups=c).permute(0, 2, 3, 1)
            return unwrap_time_axis(y, x.shape[1]) + b
        xn = F.pad(x.transpose(1, 2), (k - 1, 0))
        y = F.conv1d(xn, w.t()[:, None, :], groups=c)
    return y.transpose(1, 2) + b


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Decode-time conv: hist [B, K, C] (oldest..newest) -> [B, C]."""
    return torch.einsum(
        "bkc,kc->bc", hist.to(torch.float32), w.to(torch.float32)
    ) + b.to(torch.float32)


def _ssd_chunked(x, dt, a_log, bmat, cmat, h0, chunk: int):
    """SSD scan.  x: [B,T,H,P], dt: [B,T,H], bmat/cmat: [B,T,N], h0: [B,H,P,N]
    (None: zeros).  Returns (y [B,T,H,P], h_final).  On DTensors each device
    scans its batch rows and heads (`models/spmd.local_block`)."""
    if is_dtensor(x):
        xp = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements)
        ap = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xp)
        bp = tuple(p if p == Shard(0) else Replicate() for p in xp)
        hp = tuple(Shard(1) if p == Shard(2) else p for p in xp)
        return local_block(
            lambda x, dt, a_log, bmat, cmat, h0: _ssd_chunked(x, dt, a_log, bmat, cmat, h0,
                                                              chunk),
            (x, dt, a_log, bmat, cmat, h0), (xp, xp, ap, bp, bp, None if h0 is None else hp),
            (xp, hp))
    bsz, t, h, p = x.shape
    n = bmat.shape[-1]
    if h0 is None:
        h0 = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    l = min(chunk, t)
    pad = (-t) % l
    if pad:
        # pad the time axis to a chunk multiple.  Padded steps are identity
        # on the state: dt=0 -> decay exp(0)=1, increment dt*B*x=0.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    t_pad = t + pad
    nc = t_pad // l
    a = -torch.exp(a_log)  # [H], negative

    xr = x.reshape(bsz, nc, l, h, p)
    dtr = dt.reshape(bsz, nc, l, h)
    br = bmat.reshape(bsz, nc, l, n)
    cr = cmat.reshape(bsz, nc, l, n)
    out_dtype = x.dtype  # the big [B,T,H,P] outputs in compute dtype; state math f32
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))[None, :, :, None]

    h_in = h0
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xr[:, ci], dtr[:, ci], br[:, ci], cr[:, ci]
        da = dtc * a  # [B,l,H] log-decay increments (negative)
        s = torch.cumsum(da, dim=1)  # [B,l,H]
        # intra-chunk: M[t,tau] = exp(s_t - s_tau) * (C_t.B_tau) * dt_tau
        cb = torch.einsum("bln,bmn->blm", cc, bc)  # [B,l,l] (t, tau)
        diff = s[:, :, None, :] - s[:, None, :, :]  # [B,l,l,H]
        # mask before exp: the upper triangle's positive diffs overflow
        decay = torch.exp(torch.where(causal, diff, -torch.inf))
        m = cb[..., None] * decay * dtc[:, None, :, :]  # weight by dt_tau
        y_intra = torch.einsum("blmh,bmhp->blhp", m, xc.to(torch.float32))
        # inter-chunk: y_inter[t] = exp(s_t) * C_t . h_in
        y_inter = torch.einsum("bln,bhpn->blhp", cc, h_in) * torch.exp(s)[..., None]
        # state update
        tail = torch.exp(s[:, -1:, :] - s)  # exp(s_L - s_tau) [B,l,H]
        dbx = torch.einsum("blh,bln,blhp->bhpn", dtc * tail, bc, xc.to(torch.float32))
        h_in = h_in * torch.exp(s[:, -1])[:, :, None, None] + dbx
        ys.append((y_intra + y_inter).to(out_dtype))
    y = torch.stack(ys, dim=1).reshape(bsz, t_pad, h, p)[:, :t]
    return y, h_in


def mamba_forward(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    state: Optional[dict] = None,
    shard=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, T, D].  With ``state`` and T==1: O(1) decode step, which
    writes the given state in place and returns it.

    state = {"h": [B,H,P,N] f32, "conv_x": [B,K-1,di], "conv_B"/"conv_C": [B,K-1,N]}.
    """
    bsz, t, d = x.shape
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q, aq = cfg.quant, cfg.act_quant
    z = linear(p["w_z"], x, quant=q, act_quant=aq)
    xin = linear(p["w_x"], x, quant=q, act_quant=aq)
    bin_ = linear(p["w_B"], x, quant=q, act_quant=aq)
    cin = linear(p["w_C"], x, quant=q, act_quant=aq)
    dt_raw = linear(p["w_dt"], x)

    new_state = None
    if state is not None and t == 1:
        # ---- decode: O(1) state update ----
        hx = torch.cat([state["conv_x"], xin.to(state["conv_x"].dtype)], dim=1)
        hb = torch.cat([state["conv_B"], bin_.to(state["conv_B"].dtype)], dim=1)
        hc = torch.cat([state["conv_C"], cin.to(state["conv_C"].dtype)], dim=1)
        xs = silu(_conv_step(hx, p["conv_x_w"], p["conv_x_b"]))
        bm = silu(_conv_step(hb, p["conv_B_w"], p["conv_B_b"]))
        cm = silu(_conv_step(hc, p["conv_C_w"], p["conv_C_b"]))
        xs = reshape(xs, bsz, nh, hp)
        dtv = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])  # [B,H]
        a = -torch.exp(p["A_log"])
        decay = torch.exp(dtv * a)  # [B,H]
        h_new = state["h"] * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dtv, bm, xs
        )
        y = torch.einsum("bn,bhpn->bhp", cm, h_new) + p["D"][None, :, None] * xs
        y = reshape(y, bsz, 1, di)
        for name, v in (("h", h_new), ("conv_x", hx[:, 1:]), ("conv_B", hb[:, 1:]),
                        ("conv_C", hc[:, 1:])):
            state[name].copy_(v)
        new_state = state
    else:
        xs = silu(
            _causal_depthwise_conv(xin, p["conv_x_w"], p["conv_x_b"], cfg.use_tcn_mapping)
        )
        bm = silu(_causal_depthwise_conv(bin_, p["conv_B_w"], p["conv_B_b"]))
        cm = silu(_causal_depthwise_conv(cin, p["conv_C_w"], p["conv_C_b"]))
        xs = reshape(xs, bsz, t, nh, hp)
        if shard is not None:
            xs = shard(xs, "batch", "seq", "heads", None)
        dtv = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [B,T,H]
        y, h_fin = _ssd_chunked(
            xs, dtv, p["A_log"], bm.to(torch.float32), cm.to(torch.float32),
            None if state is None else state["h"], cfg.ssm_chunk,
        )
        y = y.to(torch.float32) + p["D"][None, None, :, None] * xs.to(torch.float32)
        y = reshape(y, bsz, t, di)
        if state is not None:
            k = cfg.ssm_conv

            def tail(v, cdtype):
                pad = torch.zeros((bsz, max(k - 1 - t, 0), v.shape[-1]), dtype=cdtype,
                                  device=x.device)
                return torch.cat([pad, v[:, -(k - 1):, :].to(cdtype)], dim=1)[:, -(k - 1):, :]

            new_state = {
                "h": h_fin,
                "conv_x": tail(xin, state["conv_x"].dtype),
                "conv_B": tail(bin_, state["conv_B"].dtype),
                "conv_C": tail(cin, state["conv_C"].dtype),
            }

    # gated RMSNorm (mamba2): norm(y * silu(z))
    yg = y.to(torch.float32) * silu(z.to(torch.float32))
    yg = yg * torch.rsqrt((yg * yg).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    yg = (yg * p["norm_g"].to(torch.float32)).to(x.dtype)
    out = linear(p["out_proj"], yg, quant=q, act_quant=aq)
    return out, new_state


def mamba_state_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    k = cfg.ssm_conv
    return {
        "h": meta((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "conv_x": meta((batch, k - 1, cfg.d_inner), dtype),
        "conv_B": meta((batch, k - 1, cfg.ssm_state), dtype),
        "conv_C": meta((batch, k - 1, cfg.ssm_state), dtype),
    }
