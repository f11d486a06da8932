"""The plain PyTorch reference of a CUTIE configuration: a CNN+TCN, or a CNN classifier.

It imports nothing of the program.  From the benchmark's float weights and
calibration frames it works out again what the program's set-up derives,
and then serves a clip the plain way:

* **Deploy tables** (`derive`): per weight layer the TWN ternary weights
  ``t = sign(w) * [|w| > nu * mean|w|]`` and scale ``alpha = mean(|w| : kept)``
  per output channel (per class for the classifier); the batch-norm std of
  each conv and TCN layer from one fake-quantized float32 pass over the
  calibration clips ``[B, T, H, W, C]`` (or frames ``[N, H, W, C]`` for a net
  without a ring; per-tensor TWN weights, ternarized activations, the
  dilated TCN layers through the time-axis wrap of the paper's section 4),
  folded into the per-channel scale ``alpha / (std + 1e-6)``.  This part is a
  frozen copy of the port's arithmetic, op for op, so that the scales come
  out bit for bit; it runs deterministic float32 (no TF32).
* **Serving** (`spatial`, `temporal`): each conv a plain SAME convolution of
  the ternary weights, times the scale, ternarized at ``|y| > threshold``,
  then subsampled (stride) or 2x2 max-pooled; a spatial mean into the ring's
  feature vector; each TCN layer a causal dilated 1-D convolution over the
  ordered window with left zero history; the classifier ``(x @ t) * scale``,
  after the TCN head, or in a spatial classifier after the last maps
  flattened in ``(H, W, C)`` order.
  Every product is of ternary or dyadic values, so float32 sums are exact.
  ``precision="bf16"`` computes the float32 steps of serving — the scale
  multiply, the threshold, the pooled mean, the classifier's scale — in
  bfloat16: the control that a check has to fail.
* **The gate** (`gate_plan`): which frames of a clip reach the device under
  an activity gate with hysteresis, from the frames' event counts.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-6


@contextlib.contextmanager
def _flags(*, cudnn: bool):
    """float32 without TF32; cuDNN deterministic (calibration) or off (serving)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- deriving the deploy tables ------------------------------------------------

def twn(w: torch.Tensor, nu: float, axis=None):
    """TWN: (ternary weights as float32, positive scale), reduced over ``axis``."""
    absw = w.abs()
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    if axis is None:
        delta = nu * absw.mean()
        mask = absw > delta
        num = torch.where(mask, absw, zero).sum()
        den = mask.sum().clamp(min=1)
    else:
        delta = nu * absw.mean(dim=axis, keepdim=True)
        mask = absw > delta
        num = torch.where(mask, absw, zero).sum(dim=axis, keepdim=True)
        den = mask.sum(dim=axis, keepdim=True).clamp(min=1)
    t = torch.where(mask, torch.sign(w), zero).to(torch.int8).to(w.dtype)
    return t, (num / den).to(w.dtype)


def _conv_nhwc(x, w, pad):
    """Stride-1 cross-correlation: x [B,H,W,C], w [KH,KW,Ci,Co], pad (t, b, l, r)."""
    top, bottom, left, right = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.conv2d(xn, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1).contiguous()


def _std(y):
    return torch.std(y.to(torch.float32), dim=tuple(range(y.ndim - 1)), unbiased=False)


def _ternarize(y, thr):
    return torch.where(y.abs() > thr, torch.sign(y), torch.zeros_like(y))


def _calibration_stds(cfg: Dict, params: Dict, calib: torch.Tensor) -> List[torch.Tensor]:
    """The std of every conv then every TCN layer's output over the calibration
    clips ``[B, T, H, W, C]`` (frames ``[N, H, W, C]`` without a ring),
    fake-quantized with per-tensor TWN weights."""
    nu, thr, steps = cfg["weight_nu"], cfg["act_threshold"], cfg.get("tcn_steps")
    stds: List[torch.Tensor] = []
    x = calib.reshape(-1, *calib.shape[-3:])
    ci = ti = 0
    for layer in cfg["layers"]:
        kind = layer["kind"]
        if kind == "conv2d":
            t, a = twn(params["conv"][ci]["w"], nu)
            kh, kw = layer["kernel"]
            top, left = (kh - 1) // 2, (kw - 1) // 2
            y = _conv_nhwc(x, a * t, (top, kh - 1 - top, left, kw - 1 - left))
            sd = _std(y)
            stds.append(sd)
            x = _ternarize(y / (sd + BN_EPS), thr)
            s = layer.get("stride", 1)
            if s > 1:
                x = x[:, ::s, ::s, :]
            ci += 1
        elif kind == "pool":
            w = layer["window"]
            x = F.max_pool2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
        elif kind == "global_pool":
            x = x.mean(dim=(1, 2))
            x = x.reshape(calib.shape[0], calib.shape[1], -1)
            t_in = x.shape[1]
            if t_in > steps:
                x = x[:, -steps:]
            elif t_in < steps:
                x = F.pad(x, (0, 0, steps - t_in, 0))
        elif kind == "tcn":
            t, a = twn(params["tcn"][ti]["w"], nu)
            d, kh, kw = layer["dilation"], layer["kernel"][0], layer["kernel"][1]
            b, n, c = x.shape
            n_pad = -(-n // d) * d
            z = F.pad(x, (0, 0, 0, n_pad - n)).reshape(b, n_pad // d, d, c)
            k2d = torch.zeros((kh, kw, *t.shape[1:]), dtype=t.dtype, device=t.device)
            k2d[kh - t.shape[0]:, kw // 2] = a * t
            y2 = _conv_nhwc(z, k2d, (kh - 1, 0, kw // 2, kw // 2))
            y = y2.reshape(b, -1, y2.shape[-1])[:, :n, :]
            sd = _std(y)
            stds.append(sd)
            x = _ternarize(y / (sd + BN_EPS), thr)
            ti += 1
    return stds


def derive(cfg: Dict, params: Dict, calib: torch.Tensor) -> Dict:
    """The deploy tables from float ``params`` and calibration clips
    ``[B, T, H, W, C]`` or frames ``[N, H, W, C]`` (both on one device): per
    conv and TCN layer the ternary weights and the folded per-channel scale;
    the classifier's ternary weights and per-class scale."""
    nu = cfg["weight_nu"]
    with torch.no_grad(), _flags(cudnn=True):
        stds = _calibration_stds(cfg, params, calib)
        conv = []
        for lp in params["conv"]:
            t, a = twn(lp["w"], nu, axis=(0, 1, 2))
            conv.append({"t": t, "scale": a.reshape(-1)})
        tcn = []
        for lp in params["tcn"]:
            t, a = twn(lp["w"], nu, axis=(0, 1))
            tcn.append({"t": t, "scale": a.reshape(-1)})
        for entry, sd in zip(conv + tcn, stds):
            entry["eff"] = entry["scale"] / (sd + BN_EPS)
        t, a = twn(params["fc"]["w"], nu, axis=0)
    return {"conv": conv, "tcn": tcn, "fc": {"t": t, "scale": a.reshape(-1)}}


# -- serving ---------------------------------------------------------------------

def _scaled_ternary(acc, eff, thr, precision: str):
    if precision == "bf16":
        y = acc.to(torch.bfloat16) * eff.to(torch.bfloat16)
        return _ternarize(y, thr).to(torch.float32)
    return _ternarize(acc * eff, thr)


def _classify(x, fc: Dict, precision: str):
    y = x @ fc["t"]
    if precision == "bf16":
        return (y.to(torch.bfloat16) * fc["scale"].to(torch.bfloat16)).to(torch.float32)
    return y * fc["scale"]


def spatial(cfg: Dict, tables: Dict, frames: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """Frames ``[N, H, W, C]`` float32 -> the ring's feature vectors ``[N, C]``
    (a ``global_pool``), or a spatial classifier's logits ``[N, n_classes]``
    (a ``flatten``, then the ``fc``)."""
    thr = cfg["act_threshold"]
    x = frames.permute(0, 3, 1, 2)  # NCHW from here on
    ci = 0
    with torch.no_grad(), _flags(cudnn=False):
        for layer in cfg["layers"]:
            kind = layer["kind"]
            if kind == "conv2d":
                entry = tables["conv"][ci]
                ci += 1
                kh, kw = layer["kernel"]
                w = entry["t"].permute(3, 2, 0, 1)  # [Co, Ci, KH, KW]
                acc = F.conv2d(F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)), w)
                x = _scaled_ternary(acc, entry["eff"][None, :, None, None], thr, precision)
                s = layer.get("stride", 1)
                if s > 1:
                    x = x[:, :, ::s, ::s]
            elif kind == "pool":
                x = F.max_pool2d(x, layer["window"])
            elif kind == "global_pool":
                if precision == "bf16":
                    return x.to(torch.bfloat16).mean(dim=(2, 3)).to(torch.float32)
                return x.mean(dim=(2, 3))
            elif kind == "flatten":
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the port's NHWC order
            elif kind == "fc":
                return _classify(x, tables["fc"], precision)
    raise ValueError("the configuration's spatial layers end without a global_pool or an fc")


def temporal(cfg: Dict, tables: Dict, window: torch.Tensor,
             precision: str = "fp32") -> torch.Tensor:
    """The ordered ring window ``[B, T, C]`` (oldest first, zero history) ->
    logits ``[B, n_classes]`` at its newest step."""
    thr = cfg["act_threshold"]
    x = window.permute(0, 2, 1)  # [B, C, T]
    ti = 0
    with torch.no_grad(), _flags(cudnn=False):
        for layer in cfg["layers"]:
            kind = layer["kind"]
            if kind == "tcn":
                entry = tables["tcn"][ti]
                ti += 1
                d = layer["dilation"]
                w = entry["t"].permute(2, 1, 0)  # [Co, Ci, taps], tap 0 the oldest
                acc = F.conv1d(F.pad(x, ((w.shape[-1] - 1) * d, 0)), w, dilation=d)
                x = _scaled_ternary(acc, entry["eff"][None, :, None], thr, precision)
            elif kind == "last_step":
                x = x[:, :, -1]
            elif kind == "fc":
                return _classify(x, tables["fc"], precision)
    raise ValueError("the configuration's temporal layers end without an fc")


# -- the gate ----------------------------------------------------------------------

def gate_plan(activities: Sequence[int], wake: int, park: int, park_after: int) -> List[bool]:
    """Per frame, whether it is stepped on the device.  A stream starts
    asleep; asleep, a frame with at least ``wake`` events wakes it and is
    stepped, any other is skipped; awake, a frame with at least ``park``
    events is stepped, and the ``park_after``-th quiet frame in a row puts it
    to sleep and is skipped (the quiet frames before it are stepped)."""
    out: List[bool] = []
    awake, quiet = False, 0
    for a in activities:
        if not awake:
            awake = a >= wake
            quiet = 0
            out.append(awake)
        elif a >= park:
            quiet = 0
            out.append(True)
        else:
            quiet += 1
            awake = quiet < park_after
            out.append(awake)
    return out
