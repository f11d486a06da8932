"""Dense FFN variants: SwiGLU / GeGLU / plain GELU (+bias).  Counterpart of
`repro.models.mlp`; the GELU is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, linear_init, silu


def mlp_init(gen, cfg: ModelConfig, d_ff: int | None = None, dtype=torch.float32, *,
             lead=(), device="cpu"):
    d_ff = d_ff or cfg.d_ff
    gated = cfg.mlp_type in ("swiglu", "geglu")
    kw = dict(bias=cfg.mlp_bias, quant=cfg.quant, dtype=dtype, lead=lead, device=device)
    p = {
        "w_up": linear_init(gen, cfg.d_model, d_ff, **kw),
        "w_down": linear_init(gen, d_ff, cfg.d_model, **kw),
    }
    if gated:
        p["w_gate"] = linear_init(gen, cfg.d_model, d_ff, **kw)
    return p


def mlp_forward(p, cfg: ModelConfig, x: torch.Tensor, *, shard=None) -> torch.Tensor:
    q, aq = cfg.quant, cfg.act_quant
    up = linear(p["w_up"], x, quant=q, act_quant=aq)
    if cfg.mlp_type == "swiglu":
        gate = linear(p["w_gate"], x, quant=q, act_quant=aq)
        h = silu(gate) * up
    elif cfg.mlp_type == "geglu":
        gate = linear(p["w_gate"], x, quant=q, act_quant=aq)
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    if shard is not None:
        h = shard(h, "batch", "seq", "mlp")
    return linear(p["w_down"], h, quant=q, act_quant=aq)
