"""Operations and bytes of a configuration, from its shapes alone, and the
card's peaks.  Nothing here depends on how the program computes a layer.

Operations are 2 per multiply-accumulate: ``2*B*Ho*Wo*KH*KW*Cin*Cout`` for a
conv (a strided conv counts its strided output only), ``2*B*T*taps*Cin*Cout``
for a TCN layer over the whole ``T``-step window (the program recomputes the
window every frame, as the silicon does), ``2*B*Cin*Cout`` for the
classifier.  Bytes are each input read once in the dtype the graph carries
(float32 frames into the first conv and float32 ring features into the first
TCN layer, int8 trits between layers), the 2-bit packed weights, a float32
scale and threshold per output channel, and the output written once as int8
trits (after its fused pool or stride).  A configuration without
``tcn_steps`` has no ring and no TCN layer.

A layer's bound is ``max(ops / PEAK_OPS, bytes / PEAK_BYTES)``: the least time
an H100 could take for it, the same for every implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_OPS = 1979e12    # int8 tensor-core operations per second
PEAK_BYTES = 3.35e12  # HBM3 bytes per second


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str      # "conv2d" | "tcn" | "fc"
    ops: float     # per frame (B = 1)
    bytes: float   # per launch at batch ``batch``
    batch: int

    @property
    def bound_s(self) -> float:
        return max(self.ops * self.batch / PEAK_OPS, self.bytes / PEAK_BYTES)


def layers(cfg: Dict, batch: int) -> List[Layer]:
    """The weight layers of ``cfg`` at ``batch`` frames a step, in order."""
    h, w = cfg["input_hw"]
    steps = cfg.get("tcn_steps")
    in_bytes = 4  # float32 frames
    out: List[Layer] = []
    specs = cfg["layers"]
    for i, layer in enumerate(specs):
        kind = layer["kind"]
        if kind == "conv2d":
            kh, kw = layer["kernel"]
            s = layer.get("stride", 1)
            ho, wo = h // s, w // s
            ci, co = layer["c_in"], layer["c_out"]
            ops = 2.0 * ho * wo * kh * kw * ci * co
            nxt = specs[i + 1]["kind"] if i + 1 < len(specs) else None
            p = specs[i + 1]["window"] if nxt == "pool" else 1
            b = (batch * h * w * ci * in_bytes + kh * kw * ci * co / 4 + 8 * co
                 + batch * (ho // p) * (wo // p) * co)
            out.append(Layer("conv2d", ops, b, batch))
            h, w, in_bytes = ho, wo, 1
        elif kind == "pool":
            h, w = h // layer["window"], w // layer["window"]
        elif kind == "global_pool":
            in_bytes = 4  # the ring holds float32 features
        elif kind == "tcn":
            ci, co, taps = layer["c_in"], layer["c_out"], layer["taps"]
            ops = 2.0 * steps * taps * ci * co
            b = (batch * steps * ci * in_bytes + taps * ci * co / 4 + 8 * co
                 + batch * steps * co)
            out.append(Layer("tcn", ops, b, batch))
            in_bytes = 1
        elif kind == "fc":
            ci, co = layer["c_in"], layer["c_out"]
            out.append(Layer("fc", 2.0 * ci * co,
                             batch * ci * in_bytes + ci * co / 4 + 4 * co + batch * co * 4, batch))
    return out


def ops_per_frame(cfg: Dict) -> float:
    """Useful operations per stepped frame, every weight layer."""
    return sum(layer.ops for layer in layers(cfg, 1))


def k1_bound_s(cfg: Dict, batch: int) -> float:
    """The least time of a step's conv and TCN layers (K1's layers) at ``batch``."""
    return sum(layer.bound_s for layer in layers(cfg, batch) if layer.kind != "fc")
