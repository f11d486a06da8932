"""Memory models of the CUTIE instance: weight SCMs, feature SRAMs, TCN ring.

Counterpart of `repro.sim.memory`.  `WeightMemory` materializes the plan's
**trit-packed weight-memory images** from a `DeployedProgram`'s tables as
numpy arrays on the host — the exact bytes the quantizer packed (no
re-quantization here) — plus the per-OCU effective scales (folded through
the deploy interpreter's own `effective_scale`, so ``bitsim`` stays
bit-exact) and the per-layer activation thresholds (a Python float or a
float32 ``[C_out]`` vector).  `sim.execute.PlanExecutor` moves each image to
the input's device once.

`FeatureMemory` models the double-buffered activation memories (traffic and
stall counters); `RingBufferSchedule` is the 24-step TCN ring (576 B SCM).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.ternary import pack_ternary, unpack_ternary
from repro_torch.sim.plan import ExecutionPlan, LayerPlan

Threshold = Union[float, np.ndarray]


def _host(a) -> np.ndarray:
    """A table entry (tensor on any device, or array-like) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _threshold(value) -> Threshold:
    """A scalar stays a Python float; a per-channel vector becomes float32."""
    thr = _host(value)
    return float(thr) if thr.ndim == 0 else thr.astype(np.float32)


@dataclasses.dataclass
class LayerImage:
    """One weight layer's memory image + folded epilogue constants.

    ``packed``: conv/tcn [KH, KW, C_pad/4, C_out] uint8 (4 trits/byte along
    C_in, byte-identical to the deploy tables); fc [ceil(K/4), N] uint8
    packed along the fan-in.  ``eff_scale``: float32 [C_out] per-OCU scale
    with BN statistics folded.  ``threshold``: the ThFU comparator
    constant(s) — a float or a float32 [C_out] vector."""

    kind: str
    index: int
    packed: np.ndarray
    eff_scale: np.ndarray
    threshold: Threshold
    dilation: int = 1

    @property
    def nbytes(self) -> int:
        return int(self.packed.size)

    def weight_sparsity(self, c_in: int) -> float:
        """Fraction of exact-zero trits over the layer's REAL fan-in (pack
        padding channels excluded; the §4 projection's zero columns of a TCN
        image counted — they stream through the array).  Computed as the
        reference's float32 mean is on the CPU: the zero count is exact, then
        one multiplication by the float32 reciprocal of the count (XLA's
        rewrite of a division by a constant) — a division would differ in
        the last bit for some counts."""
        axis = 0 if self.kind == "fc" else 2
        trits = unpack_ternary(torch.from_numpy(np.ascontiguousarray(self.packed)), axis=axis)
        trits = trits[:c_in] if self.kind == "fc" else trits[:, :, :c_in]
        zeros = int((trits == 0).sum())
        return float(np.float32(zeros) * (np.float32(1) / np.float32(trits.numel())))

    def to_dict(self) -> dict:
        thr = self.threshold
        return {
            "kind": self.kind,
            "index": self.index,
            "packed_shape": list(self.packed.shape),
            "packed": self.packed.reshape(-1).tolist(),
            "eff_scale": np.asarray(self.eff_scale).tolist(),
            "threshold": np.asarray(thr).tolist() if np.ndim(thr) else float(thr),
            "dilation": self.dilation,
        }

    @staticmethod
    def from_dict(d: dict) -> "LayerImage":
        thr = d["threshold"]
        return LayerImage(
            kind=d["kind"],
            index=d["index"],
            packed=np.array(d["packed"], np.uint8).reshape(d["packed_shape"]),
            eff_scale=np.array(d["eff_scale"], np.float32),
            threshold=np.array(thr, np.float32) if isinstance(thr, list) else float(thr),
            dilation=d["dilation"],
        )


def _eff_scale(entry: Dict, fan_in: int) -> np.ndarray:
    """The deploy interpreter's own fold, materialized on the host: the
    constants are bitwise those of the ref/fused/kernel backends."""
    from repro_torch.api.program import effective_scale  # program imports sim lazily

    return _host(effective_scale(entry, fan_in)).astype(np.float32).reshape(-1)


@dataclasses.dataclass
class WeightMemory:
    """All weight-layer images of one plan, in plan order (conv* tcn* fc?).

    ``fc_scale`` is the OPU's per-class scale, applied *after* the integer
    trit dot (`DeployedProgram._fc`'s accumulate-then-scale order)."""

    images: List[LayerImage]
    fc_scale: Optional[np.ndarray] = None

    @staticmethod
    def from_tables(plan: ExecutionPlan, tables: Dict,
                    act_threshold: float) -> "WeightMemory":
        images: List[LayerImage] = []
        fc_scale = None
        ci = ti = 0
        for lp in plan.weight_layers():
            if lp.kind == "conv2d":
                entry = tables["conv"][ci]
                ci += 1
                c_pad = 4 * entry["packed"].shape[2]
                images.append(LayerImage(
                    kind="conv2d", index=lp.index,
                    packed=_host(entry["packed"]).astype(np.uint8),
                    eff_scale=_eff_scale(entry, lp.kh * lp.kw * c_pad),
                    threshold=_threshold(entry.get("threshold", act_threshold)),
                ))
            elif lp.kind == "tcn":
                entry = tables["tcn"][ti]
                ti += 1
                images.append(LayerImage(
                    kind="tcn", index=lp.index,
                    packed=_host(entry["packed"]).astype(np.uint8),
                    eff_scale=_eff_scale(entry, lp.taps * lp.c_in),
                    threshold=_threshold(entry.get("threshold", act_threshold)),
                    dilation=int(entry["dilation"]),
                ))
            elif lp.kind == "fc":
                entry = tables["fc"]
                t = _host(entry["t"]).astype(np.int8)
                # pack with the SAME codec as every other image (4 trits/byte)
                t_pad = np.pad(t, ((0, (-t.shape[0]) % 4), (0, 0)))
                images.append(LayerImage(
                    kind="fc", index=lp.index,
                    packed=pack_ternary(torch.from_numpy(t_pad), axis=0).numpy(),
                    eff_scale=_host(entry["scale"]).astype(np.float32).reshape(-1),
                    threshold=0.0,
                ))
                fc_scale = images[-1].eff_scale
        return WeightMemory(images=images, fc_scale=fc_scale)

    def image_for(self, lp: LayerPlan) -> LayerImage:
        for img in self.images:
            if img.index == lp.index:
                return img
        raise KeyError(f"no weight image for plan layer {lp.index} ({lp.kind})")

    @property
    def nbytes(self) -> int:
        return sum(img.nbytes for img in self.images)

    def to_dict(self) -> dict:
        return {"images": [img.to_dict() for img in self.images]}

    @staticmethod
    def from_dict(d: dict) -> "WeightMemory":
        images = [LayerImage.from_dict(i) for i in d["images"]]
        fc = next((i.eff_scale for i in images if i.kind == "fc"), None)
        return WeightMemory(images=images, fc_scale=fc)


# ---------------------------------------------------------------------------
# Feature memories (double-buffered) and the TCN ring — traffic models
# ---------------------------------------------------------------------------

ACT_BITS = 2  # ternary activations: 2 bits each (the silicon's memory model)

# One Kraken feature-memory bank: max_fmap^2 pixels x max_cin channels x 2 b
# (64*64*96*2/8 = 98304 B).  Every registry net's maps fit a bank, so the
# stall counters below are zero on the default geometry — the double-buffer
# contract the silicon was sized for.
KRAKEN_FMAP_BANK_BYTES = 64 * 64 * 96 * ACT_BITS // 8


def fmap_bytes(h: int, w: int, c: int) -> int:
    """Bytes of one 2-bit activation map — what one feature-memory bank
    must hold for the layer to be double-bufferable."""
    return h * w * ((c * ACT_BITS + 7) // 8)


@dataclasses.dataclass(frozen=True)
class FeatureMemory:
    """Double-buffered activation memory: layer N streams its input from
    bank A while writing bank B, so compute never stalls on the memory —
    the schedule cost is pure traffic, counted per layer below.

    Words are pixel-vectors: one word = one pixel's channel slice (at most
    ``max_cin`` channels x 2 bit).

    ``bank_bytes`` sizes one bank.  A conv/tcn layer is *double-bufferable*
    only when its input map and its (post-pool) output map each fit one
    bank; a layer that spills shares a bank between the in-flight read
    stream and the writeback, which `layer_stalls` prices (the sim's
    bank-conflict / non-double-bufferable counters — zero for every
    registry net on the Kraken geometry)."""

    max_cin: int
    bank_bytes: int = KRAKEN_FMAP_BANK_BYTES

    def out_hw(self, lp: LayerPlan) -> tuple:
        if lp.kind == "conv2d" and lp.stride > 1:
            return lp.h // lp.stride, lp.w // lp.stride
        if lp.pool and lp.kind in ("conv2d", "tcn"):
            return lp.h // lp.pool, lp.w // lp.pool
        return lp.h, lp.w

    def double_bufferable(self, lp: LayerPlan) -> bool:
        """True when layer ``lp``'s in and out maps each fit one bank.
        Non-conv layers are addressing-only and trivially double-buffer."""
        if lp.kind not in ("conv2d", "tcn"):
            return True
        oh, ow = self.out_hw(lp)
        return (fmap_bytes(lp.h, lp.w, lp.c_in) <= self.bank_bytes
                and fmap_bytes(oh, ow, lp.c_out) <= self.bank_bytes)

    def layer_stalls(self, lp: LayerPlan) -> dict:
        """{bank_conflict, ndb} stall cycles for one plan layer.

        Double-bufferable layers stall zero cycles — ping-pong banking
        decouples the read stream from the writeback.  A spilled layer
        serializes on the single shared bank:

          * ``bank_conflict`` — every output writeback word steals one
            read-port cycle from the in-flight input stream (one stall per
            write word, i.e. the layer's write traffic);
          * ``ndb`` — with no second bank to ping-pong into, the line
            buffer must re-prime from the shared bank after each tile
            pass's writeback burst: one extra (kh-1)-row fill per tile
            pass on top of the pipelined fill the cycle model already
            counts."""
        if lp.kind not in ("conv2d", "tcn") or self.double_bufferable(lp):
            return {"bank_conflict": 0, "ndb": 0}
        traffic = self.layer_traffic(lp)
        fill = (lp.kh - 1) * lp.w
        return {
            "bank_conflict": traffic["writes"],
            "ndb": max(len(lp.tiles), 1) * fill,
        }

    def layer_traffic(self, lp: LayerPlan) -> dict:
        """{reads, writes} in pixel-vector words for one plan layer.

        conv/tcn: every tile pass streams the input map once through the
        line buffer (h*w words per tile), and each cout-tile group writes
        the (post-pool) output map once.  Pool/global_pool/flatten are
        addressing-only on the read side; fc reads its input vector once
        and writes the logits."""
        if lp.kind in ("conv2d", "tcn"):
            n_tiles = max(len(lp.tiles), 1)
            cout_groups = len({(t.cout_lo, t.cout_hi) for t in lp.tiles}) or 1
            out_pix = lp.out_pixels // (lp.pool * lp.pool) if lp.pool else lp.out_pixels
            return {"reads": n_tiles * lp.h * lp.w, "writes": cout_groups * out_pix}
        if lp.kind in ("pool", "global_pool"):
            return {"reads": lp.h * lp.w, "writes": 1 if lp.kind == "global_pool"
                    else (lp.h // lp.pool) * (lp.w // lp.pool)}
        if lp.kind == "fc":
            return {"reads": -(-lp.c_in // self.max_cin), "writes": 1}
        return {"reads": 0, "writes": 0}


@dataclasses.dataclass(frozen=True)
class RingBufferSchedule:
    """The TCN memory schedule: ``steps`` x ``channels`` x 2 bit ring
    (24 x 96 x 2 b = 576 B on Kraken).  One push per frontend pass; every
    TCN-head layer reads the full ordered window once per classification."""

    steps: int
    channels: int
    pushes_per_inference: int

    @property
    def nbytes(self) -> int:
        return self.steps * ((self.channels * ACT_BITS + 7) // 8)

    def window_reads(self, n_tcn_layers: int) -> int:
        """Ordered-window reads (in pixel-vector words) per classification."""
        return n_tcn_layers * self.steps

    @staticmethod
    def for_plan(plan: ExecutionPlan) -> Optional["RingBufferSchedule"]:
        if not plan.feature_channels:
            return None
        return RingBufferSchedule(
            steps=plan.tcn_steps,
            channels=plan.feature_channels,
            pushes_per_inference=plan.passes_per_inference,
        )
