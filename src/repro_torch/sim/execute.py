"""Plan execution — the ``backend="bitsim"`` interpreter, and the plan walk
the other backends share.  Counterpart of `repro.sim.execute`.

Walks the `ExecutionPlan` tile by tile, reading every weight from the
trit-packed `WeightMemory` images (unpacked per `TileAssign` slice; tile
boundaries are byte-aligned because ``max_cin`` is a multiple of the 4-trit
pack quantum) and accumulating partial sums across C_in tiles the way the
OCU adder tree does.  Each tile pass is one float32 ``F.conv2d`` under
`kernels.ref.exact_float32` (cuDNN off, no TF32) — the plain tensor code the
reference left to XLA, not a kernel of its own.

A non-default ``backend`` ("ref"/"fused"/"kernel") replaces the tiled walk
with one `api.program._dispatch_conv` launch per layer — the same kernels the
`DeployedProgram` interpreter dispatches (K1 for "fused" and "kernel"),
driven from the plan and the images alone.

Bit-exactness contract: with ternary/dyadic activations every partial sum is
an integer or dyadic value and exact in float32 under any order; the per-OCU
effective scale is the same float32 constant the deploy interpreter folds;
the threshold unit compares against the same scalar-or-vector constant.
Inter-layer activations are int8 trits (the silicon's 2-bit feature memory).

Each image is moved to the input's device once and cached there, with
what a step would otherwise rebuild every time: the FC image decoded to
trits, and on the "fused" route a scalar threshold splatted to the
kernel's ``[C_out]`` vector.  The plan's per-layer ``block_cout``
(`kernels.autotune`) is not passed to the kernels: the CUDA kernels pick
their own tiles.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.api.program import (
    _dispatch_conv,
    _pad_channels,
    _pool,
    _ternarize,
    check_backend,
)
from repro_torch.core.tcn import unwrap_time_axis, wrap_time_axis
from repro_torch.core.ternary import unpack_ternary
from repro_torch.kernels.ref import exact_float32
from repro_torch.sim.memory import WeightMemory
from repro_torch.sim.plan import ExecutionPlan, LayerPlan, lower


class PlanExecutor:
    """Executes one `ExecutionPlan` against its `WeightMemory` images.

    Mirrors `DeployedProgram.spatial_forward`/`temporal_forward` exactly
    (the deploy interpreter is the contract); convolutions run as the
    plan's scheduled tile passes over the packed images instead of one
    kernel launch per layer.

    ``backend="bitsim"`` (default) is the tiled walk; any other deploy
    backend routes each conv through `api.program._dispatch_conv` with this
    layer's image — "fused" keeps its one-launch conv+scale+threshold(+pool)
    epilogue and int8 activations, the others return the scaled float
    accumulator and ternarize here."""

    def __init__(self, plan: ExecutionPlan, memory: WeightMemory,
                 backend: str = "bitsim"):
        check_backend(backend)
        self.plan = plan
        self.memory = memory
        self.backend = backend
        self._on_device: Dict[Tuple[int, str], tuple] = {}

    # -- constructors ------------------------------------------------------

    @staticmethod
    def for_deployed(deployed, hw=None) -> "PlanExecutor":
        """Lower ``deployed.graph`` and bind its packed tables."""
        plan = lower(deployed.graph, hw)
        memory = WeightMemory.from_tables(
            plan, deployed.tables, deployed.graph.act_threshold
        )
        return PlanExecutor(plan, memory)

    # -- images on the device ----------------------------------------------

    def _operands(self, lp: LayerPlan, device: torch.device):
        """(image, weights, eff_scale float32, threshold) of layer ``lp``
        on ``device``: made there on first use, then reused.  ``weights``
        is the packed uint8 image of a conv/TCN layer, and the decoded
        float32 ``[c_in, N]`` trits of the FC layer.  A scalar threshold
        stays a Python float, except on the "fused" route, where it is the
        kernel's ``[C_out]`` float32 operand."""
        key = (lp.index, str(device))
        ops = self._on_device.get(key)
        if ops is None:
            img = self.memory.image_for(lp)
            weights = torch.from_numpy(img.packed).to(device)
            if lp.kind == "fc":
                weights = unpack_ternary(weights, axis=0)[: lp.c_in].to(torch.float32)
            thr = img.threshold
            if not isinstance(thr, float):
                thr = torch.from_numpy(thr).to(device)
            elif self.backend == "fused" and lp.kind != "fc":
                thr = torch.full((img.eff_scale.size,), thr, dtype=torch.float32,
                                 device=device)
            ops = self._on_device[key] = (
                img, weights, torch.from_numpy(img.eff_scale).to(device), thr,
            )
        return ops

    # -- tiled conv (the OCU array walk) -----------------------------------

    def _tiled_conv(self, x: torch.Tensor, lp: LayerPlan, packed: torch.Tensor,
                    eff_scale: torch.Tensor) -> torch.Tensor:
        """SAME conv over [B, H, W, C_pad] as the plan's (cout, cin) tile
        passes; partial sums accumulate across C_in tiles per output tile."""
        kh, kw = lp.kh, lp.kw
        top, left = (kh - 1) // 2, (kw - 1) // 2
        xn = F.pad(x.to(torch.float32).permute(0, 3, 1, 2),
                   (left, kw - 1 - left, top, kh - 1 - top))
        groups = []
        for t in lp.tiles:
            if (t.cout_lo, t.cout_hi) not in groups:
                groups.append((t.cout_lo, t.cout_hi))
        outs = []
        with exact_float32():
            for co_lo, co_hi in groups:
                acc = None
                for t in lp.tiles:
                    if (t.cout_lo, t.cout_hi) != (co_lo, co_hi):
                        continue
                    wp = packed[:, :, t.cin_lo // 4: t.cin_hi // 4, co_lo:co_hi]
                    wt = unpack_ternary(wp, axis=2).to(torch.float32)
                    part = F.conv2d(xn[:, t.cin_lo: t.cin_hi], wt.permute(3, 2, 0, 1))
                    acc = part if acc is None else acc + part
                outs.append(acc)
        y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return y.permute(0, 2, 3, 1) * eff_scale.reshape(1, 1, 1, -1)

    def _conv_layer(self, x: torch.Tensor, lp: LayerPlan) -> torch.Tensor:
        img, packed, eff, thr = self._operands(lp, x.device)
        x = _pad_channels(x, lp.c_pad)
        if self.backend == "bitsim":
            y = self._tiled_conv(x, lp, packed, eff)
        elif self.backend == "fused":
            t = _dispatch_conv(x, packed, eff, "fused", threshold=thr, pool=lp.pool)
            if lp.stride > 1:
                t = t[:, :: lp.stride, :: lp.stride, :]
            return t
        else:
            y = _dispatch_conv(x, packed, eff, self.backend)
        t = _ternarize(y, thr)
        if lp.stride > 1:
            # post-ternarize subsample == strided conv (never pool-fused)
            t = t[:, :: lp.stride, :: lp.stride, :]
        if lp.pool:
            t = _pool(t, lp.pool)
        # the deploy interpreter keeps float trits between layers on the
        # unfused backends; bitsim models the 2-bit feature memory as int8
        return t.to(torch.int8) if self.backend == "bitsim" else t

    def _tcn_layer(self, x: torch.Tensor, lp: LayerPlan) -> torch.Tensor:
        """One §4-mapped TCN layer over [B, T, C]: wrap -> causal-padded
        SAME conv -> unwrap -> threshold, the deploy schedule."""
        img, packed, eff, thr = self._operands(lp, x.device)
        if self.backend == "bitsim":
            x = x.to(torch.float32)
        z = wrap_time_axis(x, img.dilation)
        kh = lp.kh
        zp = F.pad(z, (0, max(lp.c_pad - z.shape[-1], 0), 0, 0,
                       (kh - 1) - (kh - 1) // 2, 0))
        if self.backend == "fused":
            y2 = _dispatch_conv(zp, packed, eff, "fused", threshold=thr)[:, : z.shape[1]]
            return unwrap_time_axis(y2, x.shape[1])
        if self.backend == "bitsim":
            y2 = self._tiled_conv(zp, lp, packed, eff)[:, : z.shape[1]]
        else:
            y2 = _dispatch_conv(zp, packed, eff, self.backend)[:, : z.shape[1]]
        t = _ternarize(unwrap_time_axis(y2, x.shape[1]), thr)
        return t.to(torch.int8) if self.backend == "bitsim" else t

    def _fc(self, x: torch.Tensor, lp: LayerPlan) -> torch.Tensor:
        """The OPU: integer trit dot FIRST, per-class scale AFTER — the
        order that keeps logits bit-identical across batch shapes."""
        img, t, eff, _ = self._operands(lp, x.device)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        with exact_float32():
            y = x @ t.to(x.dtype)
        return y * eff

    # -- program-level forwards -------------------------------------------

    def spatial_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Frontend (or whole spatial net): [B, H, W, C] -> features/logits."""
        for lp in self.plan.spatial_layers:
            if lp.kind == "conv2d":
                x = self._conv_layer(x, lp)
            elif lp.kind == "pool":
                x = _pool(x, lp.pool)
            elif lp.kind == "global_pool":
                x = x.to(torch.float32).mean(dim=(1, 2))
            elif lp.kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif lp.kind == "fc":
                x = self._fc(x, lp)
        return x

    def temporal_forward(self, feats: torch.Tensor) -> torch.Tensor:
        """TCN head + classifier over the ordered window [B, T, C]."""
        x = feats
        for lp in self.plan.temporal_layers:
            if lp.kind == "tcn":
                x = self._tcn_layer(x, lp)
            elif lp.kind == "last_step":
                x = x[:, -1, :]
            elif lp.kind == "fc":
                x = self._fc(x, lp)
        return x
