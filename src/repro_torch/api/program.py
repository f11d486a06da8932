"""`CutieProgram` — one network definition, every execution mode of the port.

Counterpart of `repro.api.program`:

    prog     = get_net("dvs_cnn_tcn")                       # repro_torch.api.registry
    params   = prog.init(torch.Generator().manual_seed(0))  # device="cuda"
    logits   = prog.forward_qat(params, frames)             # STE fake-quant training path
    deployed = prog.quantize(params, calib=frames)          # packed 2-bit weights
    logits   = deployed.forward(frames, backend="fused")    # | "kernel" | "ref" | "bitsim"
    session  = deployed.stream(batch=4)                     # TCN ring memory
    pool     = deployed.serve(pool_size=8)                  # continuous batching
    report   = deployed.silicon_report(v=0.5)               # cycles/energy vs Table 1

Backends:
    fused   one launch of the fused ternary conv per layer
            (conv + scale + ternarize (+ max-pool), int8 trits between
            layers): the hand-written CUDA kernel for tensors on the card,
            its plain PyTorch version for tensors on the CPU — the deploy
            default for serving
    kernel  the same kernel unfused (scaled float32 accumulator out),
            float activations re-ternarized, pooled and strided between
            layers — the reference's "pallas" backend
    ref     the `kernels.ref` oracle (unpack + `F.conv2d`), float activations
            re-ternarized between layers — the semantics anchor
    bitsim  `repro_torch.sim` plan executor: the graph lowered to an
            `ExecutionPlan` (OCU/C_in tiles, trit-packed weight-memory
            images) and run tile by tile

All four produce identical logits — bit-exact whenever every inter-layer
tensor is ternary or a dyadic rational of ternary values (true for all
registry nets), since all then accumulate exactly in float32 under any
summation order.  The reference's "interpret" backend (the Pallas
interpreter) has no counterpart; `check_backend` says so.

The QAT half (`forward_qat`) is differentiable end to end: STE fake-quant
weights and activations (`core.ternary`), the scale-only batch-norm's
population std, the §4 wrap/unwrap of the TCN layers and max-pools whose
gradient goes to the first maximum of each window, as the reference's
``reduce_window`` does.  `repro_torch.train` trains through it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.api import quantize as q
from repro_torch.api.graph import CutieGraph
from repro_torch.core import cutie_arch as arch
from repro_torch.core.tcn import (
    StreamState,
    TCNStream,
    conv2d_nhwc,
    conv2d_undilated,
    project_weights_to_2d,
    unwrap_time_axis,
    wrap_time_axis,
)
from repro_torch.core.ternary import (
    clamp_threshold,
    ste_ternary_acts,
    ste_ternary_weights,
    ternary_quantize_weights,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ternary_conv2d
from repro_torch.kernels.ref import deterministic_float32, exact_float32, ternary_conv2d_ref

BACKENDS = ("fused", "kernel", "ref", "bitsim")
SILICON_SOURCES = ("analytic", "sim")
_REFERENCE_ONLY_BACKENDS = {
    "pallas": "the reference's Pallas kernel backend is called 'kernel' here",
    "interpret": "the Pallas interpreter has no counterpart in the port",
}
_BN_EPS = 1e-6


def check_backend(backend: str) -> None:
    """THE backend validation — every entry point routes through here."""
    if backend in BACKENDS:
        return
    if backend in _REFERENCE_ONLY_BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not available in repro_torch: "
            f"{_REFERENCE_ONLY_BACKENDS[backend]}; expected one of {BACKENDS}"
        )
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def _pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max pool, window == stride, VALID, on [B,H,W,C].  Integer trits (the
    fused backend's int8 maps) are pooled in float32 and cast back.  The
    gradient of a window goes to its first maximum in row-major order —
    the reference's ``reduce_window`` max (``amax`` would split it among
    ties, and ternary maps tie in most windows)."""
    y = F.max_pool2d(x.to(torch.float32).permute(0, 3, 1, 2), window)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _bn_sd(y: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (population) std — the scale-only BN the silicon
    folds into its two threshold comparators per OCU."""
    return torch.std(y.to(torch.float32), dim=tuple(range(y.ndim - 1)), unbiased=False)


def effective_scale(entry: Dict, fan_in: int) -> torch.Tensor:
    """THE per-OCU effective-scale fold: calibration BN std folded into the
    TWN alpha, or a 1/sqrt(fan-in) normalization without calibration — the
    reference's float32 expression, term for term."""
    if "bn_sd" in entry:
        return entry["scale"] / (entry["bn_sd"] + _BN_EPS)
    scale = entry["scale"]
    return scale / torch.sqrt(torch.tensor(float(fan_in), dtype=torch.float32,
                                           device=scale.device))


def _ternarize(y: torch.Tensor, threshold) -> torch.Tensor:
    return torch.where(y.abs() > threshold, torch.sign(y), torch.zeros_like(y))


def _dispatch_conv(x, packed, eff_scale, backend: str, *, threshold=0.5, pool: int = 0):
    """One SAME ternary conv through the selected backend.  ``x`` must be
    channel-padded to 4 * packed.shape[2].  "fused" runs the whole CUTIE
    layer — conv, per-OCU scale, threshold unit, optional max-pool — in one
    launch and emits int8 trits; "kernel" (the same kernel unfused) and
    "ref" return the scaled float32 accumulator and leave ternarize/pool to
    the caller.  "bitsim" walks the plan's tiles itself and never comes
    here."""
    check_backend(backend)
    if backend == "ref":
        return ternary_conv2d_ref(x, packed, eff_scale)
    if backend == "kernel":
        return ternary_conv2d(x, packed, eff_scale, out_dtype=torch.float32)
    if backend != "fused":
        raise ValueError(f"backend {backend!r} has no single-conv dispatch")
    return ternary_conv2d(
        x, packed, eff_scale, fuse_ternary=True, threshold=threshold,
        fuse_pool=pool, out_dtype=torch.int8,
    )


def _moved(tables, device):
    """``tables`` with every tensor copied to ``device``, keys in order."""
    if isinstance(tables, dict):
        return {k: _moved(v, device) for k, v in tables.items()}
    if isinstance(tables, (list, tuple)):
        return type(tables)(_moved(v, device) for v in tables)
    return tables.to(device) if isinstance(tables, torch.Tensor) else tables


def _pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    if x.shape[-1] < c:
        x = F.pad(x, (0, c - x.shape[-1]))
    return x


def _ring_window(feats: torch.Tensor, tcn_steps: int) -> torch.Tensor:
    """[B, T, C] -> the [B, tcn_steps, C] window the ring memory would hold:
    the newest tcn_steps entries, left-padded with zero history."""
    t = feats.shape[1]
    if t > tcn_steps:
        return feats[:, -tcn_steps:]
    if t < tcn_steps:
        return F.pad(feats, (0, 0, tcn_steps - t, 0))
    return feats


class CutieProgram:
    """A compiled (validated) graph: init + QAT forward + quantization."""

    def __init__(self, graph: CutieGraph):
        self.graph = graph.validate()

    # -- parameters --------------------------------------------------------

    def init(self, generator: torch.Generator, learn_thresholds=False,
             device="cuda") -> Dict:
        """Kaiming-style float params, grouped by kind:
        {"conv": [{"w"}...], "tcn": [{"w"}...], "fc": {"w"}} — the
        reference's shapes and standard deviations.  The numbers are drawn
        from ``generator`` (a CPU `torch.Generator`) on the host and moved to
        ``device``, so a seed gives the same weights on every device; they
        are not the reference's `jax.random` numbers.

        ``learn_thresholds=True`` adds a ``"thresh"`` group — one scalar
        activation threshold per conv/tcn layer at the graph's
        ``act_threshold``; ``"per_channel"`` widens each to a [c_out]
        vector.  `quantize` folds them into the deploy tables."""
        dev = resolve_device(device)
        g = self.graph

        def normal(shape, std):
            return (torch.randn(shape, generator=generator, dtype=torch.float32)
                    * std).to(dev)

        convs = [l for l in g.layers if l.kind == "conv2d"]
        tcns = [l for l in g.layers if l.kind == "tcn"]
        fcs = [l for l in g.layers if l.kind == "fc"]
        p: Dict = {}
        if convs:
            p["conv"] = [
                {"w": normal((*l.kernel, l.c_in, l.c_out),
                             (2.0 / (l.kernel[0] * l.kernel[1] * l.c_in)) ** 0.5)}
                for l in convs
            ]
        if tcns:
            p["tcn"] = [
                {"w": normal((l.taps, l.c_in, l.c_out), (2.0 / (l.taps * l.c_in)) ** 0.5)}
                for l in tcns
            ]
        if fcs:
            (l,) = fcs
            p["fc"] = {"w": normal((l.c_in, l.c_out), 0.05)}
        if learn_thresholds not in (False, True, "per_channel"):
            raise ValueError(
                f"learn_thresholds={learn_thresholds!r}; expected False, True "
                "or 'per_channel'"
            )
        if learn_thresholds:
            per_ch = learn_thresholds == "per_channel"
            t0 = lambda l: torch.full(
                (l.c_out,) if per_ch else (), g.act_threshold,
                dtype=torch.float32, device=dev,
            )
            p["thresh"] = {}
            if convs:
                p["thresh"]["conv"] = [t0(l) for l in convs]
            if tcns:
                p["thresh"]["tcn"] = [t0(l) for l in tcns]
        return p

    # -- QAT interpreter ---------------------------------------------------

    def _qat_threshold(self, params: Dict, kind: str, idx: int):
        th = params.get("thresh")
        if th is None or kind not in th:
            return self.graph.act_threshold
        return clamp_threshold(th[kind][idx])

    def spatial_forward_qat(
        self, params: Dict, x: torch.Tensor, _record: Optional[List] = None,
        nu: Optional[float] = None,
    ) -> torch.Tensor:
        """The 2-D frontend on [B, H, W, C_in] with STE fake-quantized
        weights and activations — per frame for temporal graphs, the whole
        net (including fc) for spatial ones.  ``nu`` overrides the graph's
        TWN threshold factor."""
        g = self.graph
        nu = g.weight_nu if nu is None else nu
        ci = 0
        for l in g.spatial_layers:
            if l.kind == "conv2d":
                axis = (0, 1, 2) if g.qat_per_channel else None
                wq = ste_ternary_weights(params["conv"][ci]["w"], nu, axis)
                kh, kw = l.kernel
                top, left = (kh - 1) // 2, (kw - 1) // 2
                y = conv2d_nhwc(x, wq, (top, kh - 1 - top, left, kw - 1 - left))
                sd = _bn_sd(y)
                if _record is not None:
                    _record.append(sd)
                x = ste_ternary_acts(
                    y / (sd + _BN_EPS), self._qat_threshold(params, "conv", ci)
                )
                if l.stride > 1:
                    # stride = post-ternarize subsample (top-left phase)
                    x = x[:, :: l.stride, :: l.stride, :]
                ci += 1
            elif l.kind == "pool":
                x = _pool(x, l.window)
            elif l.kind == "global_pool":
                x = x.mean(dim=(1, 2))
            elif l.kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif l.kind == "fc":
                x = x @ ste_ternary_weights(params["fc"]["w"], nu,
                                            0 if g.qat_per_channel else None)
        return x

    def temporal_forward_qat(
        self, params: Dict, feats: torch.Tensor, _record: Optional[List] = None,
        nu: Optional[float] = None,
    ) -> torch.Tensor:
        """TCN head + classifier over the ordered window [B, T, C]; every
        dilated layer runs through the §4 wrap -> undilated 2-D conv ->
        unwrap mapping."""
        g = self.graph
        nu = g.weight_nu if nu is None else nu
        x = feats
        ti = 0
        for l in g.temporal_layers:
            if l.kind == "tcn":
                axis = (0, 1) if g.qat_per_channel else None
                wq = ste_ternary_weights(params["tcn"][ti]["w"], nu, axis)
                z = wrap_time_axis(x, l.dilation)
                y2 = conv2d_undilated(
                    z, project_weights_to_2d(wq, kh=l.kernel[0], kw=l.kernel[1])
                )
                y = unwrap_time_axis(y2, x.shape[1])
                sd = _bn_sd(y)
                if _record is not None:
                    _record.append(sd)
                x = ste_ternary_acts(
                    y / (sd + _BN_EPS), self._qat_threshold(params, "tcn", ti)
                )
                ti += 1
            elif l.kind == "last_step":
                x = x[:, -1, :]
            elif l.kind == "fc":
                x = x @ ste_ternary_weights(params["fc"]["w"], nu,
                                            0 if g.qat_per_channel else None)
        return x

    def forward_qat(
        self, params: Dict, x: torch.Tensor, nu: Optional[float] = None
    ) -> torch.Tensor:
        """Spatial graphs: [B, H, W, C] -> logits.  Temporal graphs: frames
        [B, T, H, W, C] -> logits over what the ring memory would hold."""
        g = self.graph
        if not g.is_temporal:
            return self.spatial_forward_qat(params, x, nu=nu)
        b, t = x.shape[:2]
        # per-frame statistics, as the reference's vmap over the time axis
        feats = torch.stack(
            [self.spatial_forward_qat(params, x[:, i], nu=nu) for i in range(t)], dim=1
        )
        return self.temporal_forward_qat(params, _ring_window(feats, g.tcn_steps), nu=nu)

    # -- quantization ------------------------------------------------------

    def quantize(
        self, params: Dict, calib: Optional[torch.Tensor] = None,
        nu: Optional[float] = None,
    ) -> "DeployedProgram":
        """QAT params -> packed 2-bit deploy tables, on the params' device.

        ``calib``: an example input batch.  When given, the QAT forward runs
        once recording each layer's BN std, which deployment folds into the
        per-OCU scale.  Without it, a 1/sqrt(fan-in) normalization keeps
        accumulations in range.  ``nu`` overrides the graph's TWN threshold
        factor; learned thresholds are clamped and folded into each entry's
        ``"threshold"``.  Runs under `torch.no_grad` (the tables are
        constants, never part of a training graph) and calibrates in the
        training numerics (`kernels.ref.deterministic_float32`: no TF32)."""
        with torch.no_grad(), deterministic_float32():
            return self._quantize(params, calib, nu)

    def _quantize(self, params: Dict, calib: Optional[torch.Tensor],
                  nu: Optional[float]) -> "DeployedProgram":
        g = self.graph
        nu = g.weight_nu if nu is None else nu
        tables: Dict = {"conv": [], "tcn": [], "fc": {}}
        thresholds = q.resolve_deploy_thresholds(g, params)
        pool_plan = g.conv_pool_plan()
        for li, lp in enumerate(params.get("conv", [])):
            packed, scale = q.quantize_pack_conv_weights(lp["w"], nu=nu)
            tables["conv"].append({
                "packed": packed, "scale": scale,
                "threshold": thresholds["conv"][li], "pool": pool_plan[li],
            })
        tcn_specs = [l for l in g.layers if l.kind == "tcn"]
        for ti, (lp, l) in enumerate(zip(params.get("tcn", []), tcn_specs)):
            packed, scale = q.quantize_pack_tcn_weights(
                lp["w"], nu=nu, kh=l.kernel[0], kw=l.kernel[1]
            )
            tables["tcn"].append({
                "packed": packed, "scale": scale, "dilation": l.dilation,
                "threshold": thresholds["tcn"][ti],
            })
        if "fc" in params:
            t, a = ternary_quantize_weights(params["fc"]["w"], nu=nu, axis=0)
            tables["fc"] = {"t": t, "scale": a.reshape(-1)}
        if calib is not None:
            spatial_rec: List = []
            temporal_rec: List = []
            if g.is_temporal:
                # pooled statistics over all frames, then over the window;
                # the same nu as the packed tables
                frames = calib.reshape(-1, *calib.shape[2:])
                feats = self.spatial_forward_qat(
                    params, frames, _record=spatial_rec, nu=nu
                )
                window = feats.reshape(calib.shape[0], calib.shape[1], -1)
                self.temporal_forward_qat(
                    params, _ring_window(window, g.tcn_steps),
                    _record=temporal_rec, nu=nu,
                )
            else:
                self.spatial_forward_qat(params, calib, _record=spatial_rec, nu=nu)
            for entry, sd in zip(tables["conv"], spatial_rec):
                entry["bn_sd"] = sd
            for entry, sd in zip(tables["tcn"], temporal_rec):
                entry["bn_sd"] = sd
        return DeployedProgram(g, tables)

    # -- silicon model -----------------------------------------------------

    def silicon_report(
        self, v: float = 0.5, hw: Optional[arch.CutieHW] = None,
        source: str = "analytic",
    ) -> "SiliconReport":
        """Cycles/energy for this graph at supply ``v`` — see module-level
        `silicon_report`.  ``source="sim"`` prices the `repro_torch.sim`
        execution plan instead of the closed formula."""
        return silicon_report(self.graph, v=v, hw=hw, source=source)


@dataclasses.dataclass
class DeployedProgram:
    """Packed 2-bit weights + the deploy interpreter over them.

    ``tables`` layout (the reference's):
      conv: [{"packed", "scale", "threshold", "pool", ("bn_sd")} ...]
      tcn:  [{"packed", "scale", "dilation", "threshold", ("bn_sd")} ...]
      fc:   {"t", "scale"}                          dense int8 trits

    The tables are immutable once built: the folded per-layer constants
    (effective scale, threshold vector) are computed from them once, on
    first use, and reused by every forward.
    """

    graph: CutieGraph
    tables: Dict

    @property
    def device(self) -> torch.device:
        """The device the deploy tables lie on; inputs must lie there too."""
        for kind in ("conv", "tcn"):
            if self.tables.get(kind):
                return self.tables[kind][0]["packed"].device
        return self.tables["fc"]["t"].device

    def to(self, device) -> "DeployedProgram":
        """This program with its tables on ``device`` (itself when they lie
        there already): a `SessionPool` block on another card runs it."""
        device = torch.device(device)
        if device == self.device:
            return self
        return DeployedProgram(self.graph, _moved(self.tables, device))

    # -- per-layer constants -----------------------------------------------

    def _threshold_operand(self, entry: Dict, c_out: int) -> torch.Tensor:
        thr = entry.get("threshold", self.graph.act_threshold)
        dev = entry["packed"].device
        if isinstance(thr, torch.Tensor) and thr.ndim > 0:
            return thr.to(device=dev, dtype=torch.float32)
        return torch.full((c_out,), float(thr), dtype=torch.float32, device=dev)

    def _constants(self) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Per weight layer ``(effective scale, [C_out] threshold)``, folded
        once through `effective_scale`.  Fan-in: kh*kw*padded C_in for conv
        layers, taps * UNPADDED C_in for TCN layers — the reference's two
        conventions, kept as they are."""
        consts = getattr(self, "_consts", None)
        if consts is not None:
            return consts
        g = self.graph
        conv_specs = [l for l in g.spatial_layers if l.kind == "conv2d"]
        tcn_specs = [l for l in g.temporal_layers if l.kind == "tcn"]
        consts = {"conv": [], "tcn": []}
        for entry, l in zip(self.tables["conv"], conv_specs):
            c_pad = 4 * entry["packed"].shape[2]
            eff = effective_scale(entry, l.kernel[0] * l.kernel[1] * c_pad)
            consts["conv"].append((eff, self._threshold_operand(entry, l.c_out)))
        for entry, l in zip(self.tables["tcn"], tcn_specs):
            eff = effective_scale(entry, l.taps * l.c_in)
            consts["tcn"].append((eff, self._threshold_operand(entry, l.c_out)))
        self._consts = consts
        return consts

    # -- the plan (repro_torch.sim) ----------------------------------------

    def _bitsim(self):
        """The lazily built `repro_torch.sim.PlanExecutor` behind
        backend="bitsim": graph lowered to an `ExecutionPlan`, packed tables
        bound as weight-memory images.  Cached — lowering is pure and the
        tables are immutable once quantized."""
        ex = getattr(self, "_bitsim_exec", None)
        if ex is None:
            from repro_torch.sim import PlanExecutor

            ex = self._bitsim_exec = PlanExecutor.for_deployed(self)
        return ex

    def execution_plan(self):
        """This program's compiled `ExecutionPlan` (see `repro_torch.sim.plan`)."""
        return self._bitsim().plan

    @property
    def kernel_blocks(self):
        """Plan-driven kernel blocks, ``{"conv": [KernelBlock], "tcn": [...]}``
        in table order (`kernels.autotune.kernel_block_plan` over the lowered
        plan).  In the port each ``block_cout`` is the layer's logical OCU
        tile: the CUDA kernels choose their own tiles and ignore it.  Cached."""
        kb = getattr(self, "_kernel_blocks", None)
        if kb is None:
            from repro_torch.kernels.autotune import kernel_block_plan
            from repro_torch.sim.plan import lower

            kb = self._kernel_blocks = kernel_block_plan(lower(self.graph))
        return kb

    # -- per-layer-kind execution -----------------------------------------

    def _fc(self, x: torch.Tensor) -> torch.Tensor:
        fc = self.tables["fc"]
        if not x.is_floating_point():
            x = x.to(torch.float32)  # fused backend hands int8 trits over
        # Dot the raw trits FIRST, scale per class AFTER — the OPU's order.
        # With ternary/dyadic inputs the x @ t reduction is integer-valued
        # and exact in float32 under ANY summation order, so slot p of a
        # P-wide batch reproduces a lone batch-1 session bit for bit.
        with exact_float32():
            y = x @ fc["t"].to(x.dtype)
        return y * fc["scale"]

    def spatial_forward(self, x: torch.Tensor, backend: str = "fused") -> torch.Tensor:
        """Frontend (or whole spatial net) on packed weights: [B,H,W,C] ->
        feature vector / logits.  On "fused" each conv layer is one launch
        (conv+scale+ternarize, plus the following pool layer sunk into the
        epilogue) emitting int8 trits — the pool LayerSpec it absorbed is
        then skipped here."""
        check_backend(backend)
        if backend == "bitsim":
            return self._bitsim().spatial_forward(x)
        g = self.graph
        consts = self._constants()["conv"]
        ci = 0
        fused_pools = 0
        for l in g.spatial_layers:
            if l.kind == "conv2d":
                entry = self.tables["conv"][ci]
                eff, thr = consts[ci]
                ci += 1
                x = _pad_channels(x, 4 * entry["packed"].shape[2])
                if backend == "fused":
                    pool = entry.get("pool", 0)
                    x = _dispatch_conv(x, entry["packed"], eff, backend,
                                       threshold=thr, pool=pool)
                    fused_pools += 1 if pool else 0
                else:
                    y = _dispatch_conv(x, entry["packed"], eff, backend)
                    x = _ternarize(y, thr)
                if l.stride > 1:
                    # post-ternarize subsample == strided conv
                    x = x[:, :: l.stride, :: l.stride, :]
            elif l.kind == "pool":
                if fused_pools:
                    fused_pools -= 1
                else:
                    x = _pool(x, l.window)
            elif l.kind == "global_pool":
                # int8 trits have no mean in PyTorch: average in float32
                x = x.to(torch.float32).mean(dim=(1, 2))
            elif l.kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif l.kind == "fc":
                x = self._fc(x)
        return x

    def temporal_forward(self, feats: torch.Tensor, backend: str = "fused") -> torch.Tensor:
        """TCN head over the ordered window [B, T, C] -> logits, via the §4
        mapping + the 2-D conv kernel (SAME pad adjusted to causal)."""
        check_backend(backend)
        if backend == "bitsim":
            return self._bitsim().temporal_forward(feats)
        g = self.graph
        x = feats
        consts = self._constants()["tcn"]
        tcn_specs = (l for l in g.temporal_layers if l.kind == "tcn")
        for entry, l, (eff, thr) in zip(self.tables["tcn"], tcn_specs, consts):
            z = wrap_time_axis(x, entry["dilation"])
            # the kernel runs SAME (top pad (kh-1)//2); add the rest of the
            # causal (kh-1) pad, and pad the channels to the pack quantum
            kh = l.kernel[0]
            c_pad = 4 * entry["packed"].shape[2]
            zp = F.pad(z, (0, max(c_pad - z.shape[-1], 0), 0, 0,
                           (kh - 1) - (kh - 1) // 2, 0))
            if backend == "fused":
                y2 = _dispatch_conv(zp, entry["packed"], eff, backend,
                                    threshold=thr)[:, : z.shape[1]]
                x = unwrap_time_axis(y2, x.shape[1])
            else:
                y2 = _dispatch_conv(zp, entry["packed"], eff, backend)[:, : z.shape[1]]
                x = _ternarize(unwrap_time_axis(y2, x.shape[1]), thr)
        for l in g.temporal_layers:
            if l.kind == "last_step":
                x = x[:, -1, :]
            elif l.kind == "fc":
                x = self._fc(x)
        return x

    def forward(self, x: torch.Tensor, backend: str = "fused") -> torch.Tensor:
        """Whole-network deploy inference.  Spatial graphs: [B,H,W,C] ->
        logits.  Temporal graphs: frames [B,T,H,W,C] -> logits over the
        ring window (last tcn_steps frames, zero history on the left) —
        bit-identical to streaming the frames through ``stream()``.  The
        time axis is folded into the batch for the frontend."""
        check_backend(backend)
        g = self.graph
        if not g.is_temporal:
            return self.spatial_forward(x, backend)
        b, t = x.shape[:2]
        feats = self.spatial_forward(x.reshape(b * t, *x.shape[2:]), backend)
        feats = feats.reshape(b, t, -1)
        return self.temporal_forward(_ring_window(feats, g.tcn_steps), backend)

    # -- streaming (the silicon's autonomous mode) ------------------------

    def stream_step(
        self, stream: TCNStream, frame: torch.Tensor, backend: str = "fused"
    ) -> Tuple[torch.Tensor, TCNStream]:
        """Pure-functional step: one sensor frame -> (logits, new stream).
        CNN frontend -> push the feature vector into the ring -> TCN head
        over the ordered window; past frames are never recomputed."""
        check_backend(backend)
        feat = self.spatial_forward(frame, backend)
        stream = stream.push(feat.to(stream.buf.dtype))
        window = stream.ordered()
        if window.ndim == 2:
            window = window[None]
        return self.temporal_forward(window, backend), stream

    def stream(self, batch: Optional[int] = None, backend: str = "fused",
               jit: bool = True) -> "StreamSession":
        """Open a stateful streaming session over this program's TCN ring
        (temporal graphs only): ``session.step(frame)`` per sensor frame;
        ``jit`` as in `StreamSession`."""
        if not self.graph.is_temporal:
            raise ValueError(f"{self.graph.name} has no TCN memory to stream into")
        return StreamSession(self, batch=batch, backend=backend, jit=jit)

    def serve(self, pool_size: int, backend: str = "fused", **kwargs):
        """Multi-sensor serving: a `repro_torch.serving.SessionPool` of
        ``pool_size`` slots over this program — one fixed-batch step,
        streams admitted/evicted mid-flight (continuous batching).  Keyword
        arguments pass through to the pool (``jit``, ``tracer``,
        ``sharding``)."""
        from repro_torch.serving import SessionPool

        return SessionPool(self, pool_size, backend=backend, **kwargs)

    def serve_fleet(self, name: Optional[str] = None, backend: str = "fused",
                    **kwargs):
        """Fleet serving: a `repro_torch.serving.FleetRouter` with this
        program registered under ``name`` (the graph name by default).
        Register further nets on the returned router to serve many tenants
        — bucketed pools, bounded admission FIFOs, ladder autoscaling,
        async ingestion, optional activity gating."""
        from repro_torch.serving import FleetRouter

        router = FleetRouter(backend=backend, **kwargs)
        router.register(name or self.graph.name, self)
        return router

    # -- artifact export (repro_torch.artifact) ----------------------------

    def to_artifact_bytes(self) -> bytes:
        """Assemble this program into ``.cutie`` container bytes — the
        compiled plan + the packed deploy tables, verbatim.
        ``artifact.loads`` gives back a `LoadedProgram` that executes,
        streams and serves bit-identically with no graph."""
        from repro_torch.artifact import assemble

        return assemble(self)

    def save_artifact(self, path) -> int:
        """Write the ``.cutie`` artifact to ``path``; returns byte count."""
        from repro_torch.artifact import save

        return save(self, path)

    # -- silicon model -----------------------------------------------------

    def silicon_report(
        self, v: float = 0.5, hw: Optional[arch.CutieHW] = None,
        source: str = "analytic",
    ) -> "SiliconReport":
        """Cycles/energy for the deployed graph at supply ``v`` — see
        module-level `silicon_report`.  ``source="sim"`` prices the same
        `ExecutionPlan` the bitsim backend executes, with dynamic energy
        priced on THIS program's packed weight images (sparsity-aware)."""
        memory = self._bitsim().memory if source == "sim" else None
        return silicon_report(self.graph, v=v, hw=hw, source=source, memory=memory)


class StreamSession:
    """Stateful wrapper over the TCN ring memory (24 x C x 2 bit SCM).

    ``step(frame)`` returns the per-frame logits and advances the ring.  The
    whole session state is ONE `StreamState` (ring + monotonic frame
    counter), so it moves wholesale: `export_state()` hands out a copy,
    `load_state()` copies one in, and a `SessionPool` scatters it into (or
    gathers it out of) a slot of the pooled ``[P, T, C]`` state — a session
    can hop between standalone and pooled execution with bit-identical
    logits.  The state lies on the program's device, in tensors that keep
    their addresses for the session's life: each step, `reset` and
    `load_state` write into them.

    ``jit`` is the reference's switch.  On a CUDA device with ``jit=True``
    (the default) the first step runs eagerly and then captures the step as
    a CUDA graph over the state and a static frame buffer of that first
    frame's shape (`repro_torch.capture.CapturedStep`); later steps copy
    the frame in and replay the graph, and a frame of another shape or
    dtype raises.  On the CPU, or with ``jit=False``, each step runs
    eagerly.
    """

    def __init__(self, deployed: DeployedProgram, batch: Optional[int] = None,
                 backend: str = "fused", jit: bool = True):
        from repro_torch.capture import CapturedStep

        check_backend(backend)
        self.deployed = deployed
        self.backend = backend
        self.batch = batch
        self.jit = jit
        g = deployed.graph
        self.state = StreamState.create(
            g.tcn_steps, g.feature_channels, batch=batch, device=deployed.device,
        )
        self._frame: Optional[torch.Tensor] = None
        self._step = CapturedStep(self._run_step, deployed.device, capture=jit)

    def _run_step(self) -> torch.Tensor:
        logits, ring = self.deployed.stream_step(self.state.ring, self._frame, self.backend)
        self.state.ring.buf.copy_(ring.buf)
        self.state.ring.cursor.copy_(ring.cursor)
        self.state.steps_seen.add_(1)
        return logits

    @property
    def steps_seen(self) -> int:
        """Frames absorbed since creation/reset; monotonic across the ring
        cursor's wrap.  Reading it waits for the device."""
        return int(self.state.steps_seen)

    @property
    def window_warm(self) -> bool:
        """True once the full tcn_steps window holds real (non-pad) frames."""
        return self.steps_seen >= self.deployed.graph.tcn_steps

    @property
    def trace_count(self) -> int:
        """Captures of the step on the card (``jit=True``), step builds
        elsewhere: 0 before the first step, then 1."""
        return self._step.builds

    @property
    def captured(self) -> bool:
        """True once the step is a captured CUDA graph."""
        return self._step.captured

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """Absorb one sensor frame ([H,W,C] or [B,H,W,C]) and return the
        per-frame logits; the ring advances."""
        if frame.ndim == 3:
            frame = frame[None]
        if not self._step.capture:
            self._frame = frame
        elif self._frame is None:
            self._frame = frame.to(self.deployed.device, copy=True)
        elif frame.shape != self._frame.shape or frame.dtype != self._frame.dtype:
            raise ValueError(
                f"frame {tuple(frame.shape)} {frame.dtype}: this session's "
                f"captured step takes {tuple(self._frame.shape)} {self._frame.dtype}"
            )
        else:
            self._frame.copy_(frame)
        return self._step()

    def reset(self) -> None:
        """Forget all history: zero ring, frame counter back to 0."""
        self.state.ring.buf.zero_()
        self.state.ring.cursor.zero_()
        self.state.steps_seen.zero_()

    # -- state as a first-class value -------------------------------------

    def export_state(self) -> StreamState:
        """A copy of the session's complete state (share/checkpoint/admit
        into a `SessionPool` via ``pool.admit(sid, state=...)``); later
        steps never show through it."""
        s = self.state
        return StreamState(
            ring=TCNStream(buf=s.ring.buf.clone(), cursor=s.ring.cursor.clone()),
            steps_seen=s.steps_seen.clone(),
        )

    def load_state(self, state: StreamState) -> None:
        """Resume from an exported/evicted state, copied into the session's
        own tensors.  Shape-checked against this session's ring geometry."""
        expect = self.state.ring.buf.shape
        if state.ring.buf.shape != expect:
            raise ValueError(
                f"state ring shape {tuple(state.ring.buf.shape)} != session "
                f"{tuple(expect)}"
            )
        self.state.ring.buf.copy_(state.ring.buf)
        self.state.ring.cursor.copy_(state.ring.cursor)
        self.state.steps_seen.copy_(state.steps_seen)


# ---------------------------------------------------------------------------
# Graph -> analytical silicon model (core.cutie_arch)
# ---------------------------------------------------------------------------

def export_conv_layers(
    graph: CutieGraph,
    repeat_frontend: Optional[int] = None,
    hw: Optional[arch.CutieHW] = None,
) -> List[arch.ConvLayer]:
    """Lower the graph to the layer list of the analytic silicon model: a
    view over THE one lowering path (`sim.lower` -> `ExecutionPlan
    .to_arch_layers`).  Temporal graphs count ``passes_per_inference``
    frontend passes per classification; TCN layers appear in their §4
    mapped 2-D form."""
    from repro_torch.sim.plan import lower

    return lower(graph, hw).to_arch_layers(repeat_frontend)


@dataclasses.dataclass
class SiliconReport:
    """The closed loop: graph -> cycles/energy -> paper's measured corner.

    ``ideal`` is the uncalibrated schedule — the analytic pixel-per-cycle
    formula (``source="analytic"``) or the sim plan's counted cycles
    (``source="sim"``); ``calibrated`` projects it onto the measured silicon
    through the published (inf/s, uJ) corner, and
    ``calibration.consistent`` is the model's validity check."""

    graph_name: str
    v: float
    ideal: arch.NetReport
    calibration: Optional[arch.Calibration]
    calibrated: Optional[arch.NetReport]
    source: str = "analytic"

    @property
    def report(self) -> arch.NetReport:
        return self.calibrated if self.calibrated is not None else self.ideal

    @property
    def energy_uj(self) -> float:
        return self.report.energy_j * 1e6

    @property
    def inf_per_s(self) -> float:
        return self.report.inf_per_s

    @property
    def eff_topsw(self) -> float:
        return self.report.eff_topsw_paper

    @property
    def peak_eff_topsw(self) -> float:
        return self.ideal.peak_layer_eff_topsw_paper

    def summary(self) -> str:
        """Human-readable report block (the launchers print this)."""
        lines = [
            f"[{self.graph_name} @ {self.v:.2f} V, {self.source} schedule]",
            f"  peak efficiency : {self.peak_eff_topsw:8.0f} TOp/s/W",
            f"  energy/inference: {self.energy_uj:8.2f} uJ"
            + ("" if self.calibrated is not None else " (ideal schedule)"),
            f"  inference rate  : {self.inf_per_s:8.0f} inf/s",
            f"  avg efficiency  : {self.eff_topsw:8.1f} TOp/s/W",
        ]
        if self.calibration is not None:
            lines.append(
                f"  calibration     : cycle x{self.calibration.cycle_overhead:.2f}, "
                f"energy x{self.calibration.energy_overhead:.2f}, "
                f"consistent={self.calibration.consistent}"
            )
        return "\n".join(lines)


def silicon_report_from_plan(
    plan, v: float = 0.5, hw: Optional[arch.CutieHW] = None,
    source: str = "analytic", memory=None,
    paper_energy_uj: Optional[float] = None,
    paper_inf_per_s: Optional[float] = None,
) -> SiliconReport:
    """The graph-free Table-1 loop: price a compiled `ExecutionPlan`.

    ``source="sim"`` counts the plan's schedule (stall counters included);
    a `repro_torch.sim.WeightMemory` in ``memory`` additionally prices
    dynamic energy on the program's measured weight sparsity.
    ``source="analytic"`` projects the plan onto the closed formula.  The
    paper corner (when given) calibrates at the 0.5 V measurement point."""
    if source not in SILICON_SOURCES:
        raise ValueError(
            f"unknown silicon source {source!r}; expected one of {SILICON_SOURCES}"
        )
    hw = hw or arch.CutieHW()
    if source == "sim":
        from repro_torch.sim import evaluate_plan

        def _eval(at_v: float) -> arch.NetReport:
            return evaluate_plan(plan, hw, at_v, memory=memory)
    else:
        layers = plan.to_arch_layers()

        def _eval(at_v: float) -> arch.NetReport:
            return arch.evaluate_network(plan.graph_name, layers, hw, at_v)

    ideal = _eval(v)
    cal = calibrated = None
    if paper_energy_uj is not None and paper_inf_per_s is not None:
        cal = arch.calibrate(_eval(0.5), paper_inf_per_s, paper_energy_uj)
        calibrated = arch.apply_calibration(ideal, cal)
    return SiliconReport(
        graph_name=plan.graph_name, v=v, ideal=ideal, calibration=cal,
        calibrated=calibrated, source=source,
    )


def silicon_report(
    graph: CutieGraph, v: float = 0.5, hw: Optional[arch.CutieHW] = None,
    source: str = "analytic", memory=None,
) -> SiliconReport:
    """Evaluate the CUTIE silicon model on this graph and, when the graph
    carries a published corner, calibrate against it at 0.5 V.

    ``source``: ``"analytic"`` is the closed pixel-per-cycle formula over
    `export_conv_layers`; ``"sim"`` lowers the graph to its
    `repro_torch.sim.ExecutionPlan` and ingests the simulator's per-layer
    cycle counters — same electrical model, auditable schedule.  ``memory``
    (a `repro_torch.sim.WeightMemory`, sim source only) switches dynamic
    energy to the program's measured weight sparsity."""
    if source not in SILICON_SOURCES:
        raise ValueError(
            f"unknown silicon source {source!r}; expected one of {SILICON_SOURCES}"
        )
    hw = hw or arch.CutieHW()
    from repro_torch.sim.plan import lower

    return silicon_report_from_plan(
        lower(graph, hw), v=v, hw=hw, source=source, memory=memory,
        paper_energy_uj=graph.paper_energy_uj,
        paper_inf_per_s=graph.paper_inf_per_s,
    )
