"""`CutieProgram` — one network definition, every execution mode of the port.

Counterpart of `repro.api.program`:

    prog     = get_net("dvs_cnn_tcn")                       # repro_torch.api.registry
    params   = prog.init(torch.Generator().manual_seed(0))  # device="cuda"
    deployed = prog.quantize(params, calib=frames)          # packed 2-bit weights
    logits   = deployed.forward(frames, backend="fused")    # | "ref"
    session  = deployed.stream(batch=4)                     # TCN ring memory
    pool     = deployed.serve(pool_size=8)                  # continuous batching

Backends of the port so far:
    fused   one launch of the fused ternary conv per layer
            (conv + scale + ternarize (+ max-pool), int8 trits between
            layers): the hand-written CUDA kernel for tensors on the card,
            its plain PyTorch version for tensors on the CPU — the deploy
            default for serving
    ref     the `kernels.ref` oracle (unpack + `F.conv2d`), float activations
            re-ternarized between layers — the semantics anchor

Both produce identical logits — bit-exact whenever every inter-layer tensor
is ternary or a dyadic rational of ternary values (true for all registry
nets), since both then accumulate exactly in float32 under any summation
order.  The reference's other backends ("pallas", "interpret", "bitsim") and
`silicon_report` wait for later parts of the port; `check_backend` says so.

The QAT half here is **forward only** (`quantize(calib=...)` needs the
fake-quant forward to record the batch-norm statistics); training arrives
with the STE backward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.api import quantize as q
from repro_torch.api.graph import CutieGraph
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
from repro_torch.kernels.ref import exact_float32, ternary_conv2d_ref

BACKENDS = ("fused", "ref")
_LATER_BACKENDS = {
    "pallas": "the unfused kernel backend is not part of the port yet",
    "interpret": "the Pallas interpreter has no counterpart in the port",
    "bitsim": "the plan-executor backend arrives with the simulator port "
              "(ROADMAP.md, queue 1: sim + cutie_arch)",
}
_BN_EPS = 1e-6


def check_backend(backend: str) -> None:
    """THE backend validation — every entry point routes through here."""
    if backend in BACKENDS:
        return
    if backend in _LATER_BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not available in repro_torch: "
            f"{_LATER_BACKENDS[backend]}; expected one of {BACKENDS}"
        )
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def _pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max pool, window == stride, VALID, on [B,H,W,C].  Integer trits (the
    fused backend's int8 maps) are pooled in float32 and cast back."""
    b, h, w, c = x.shape
    oh, ow = h // window, w // window
    y = x[:, : oh * window, : ow * window].to(torch.float32)
    y = y.reshape(b, oh, window, ow, window, c).amax(dim=(2, 4))
    return y.to(x.dtype)


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
    launch and emits int8 trits; "ref" returns the scaled float accumulator
    and leaves ternarize/pool to the caller."""
    check_backend(backend)
    if backend == "ref":
        return ternary_conv2d_ref(x, packed, eff_scale)
    return ternary_conv2d(
        x, packed, eff_scale, fuse_ternary=True, threshold=threshold,
        fuse_pool=pool, out_dtype=torch.int8,
    )


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
    """A compiled (validated) graph: init + QAT forward values + quantization."""

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

    # -- QAT interpreter (forward values only) -----------------------------

    def _qat_threshold(self, params: Dict, kind: str, idx: int):
        th = params.get("thresh")
        if th is None or kind not in th:
            return self.graph.act_threshold
        return clamp_threshold(th[kind][idx])

    def spatial_forward_qat(
        self, params: Dict, x: torch.Tensor, _record: Optional[List] = None,
        nu: Optional[float] = None,
    ) -> torch.Tensor:
        """The 2-D frontend on [B, H, W, C_in] with fake-quantized weights
        and activations (forward values; no gradient path yet).  ``nu``
        overrides the graph's TWN threshold factor."""
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
        ``"threshold"``."""
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

    def stream(self, batch: Optional[int] = None, backend: str = "fused") -> "StreamSession":
        """Open a stateful streaming session over this program's TCN ring
        (temporal graphs only): ``session.step(frame)`` per sensor frame."""
        if not self.graph.is_temporal:
            raise ValueError(f"{self.graph.name} has no TCN memory to stream into")
        return StreamSession(self, batch=batch, backend=backend)

    def serve(self, pool_size: int, backend: str = "fused"):
        """Multi-sensor serving: a `repro_torch.serving.SessionPool` of
        ``pool_size`` slots over this program — one fixed-batch step,
        streams admitted/evicted mid-flight (continuous batching)."""
        from repro_torch.serving import SessionPool

        return SessionPool(self, pool_size, backend=backend)


class StreamSession:
    """Stateful wrapper over the TCN ring memory (24 x C x 2 bit SCM).

    ``step(frame)`` returns the per-frame logits and advances the ring.  The
    whole session state is ONE `StreamState` (ring + monotonic frame
    counter), so it moves wholesale: `export_state()` hands it out,
    `load_state()` takes it back, and a `SessionPool` scatters it into (or
    gathers it out of) a slot of the pooled ``[P, T, C]`` state — a session
    can hop between standalone and pooled execution with bit-identical
    logits.  The state lies on the program's device.
    """

    def __init__(self, deployed: DeployedProgram, batch: Optional[int] = None,
                 backend: str = "fused"):
        check_backend(backend)
        self.deployed = deployed
        self.backend = backend
        self.batch = batch
        self.reset()

    @property
    def steps_seen(self) -> int:
        """Frames absorbed since creation/reset; monotonic across the ring
        cursor's wrap.  Reading it waits for the device."""
        return int(self.state.steps_seen)

    @property
    def window_warm(self) -> bool:
        """True once the full tcn_steps window holds real (non-pad) frames."""
        return self.steps_seen >= self.deployed.graph.tcn_steps

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """Absorb one sensor frame ([H,W,C] or [B,H,W,C]) and return the
        per-frame logits; the ring advances."""
        if frame.ndim == 3:
            frame = frame[None]
        logits, ring = self.deployed.stream_step(self.state.ring, frame, self.backend)
        self.state = StreamState(ring=ring, steps_seen=self.state.steps_seen + 1)
        return logits

    def reset(self) -> None:
        """Forget all history: fresh zero ring, frame counter back to 0."""
        g = self.deployed.graph
        self.state = StreamState.create(
            g.tcn_steps, g.feature_channels, batch=self.batch,
            device=self.deployed.device,
        )

    # -- state as a first-class value -------------------------------------

    def export_state(self) -> StreamState:
        """The session's complete state (share/checkpoint/admit into a
        `SessionPool` via ``pool.admit(sid, state=...)``)."""
        return self.state

    def load_state(self, state: StreamState) -> None:
        """Resume from an exported/evicted state.  Shape-checked against
        this session's ring geometry."""
        expect = self.state.ring.buf.shape
        if state.ring.buf.shape != expect:
            raise ValueError(
                f"state ring shape {tuple(state.ring.buf.shape)} != session "
                f"{tuple(expect)}"
            )
        self.state = state
