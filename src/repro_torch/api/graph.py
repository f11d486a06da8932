"""Declarative ternary-network description — the input to `CutieProgram`.

A `CutieGraph` is a flat, ordered tuple of `LayerSpec`s over the layer kinds
the CUTIE datapath executes:

  * ``conv2d``      — SAME ternary convolution (the OCU array's native op;
                      3x3 by default, 1x1 for pointwise layers, and an
                      optional output ``stride`` realized as a post-ternarize
                      subsample so every backend shares one conv kernel)
  * ``pool``        — 2x2 max pool (the silicon's inter-layer pooling unit)
  * ``global_pool`` — spatial global average (DVS frontend -> feature vector)
  * ``flatten``     — [B,H,W,C] -> [B,H*W*C] (CIFAR head)
  * ``tcn``         — dilated causal 1-D conv, executed through the paper's
                      §4 mapping onto the *same* undilated 2-D conv engine
  * ``last_step``   — take the newest time step of a [B,T,C] sequence
  * ``fc``          — ternary-weight classifier matmul

The split between *spatial* layers (everything before the first temporal
kind) and *temporal* layers mirrors the silicon: the 2-D CNN frontend runs
once per sensor frame, pushes one feature vector into the 24-step TCN ring
memory, and the TCN head classifies over the ordered window.  A graph with
no temporal layers (CIFAR) is a plain one-shot classifier.

This is the port's own copy of `repro.api.graph` (plain Python, no tensor
library): the port imports nothing from the reference package.  The graph
is also what the analytical silicon model will lower from once
`core.cutie_arch` and `sim` are ported.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

_TEMPORAL_KINDS = ("tcn", "last_step")
_WEIGHT_KINDS = ("conv2d", "tcn", "fc")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One CUTIE-mappable layer.  Only the fields relevant to ``kind`` are
    meaningful; use the constructor helpers (`conv2d`, `pool`, ...) below."""

    kind: str
    c_in: int = 0
    c_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    taps: int = 3        # tcn: 1-D kernel taps (must fit kernel height)
    dilation: int = 1    # tcn: dilation D
    window: int = 2      # pool: window/stride
    stride: int = 1      # conv2d: output stride (post-ternarize subsample)

    @property
    def has_weights(self) -> bool:
        return self.kind in _WEIGHT_KINDS


def conv2d(
    c_in: int, c_out: int, kernel: Tuple[int, int] = (3, 3), stride: int = 1
) -> LayerSpec:
    """SAME ternary 2-D convolution — the OCU array's native op.  ``kernel``
    may be ``(1, 1)`` for a pointwise layer.  ``stride > 1`` subsamples the
    ternarized output (top-left phase) — because ternarization is
    elementwise, subsampling after it is bit-identical to a strided conv,
    so all backends reuse the one SAME-conv kernel.  A strided conv never
    absorbs a following pool (`CutieGraph.conv_pool_plan`)."""
    return LayerSpec(kind="conv2d", c_in=c_in, c_out=c_out, kernel=kernel,
                     stride=stride)


def pool(window: int = 2) -> LayerSpec:
    """Max pool, window == stride — the silicon's inter-layer pooling unit
    (a pool directly after a conv2d is sunk into the fused kernel epilogue,
    see `CutieGraph.conv_pool_plan`)."""
    return LayerSpec(kind="pool", window=window)


def global_pool() -> LayerSpec:
    """Spatial global average: [B,H,W,C] -> [B,C] (the DVS frontend's
    feature-vector reduction before the TCN ring)."""
    return LayerSpec(kind="global_pool")


def flatten() -> LayerSpec:
    """[B,H,W,C] -> [B, H*W*C] (the CIFAR head's layout change)."""
    return LayerSpec(kind="flatten")


def tcn(c_in: int, c_out: int, dilation: int, taps: int = 3) -> LayerSpec:
    """Dilated causal 1-D conv, executed through the paper's §4 mapping on
    the same undilated 2-D engine (``taps`` must fit the kernel height)."""
    return LayerSpec(kind="tcn", c_in=c_in, c_out=c_out, dilation=dilation, taps=taps)


def last_step() -> LayerSpec:
    """Take the newest time step of a [B,T,C] sequence (TCN head -> FC)."""
    return LayerSpec(kind="last_step")


def fc(c_in: int, c_out: int) -> LayerSpec:
    """Ternary-weight classifier matmul (the OPU: integer accumulate, then
    per-class scale)."""
    return LayerSpec(kind="fc", c_in=c_in, c_out=c_out)


@dataclasses.dataclass(frozen=True)
class CutieGraph:
    """A full network: layers + input geometry + deployment metadata.

    ``passes_per_inference``: CNN frontend passes per classification — the
    DVS network of [6] feeds 5 frames into the TCN memory per label, and the
    silicon model must count those cycles (the TCN memory is exactly what
    makes the *other* 19 window steps free).

    ``paper_energy_uj`` / ``paper_inf_per_s``: the measured silicon corner
    this network calibrates against (None = no published numbers; the
    silicon report is then ideal-schedule only).
    """

    name: str
    layers: Tuple[LayerSpec, ...]
    input_hw: Tuple[int, int]
    input_ch: int
    n_classes: int
    act_threshold: float = 0.5
    weight_nu: float = 0.7
    # QAT quantization granularity.  False: one TWN threshold/scale per layer
    # (the legacy training recipe).  True: the per-output-channel grid the
    # deployment tables use — forward_qat then matches deployed.forward on
    # the ref backend to float round-off when quantize() is calibrated.
    qat_per_channel: bool = False
    tcn_steps: int = 24
    passes_per_inference: int = 1
    paper_energy_uj: Optional[float] = None
    paper_inf_per_s: Optional[float] = None

    # -- structure ---------------------------------------------------------

    @property
    def is_temporal(self) -> bool:
        return any(l.kind in _TEMPORAL_KINDS for l in self.layers)

    def _split(self) -> int:
        for i, l in enumerate(self.layers):
            if l.kind in _TEMPORAL_KINDS:
                return i
        return len(self.layers)

    @property
    def spatial_layers(self) -> Tuple[LayerSpec, ...]:
        """The 2-D frontend (everything executed per frame)."""
        return self.layers[: self._split()]

    @property
    def temporal_layers(self) -> Tuple[LayerSpec, ...]:
        """TCN head + classifier, operating on the [B, T, C] window."""
        return self.layers[self._split():]

    def conv_pool_plan(self) -> Tuple[int, ...]:
        """Per spatial conv2d, the window of an *immediately following* pool
        layer (0 when the conv feeds anything else) — the fusion plan the
        deploy backends use to sink CUTIE's pooling unit into the conv
        kernel's epilogue.  Length == number of spatial conv2d layers."""
        sp = self.spatial_layers
        plan: List[int] = []
        for i, l in enumerate(sp):
            if l.kind != "conv2d":
                continue
            nxt = sp[i + 1] if i + 1 < len(sp) else None
            fuse = (nxt is not None and nxt.kind == "pool" and l.stride == 1)
            plan.append(nxt.window if fuse else 0)
        return tuple(plan)

    @property
    def feature_channels(self) -> int:
        """Width of the feature vector entering the TCN memory (temporal
        graphs only) — the silicon's ring is tcn_steps x this x 2 bit."""
        for l in self.temporal_layers:
            if l.kind == "tcn":
                return l.c_in
        raise ValueError(f"{self.name}: no tcn layer")

    # -- validation --------------------------------------------------------

    def validate(self) -> "CutieGraph":
        """Shape-chain the graph; raises ValueError on inconsistency."""
        h, w = self.input_hw
        c = self.input_ch
        seen_temporal = False
        flat: Optional[int] = None  # features after flatten, None otherwise
        for i, l in enumerate(self.layers):
            where = f"{self.name} layer {i} ({l.kind})"
            if l.kind in _TEMPORAL_KINDS:
                seen_temporal = True
            elif seen_temporal and l.kind != "fc":
                raise ValueError(f"{where}: spatial layer after temporal layers")
            if l.kind == "conv2d":
                if l.c_in != c:
                    raise ValueError(f"{where}: c_in {l.c_in} != incoming {c}")
                if l.stride < 1:
                    raise ValueError(f"{where}: stride {l.stride} < 1")
                if l.stride > 1 and (h % l.stride or w % l.stride):
                    raise ValueError(
                        f"{where}: {h}x{w} not divisible by stride {l.stride}"
                    )
                h, w = h // l.stride, w // l.stride
                c = l.c_out
            elif l.kind == "pool":
                if h % l.window or w % l.window:
                    raise ValueError(f"{where}: {h}x{w} not divisible by {l.window}")
                h, w = h // l.window, w // l.window
            elif l.kind == "global_pool":
                h = w = 1
            elif l.kind == "flatten":
                flat = h * w * c
            elif l.kind == "tcn":
                if l.c_in != c:
                    raise ValueError(f"{where}: c_in {l.c_in} != incoming {c}")
                if l.taps > l.kernel[0]:
                    raise ValueError(f"{where}: {l.taps} taps exceed kernel height")
                c = l.c_out
            elif l.kind == "last_step":
                pass
            elif l.kind == "fc":
                expect = flat if flat is not None else c
                if l.c_in != expect:
                    raise ValueError(f"{where}: c_in {l.c_in} != incoming {expect}")
                c = l.c_out
            else:
                raise ValueError(f"{where}: unknown layer kind")
        if c != self.n_classes:
            raise ValueError(
                f"{self.name}: final width {c} != n_classes {self.n_classes}"
            )
        return self
