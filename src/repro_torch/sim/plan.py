"""Lowering: `CutieGraph` -> `ExecutionPlan` — the CUTIE compiler.

The port's own copy of `repro.sim.plan` (plain Python): the same walk, so a
plan's ``to_dict()`` equals the reference's for every registry net.

The plan is the explicit schedule the silicon executes and the single
lowering path in the package: `api.program.export_conv_layers` derives the
analytic model's layer list from it (`ExecutionPlan.to_arch_layers`), the
``bitsim`` backend executes it (`sim.execute`), and `sim.counters` prices it.

Per weight-carrying layer the plan records the layer geometry (SAME conv on
[H, W], the §4-mapped [Q=ceil(T/D), D] form for TCN layers, the OPU matmul
view for the classifier) and the **tile assignment**: CUTIE's OCU array
computes ``n_ocu`` output channels from ``max_cin`` input channels per
cycle, so a layer wider than the array is tiled into
``ceil(c_out/n_ocu) * ceil(c_in/max_cin)`` sequential (cout, cin) tile
passes — each `TileAssign` names the exact channel ranges of one pass and
the slice of the trit-packed weight image it consumes.

A conv layer immediately followed by a ``pool`` absorbs it (``pool`` field),
mirroring the silicon's in-pipeline pooling unit and the fused deploy
backend (`CutieGraph.conv_pool_plan`).

Plans serialize losslessly (`to_dict`/`from_dict`) — the round trip is
pinned in tests/test_torch_sim.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.api.graph import CutieGraph
from repro_torch.core import cutie_arch as arch


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class TileAssign:
    """One sequential pass of the OCU array: output channels
    [cout_lo, cout_hi) computed from input channels [cin_lo, cin_hi).
    Channel ranges index the *padded* weight image (C_in padded to a
    multiple of 4 — the 2-bit pack quantum; zero trits are semantically
    free)."""

    cout_lo: int
    cout_hi: int
    cin_lo: int
    cin_hi: int

    @property
    def c_out(self) -> int:
        return self.cout_hi - self.cout_lo

    @property
    def c_in(self) -> int:
        return self.cin_hi - self.cin_lo


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One scheduled step.  ``kind`` mirrors `LayerSpec.kind`; only the
    fields meaningful for that kind are set.

    Geometry conventions:
      * conv2d:   ``h`` x ``w`` is the SAME-conv spatial size (pre-pool,
                  pre-stride); ``pool`` > 0 is the absorbed epilogue max-pool
                  window; ``stride`` > 1 subsamples the ternarized output
                  (the schedule prices only the kept output pixels — a
                  strided conv never absorbs a pool).
      * tcn:      ``h`` = ceil(tcn_steps / dilation) rows, ``w`` = dilation
                  columns — the §4 wrapped form the 2-D engine runs.
      * fc:       ``c_in`` is the matmul fan-in (flattened features);
                  ``arch_c_in``/``kh``/``kw`` are the OPU's 1x1-output-conv
                  view (kh*kw*arch_c_in == c_in) for the analytic model.
    """

    index: int
    kind: str
    h: int = 0
    w: int = 0
    c_in: int = 0
    c_out: int = 0
    kh: int = 1
    kw: int = 1
    pool: int = 0
    dilation: int = 1
    taps: int = 0
    c_pad: int = 0
    arch_c_in: int = 0
    stride: int = 1
    tiles: Tuple[TileAssign, ...] = ()

    @property
    def out_pixels(self) -> int:
        """Output pixels the OCU array produces per tile pass (pre-pool;
        strided convs compute only the kept output phase)."""
        if self.kind == "conv2d":
            return (self.h // self.stride) * (self.w // self.stride)
        return self.h * self.w if self.kind == "tcn" else 1

    @property
    def cout_tile_widths(self) -> Tuple[int, ...]:
        """Sorted distinct output-channel widths of this layer's
        `TileAssign`s — the tile-geometry export `kernels.autotune`
        consumes to pick the fused kernel's block_cout (a single uniform
        width on a <=3x3 layer means launches map 1:1 onto the priced OCU
        tile passes)."""
        return tuple(sorted({t.c_out for t in self.tiles}))

    @property
    def macs(self) -> int:
        if self.kind == "fc":
            return self.c_in * self.c_out
        if self.kind in ("conv2d", "tcn"):
            return self.out_pixels * self.kh * self.kw * self.c_in * self.c_out
        return 0  # pool/global_pool/flatten/last_step: no multiplies


def _tile_ranges(c_out: int, c_pad: int, n_ocu: int, max_cin: int):
    tiles = []
    for co in range(0, c_out, n_ocu):
        for ci in range(0, c_pad, max_cin):
            tiles.append(TileAssign(
                cout_lo=co, cout_hi=min(co + n_ocu, c_out),
                cin_lo=ci, cin_hi=min(ci + max_cin, c_pad),
            ))
    return tuple(tiles)


@dataclasses.dataclass
class ExecutionPlan:
    """The full compiled schedule of one network.

    ``layers[:n_spatial]`` run once per sensor frame (the CNN frontend, or
    the whole net for spatial graphs); the rest run once per classification
    over the TCN ring window.  ``passes_per_inference`` frontend passes feed
    the ring per classification (the ring makes the remaining window steps
    free — exactly what the silicon's 576 B memory buys)."""

    graph_name: str
    n_ocu: int
    max_cin: int
    input_hw: Tuple[int, int]
    input_ch: int
    tcn_steps: int
    passes_per_inference: int
    feature_channels: int
    n_spatial: int
    layers: Tuple[LayerPlan, ...]

    # -- views -------------------------------------------------------------

    @property
    def spatial_layers(self) -> Tuple[LayerPlan, ...]:
        return self.layers[: self.n_spatial]

    @property
    def temporal_layers(self) -> Tuple[LayerPlan, ...]:
        return self.layers[self.n_spatial:]

    def weight_layers(self) -> List[LayerPlan]:
        return [lp for lp in self.layers if lp.kind in ("conv2d", "tcn", "fc")]

    # -- the analytic model's layer list (export_conv_layers) --------------

    def to_arch_layers(self, repeat_frontend: Optional[int] = None) -> List[arch.ConvLayer]:
        """The `core.cutie_arch.ConvLayer` list of this schedule: frontend
        convs repeated ``passes_per_inference`` times (unless overridden),
        TCN layers in mapped 2-D form, the classifier as a 1x1-output conv."""
        frontend: List[arch.ConvLayer] = []
        head: List[arch.ConvLayer] = []
        for lp in self.layers:
            if lp.kind == "conv2d":
                frontend.append(arch.ConvLayer(
                    lp.h // lp.stride, lp.w // lp.stride, lp.c_in, lp.c_out,
                    kh=lp.kh, kw=lp.kw
                ))
            elif lp.kind == "tcn":
                head.append(arch.ConvLayer(
                    lp.h, lp.w, lp.c_in, lp.c_out, kh=lp.kh, kw=lp.kw
                ))
            elif lp.kind == "fc":
                head.append(arch.ConvLayer(
                    1, 1, lp.arch_c_in, lp.c_out, kh=lp.kh, kw=lp.kw, is_fc=True
                ))
        passes = repeat_frontend if repeat_frontend is not None else self.passes_per_inference
        return frontend * passes + head

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """Lossless JSON-able form (round-trip pinned in tests)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ExecutionPlan":
        layers = tuple(
            LayerPlan(**{**lp, "tiles": tuple(TileAssign(**t) for t in lp["tiles"])})
            for lp in d["layers"]
        )
        return ExecutionPlan(**{
            **d,
            "input_hw": tuple(d["input_hw"]),
            "layers": layers,
        })


def lower(graph: CutieGraph, hw: Optional[arch.CutieHW] = None) -> ExecutionPlan:
    """Compile ``graph`` into its `ExecutionPlan` on the given hardware
    (default: the Kraken CUTIE instance).  This is THE shape/schedule walk —
    `export_conv_layers` and the bitsim executor both consume its output, so
    tiling and kernel-size handling live in exactly one place."""
    hw = hw or arch.CutieHW()
    if hw.max_cin % 4 != 0:
        raise ValueError(f"max_cin {hw.max_cin} must be a multiple of 4 (pack quantum)")
    g = graph.validate()
    h, w = g.input_hw
    c = g.input_ch
    flat_hw: Optional[Tuple[int, int]] = None
    layers: List[LayerPlan] = []
    n_spatial = 0
    absorbed_pool_at = -1
    spatial = g.spatial_layers
    for i, l in enumerate(g.layers):
        is_spatial = i < len(spatial)
        if l.kind == "conv2d":
            nxt = g.layers[i + 1] if i + 1 < len(g.layers) else None
            fused_pool = (
                nxt.window
                if is_spatial and nxt is not None and nxt.kind == "pool"
                and l.stride == 1 else 0
            )
            c_pad = _ceil4(l.c_in)
            layers.append(LayerPlan(
                index=i, kind="conv2d", h=h, w=w, c_in=l.c_in, c_out=l.c_out,
                kh=l.kernel[0], kw=l.kernel[1], pool=fused_pool, c_pad=c_pad,
                stride=l.stride,
                tiles=_tile_ranges(l.c_out, c_pad, hw.n_ocu, hw.max_cin),
            ))
            c = l.c_out
            h, w = h // l.stride, w // l.stride
            if fused_pool:
                absorbed_pool_at = i + 1
                h, w = h // fused_pool, w // fused_pool
        elif l.kind == "pool":
            if i == absorbed_pool_at:
                pass  # absorbed into the preceding conv's epilogue
            else:
                layers.append(LayerPlan(index=i, kind="pool", h=h, w=w, c_in=c,
                                        c_out=c, pool=l.window))
                h, w = h // l.window, w // l.window
        elif l.kind == "global_pool":
            layers.append(LayerPlan(index=i, kind="global_pool", h=h, w=w,
                                    c_in=c, c_out=c))
            h = w = 1
        elif l.kind == "flatten":
            flat_hw = (h, w)
            layers.append(LayerPlan(index=i, kind="flatten", h=h, w=w,
                                    c_in=c, c_out=h * w * c))
            h = w = 1
        elif l.kind == "tcn":
            q = -(-g.tcn_steps // l.dilation)
            c_pad = _ceil4(l.c_in)
            layers.append(LayerPlan(
                index=i, kind="tcn", h=q, w=l.dilation, c_in=l.c_in, c_out=l.c_out,
                kh=l.kernel[0], kw=l.kernel[1], dilation=l.dilation, taps=l.taps,
                c_pad=c_pad,
                tiles=_tile_ranges(l.c_out, c_pad, hw.n_ocu, hw.max_cin),
            ))
            c = l.c_out
        elif l.kind == "last_step":
            layers.append(LayerPlan(index=i, kind="last_step", c_in=c, c_out=c))
        elif l.kind == "fc":
            akh, akw = flat_hw if flat_hw is not None else (1, 1)
            a_cin = l.c_in // (akh * akw)
            layers.append(LayerPlan(
                index=i, kind="fc", h=1, w=1, c_in=l.c_in, c_out=l.c_out,
                kh=akh, kw=akw, arch_c_in=a_cin, c_pad=_ceil4(l.c_in),
                tiles=_tile_ranges(l.c_out, _ceil4(a_cin), hw.n_ocu, hw.max_cin),
            ))
            c = l.c_out
        if is_spatial:
            n_spatial = len(layers)
    feature_channels = g.feature_channels if g.is_temporal else 0
    return ExecutionPlan(
        graph_name=g.name,
        n_ocu=hw.n_ocu,
        max_cin=hw.max_cin,
        input_hw=g.input_hw,
        input_ch=g.input_ch,
        tcn_steps=g.tcn_steps,
        passes_per_inference=g.passes_per_inference if g.is_temporal else 1,
        feature_channels=feature_channels,
        n_spatial=n_spatial,
        layers=tuple(layers),
    )
