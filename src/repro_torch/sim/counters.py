"""Cycle/access counting over an `ExecutionPlan` — the sim's cost model.

The port's own copy of `repro.sim.counters` (plain Python): the same walk
and the same float operations, so `count_plan` and every report equal the
reference's.

Where the analytic model (`core.cutie_arch.layer_cycles`) prices a layer
with one closed formula, this module walks the plan's schedule:

  cycles(layer) = n_tiles * (window_passes * out_pixels + linebuffer_fill)
                + pipeline_drain + bank_conflict_stalls + ndb_stalls

  * ``n_tiles``       — sequential (cout, cin) tile passes (`TileAssign`s);
    every pass re-streams the input map, so the line buffer re-fills per
    pass (exactly the analytic formula's per-tile prime term);
  * ``window_passes`` — ceil(kh/HW.kh) * ceil(kw/HW.kw): a kernel larger
    than the native OCU window (3x3 on Kraken) needs multiple window passes
    per output pixel.  THE analytic model assumes 1 pixel/cycle regardless —
    this is exactly the schedule it cannot express, and why the wide/5x5
    registry net diverges (reported, not gated; see ``analytic_schedulable``);
  * ``linebuffer_fill`` — (kh-1) rows must enter the line buffer before the
    first window fires (the analytic model's fixed 2-row prime at kh=3);
  * ``pipeline_drain`` — per-layer reconfiguration + adder-tree drain
    (`SimParams.pipeline_drain_cycles`);
  * ``bank_conflict_stalls`` / ``ndb_stalls`` — feature-memory serialization
    when a layer's maps spill one bank and double buffering breaks
    (`FeatureMemory.layer_stalls`).  Zero for every registry net on the
    Kraken bank geometry — the silicon was sized so they never fire — but
    the counters make the golden model honest about programs that spill
    (tests force them with a shrunken ``SimParams.fmap_bank_bytes``).

For every 3x3 network the non-stall terms reduce to the analytic formula,
so sim and analytic cycles reconcile to within the drain overhead at the
0.5 V corner (`reconcile`).

Access counters come from the memory models (`sim.memory`): packed
weight-image bytes, double-buffered feature-map words, TCN ring traffic.

Sparsity-aware energy: pass a `WeightMemory` (``memory=``) and each
weight layer's counters carry its static zero-trit fraction
(`LayerImage.weight_sparsity` over the packed image) and ``dyn_ops`` — the ops
that actually toggle (a zero weight gates its multiplier).  ``ops`` stays
the physical 2*MACs for throughput; the electrical model prices dynamic
energy on ``dyn_ops`` (`arch.evaluate_network_counts`).  This is how
``silicon_report(source="sim")`` prices a real deployed program, not an
ideal: `evaluate_plan` takes a plan + images directly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.api.graph import CutieGraph
from repro_torch.core import cutie_arch as arch
from repro_torch.sim.memory import (
    KRAKEN_FMAP_BANK_BYTES,
    FeatureMemory,
    RingBufferSchedule,
    WeightMemory,
)
from repro_torch.sim.plan import ExecutionPlan, LayerPlan, lower


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Sim-specific schedule knobs (the HW electrical model stays in
    `CutieHW`).  ``pipeline_drain_cycles`` is the per-layer cost of
    reconfiguring the datapath and draining the OCU pipeline between
    layers; small against any real layer, but it is what makes the sim a
    *cycle-approximate* upper model of the ideal analytic schedule.

    ``fmap_bank_bytes`` sizes one feature-memory bank (default: the Kraken
    instance's 98304 B); ``count_stalls`` switches the bank-conflict /
    non-double-bufferable stall counters (on by default — they are zero
    whenever double buffering holds, so the default model is unchanged for
    every registry net)."""

    pipeline_drain_cycles: int = 4
    fmap_bank_bytes: int = KRAKEN_FMAP_BANK_BYTES
    count_stalls: bool = True


@dataclasses.dataclass(frozen=True)
class LayerCounters:
    """One plan layer, priced.  ``bank_stall_cycles``/``ndb_stall_cycles``
    are included in ``cycles``; ``w_sparsity`` is the static zero-trit
    fraction of the layer's weight image (0.0 when counted without a
    `WeightMemory`) and ``dyn_ops`` the non-gated share of ``ops`` that
    dynamic energy is priced on."""

    index: int
    kind: str
    label: str
    tiles: int
    window_passes: int
    cycles: int
    macs: int
    util: float
    wmem_bytes: int
    fmap_reads: int
    fmap_writes: int
    bank_stall_cycles: int = 0
    ndb_stall_cycles: int = 0
    w_sparsity: float = 0.0

    @property
    def ops(self) -> int:
        return 2 * self.macs  # 1 MAC = 2 Op, the paper's footnote

    @property
    def stall_cycles(self) -> int:
        return self.bank_stall_cycles + self.ndb_stall_cycles

    @property
    def dyn_ops(self) -> int:
        """Ops whose multipliers actually toggle: zero-trit weights gate
        their lanes, so the dynamic-energy share scales with density."""
        return round(self.ops * (1.0 - self.w_sparsity))


def _window_passes(lp: LayerPlan, hw: arch.CutieHW) -> int:
    if lp.kind not in ("conv2d", "tcn"):
        return 1
    return -(-lp.kh // hw.kh) * (-(-lp.kw // hw.kw))


def _layer_cycles(lp: LayerPlan, hw: arch.CutieHW, params: SimParams) -> int:
    if lp.kind in ("conv2d", "tcn"):
        fill = (lp.kh - 1) * lp.w
        compute = len(lp.tiles) * (_window_passes(lp, hw) * lp.out_pixels + fill)
        return compute + params.pipeline_drain_cycles
    if lp.kind == "fc":
        return len(lp.tiles) + params.pipeline_drain_cycles
    return 0  # pool/global_pool/flatten/last_step: in-pipeline or addressing


def _wmem_bytes(lp: LayerPlan) -> int:
    if lp.kind in ("conv2d", "tcn"):
        return lp.kh * lp.kw * (lp.c_pad // 4) * lp.c_out
    if lp.kind == "fc":
        return (lp.c_pad // 4) * lp.c_out
    return 0


def count_plan(
    plan: ExecutionPlan,
    hw: Optional[arch.CutieHW] = None,
    params: Optional[SimParams] = None,
    memory: Optional[WeightMemory] = None,
) -> List[LayerCounters]:
    """Price every plan layer.  Static — no execution; an optional
    `WeightMemory` adds each weight layer's measured trit sparsity (and
    thereby ``dyn_ops``) to the counters."""
    hw = hw or arch.CutieHW()
    params = params or SimParams()
    fmem = FeatureMemory(max_cin=hw.max_cin, bank_bytes=params.fmap_bank_bytes)
    out: List[LayerCounters] = []
    for lp in plan.layers:
        cycles = _layer_cycles(lp, hw, params)
        traffic = fmem.layer_traffic(lp)
        stalls = (fmem.layer_stalls(lp) if params.count_stalls
                  else {"bank_conflict": 0, "ndb": 0})
        cycles += stalls["bank_conflict"] + stalls["ndb"]
        util = (lp.macs / (cycles * hw.ops_per_cycle / 2)) if cycles else 0.0
        w_sparsity = 0.0
        if memory is not None and lp.kind in ("conv2d", "tcn", "fc"):
            w_sparsity = memory.image_for(lp).weight_sparsity(lp.c_in)
        out.append(LayerCounters(
            index=lp.index,
            kind=lp.kind,
            label=f"{lp.kind}@{lp.h}x{lp.w} {lp.c_in}->{lp.c_out} k{lp.kh}x{lp.kw}",
            tiles=len(lp.tiles),
            window_passes=_window_passes(lp, hw),
            cycles=cycles,
            macs=lp.macs,
            util=util,
            wmem_bytes=_wmem_bytes(lp),
            fmap_reads=traffic["reads"],
            fmap_writes=traffic["writes"],
            bank_stall_cycles=stalls["bank_conflict"],
            ndb_stall_cycles=stalls["ndb"],
            w_sparsity=w_sparsity,
        ))
    return out


def inference_counts(
    plan: ExecutionPlan,
    hw: Optional[arch.CutieHW] = None,
    params: Optional[SimParams] = None,
    memory: Optional[WeightMemory] = None,
) -> List[LayerCounters]:
    """Per-classification sequence: frontend counters repeated once per
    frontend pass (the TCN ring makes the other window steps free), then
    the head — the exact analogue of `export_conv_layers`' repetition."""
    counts = count_plan(plan, hw, params, memory)
    spatial = counts[: plan.n_spatial]
    head = counts[plan.n_spatial :]
    return spatial * plan.passes_per_inference + head


def evaluate_frame(
    plan: ExecutionPlan,
    hw: Optional[arch.CutieHW] = None,
    v: float = 0.5,
    params: Optional[SimParams] = None,
    memory: Optional[WeightMemory] = None,
    name: Optional[str] = None,
) -> arch.NetReport:
    """Price ONE sensor-frame step: every plan layer once — the spatial
    frontend plus (for temporal nets) the TCN head over the ring window.
    This is the unit of work an activity gate skips per quiet frame
    (`repro_torch.serving.gating`), distinct from `evaluate_plan`, which
    prices a *classification* (``passes_per_inference`` frontend passes +
    head)."""
    hw = hw or arch.CutieHW()
    counts = count_plan(plan, hw, params, memory)
    return arch.evaluate_network_counts(
        f"{name or plan.graph_name}/frame", counts, hw, v
    )


def analytic_schedulable(plan: ExecutionPlan, hw: Optional[arch.CutieHW] = None) -> bool:
    """True when every kernel fits the native OCU window — the regime where
    the analytic pixel-per-cycle formula is a valid schedule and the
    reconciliation gate applies."""
    hw = hw or arch.CutieHW()
    return all(_window_passes(lp, hw) == 1 for lp in plan.layers)


def evaluate_plan(
    plan: ExecutionPlan,
    hw: Optional[arch.CutieHW] = None,
    v: float = 0.5,
    params: Optional[SimParams] = None,
    memory: Optional[WeightMemory] = None,
    name: Optional[str] = None,
) -> arch.NetReport:
    """Price a compiled plan directly — the graph-free entry point behind
    `api.program.silicon_report_from_plan`: count -> ingest into the electrical
    model, with sparsity-aware dynamic energy when ``memory`` is given."""
    hw = hw or arch.CutieHW()
    counts = inference_counts(plan, hw, params, memory)
    return arch.evaluate_network_counts(name or plan.graph_name, counts, hw, v)


def evaluate_sim(
    graph: CutieGraph,
    hw: Optional[arch.CutieHW] = None,
    v: float = 0.5,
    params: Optional[SimParams] = None,
    memory: Optional[WeightMemory] = None,
) -> arch.NetReport:
    """The sim-side twin of `arch.evaluate_network`: lower -> count ->
    ingest per-layer cycles into the electrical model."""
    hw = hw or arch.CutieHW()
    return evaluate_plan(lower(graph, hw), hw, v, params, memory, name=graph.name)


def reconcile(
    graph: CutieGraph,
    hw: Optional[arch.CutieHW] = None,
    v: float = 0.5,
    params: Optional[SimParams] = None,
) -> dict:
    """Sim-vs-analytic cycle reconciliation for one graph.

    ``divergence`` = sim_cycles / analytic_cycles - 1.  Non-negative by
    construction for schedulable nets (the sim only *adds* fill/drain/stall
    cycles); the gate bounds it from above.  ``analytic_schedulable`` False
    marks nets whose schedule the formula cannot express (kernel > native
    window) — divergence is reported but not gated there.
    ``stall_cycles`` totals the feature-memory serialization the analytic
    model can never see (zero whenever double buffering holds)."""
    hw = hw or arch.CutieHW()
    plan = lower(graph, hw)
    counts = inference_counts(plan, hw, params)
    sim = arch.evaluate_network_counts(graph.name, counts, hw, v)
    analytic = arch.evaluate_network(
        graph.name, plan.to_arch_layers(), hw, v
    )
    return {
        "net": graph.name,
        "v": v,
        "sim_cycles": sim.cycles,
        "analytic_cycles": analytic.cycles,
        "divergence": sim.cycles / analytic.cycles - 1.0,
        "analytic_schedulable": analytic_schedulable(plan, hw),
        "stall_cycles": sum(c.stall_cycles for c in counts),
        "ring": dataclasses.asdict(RingBufferSchedule.for_plan(plan))
        if plan.feature_channels else None,
    }


def counts_summary(counts: Sequence[LayerCounters]) -> dict:
    """Aggregate totals for reports/benches."""
    return {
        "cycles": sum(c.cycles for c in counts),
        "macs": sum(c.macs for c in counts),
        "ops": sum(c.ops for c in counts),
        "dyn_ops": sum(c.dyn_ops for c in counts),
        "stall_cycles": sum(c.stall_cycles for c in counts),
        "wmem_bytes": sum(c.wmem_bytes for c in counts),
        "fmap_reads": sum(c.fmap_reads for c in counts),
        "fmap_writes": sum(c.fmap_writes for c in counts),
    }
