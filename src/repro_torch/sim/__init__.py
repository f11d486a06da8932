"""`repro_torch.sim` — CUTIE compiler + cycle-approximate simulator of the port.

Counterpart of `repro.sim`, with the same exports.  `lower()` compiles a
`CutieGraph` into an `ExecutionPlan` — per-layer OCU/C_in tile assignments,
trit-packed weight-memory images, double-buffered feature-memory traffic,
and the TCN ring-buffer schedule — which is then

  * **executed** bit-exactly by `PlanExecutor` (the ``backend="bitsim"``
    branch of `DeployedProgram.forward`/`stream`), and
  * **counted** by `counters.count_plan` into per-layer cycle/access numbers
    that `core.cutie_arch.evaluate_network_counts` turns into the same
    `NetReport` the analytic model produces — `silicon_report(source="sim")`.

    from repro_torch.sim import lower, count_plan, reconcile
    plan   = lower(graph)                  # schedule only (no weights)
    counts = count_plan(plan)              # per-layer cycles/accesses
    logits = deployed.forward(x, backend="bitsim")   # executes the plan
"""
from repro_torch.sim.plan import ExecutionPlan, LayerPlan, TileAssign, lower
from repro_torch.sim.memory import FeatureMemory, RingBufferSchedule, WeightMemory
from repro_torch.sim.execute import PlanExecutor
from repro_torch.sim.counters import (
    LayerCounters,
    SimParams,
    count_plan,
    evaluate_plan,
    evaluate_sim,
    inference_counts,
    reconcile,
)

__all__ = [
    "ExecutionPlan",
    "LayerPlan",
    "TileAssign",
    "lower",
    "WeightMemory",
    "FeatureMemory",
    "RingBufferSchedule",
    "PlanExecutor",
    "LayerCounters",
    "SimParams",
    "count_plan",
    "evaluate_plan",
    "evaluate_sim",
    "inference_counts",
    "reconcile",
]
