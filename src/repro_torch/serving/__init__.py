"""`repro_torch.serving` — many sensor streams on one fixed-shape batch.
Counterpart of `repro.serving`.

A `SessionPool` multiplexes independent sensor streams onto one fixed-batch
step with slot-masked ring state and per-slot cursors (continuous
batching); `ContinuousBatcher` drives arrivals and departures over it; and
`FleetRouter` scales that to many tenants running *different* nets — one
bucket of ladder-sized pools per net, bounded admission FIFOs, hysteretic
autoscaling, and a feeder thread that assembles the next frame batch on the
host while the card runs the current one.  Entry points:
`DeployedProgram.serve(pool_size, backend)` for one net,
`DeployedProgram.serve_fleet()` / `LoadedProgram.serve_fleet()` /
`repro_torch.serving.serve_fleet({...})` for many.

`ActivityGate` adds duty cycling on top: quiet streams park out of their
pool slot with ring state retained, wake bit-identically on an event burst,
and `energy_summary` prices the skipped frames in uJ of the CUTIE silicon
model.

Layering: `masking` (state algebra) <- `pool` (mechanism) <-
`gating` (host-side policy) <- `scheduler` (single-net policy) <-
`fleet` (multi-net policy).
"""
from repro_torch.serving.masking import (
    PoolState,
    clear_slot,
    clear_slot_,
    gather_slot,
    masked_push,
    masked_push_,
    ordered_windows,
    scatter_slot,
    scatter_slot_,
)
from repro_torch.serving.fleet import (
    FleetQueueFull,
    FleetRouter,
    FrameFeeder,
    NetBucket,
    ScaleEvent,
    bucket_ladder,
    serve_fleet,
)
from repro_torch.serving.gating import (
    ActivityGate,
    GateState,
    energy_summary,
    frame_energy_uj,
)
from repro_torch.serving.pool import PoolFullError, PoolSharding, SessionPool
from repro_torch.serving.scheduler import ContinuousBatcher, StreamRequest, StreamResult

__all__ = [
    "ActivityGate", "GateState", "energy_summary", "frame_energy_uj",
    "FleetQueueFull", "FleetRouter", "FrameFeeder", "NetBucket", "ScaleEvent",
    "bucket_ladder", "serve_fleet",
    "PoolState", "clear_slot", "clear_slot_", "gather_slot", "masked_push",
    "masked_push_", "ordered_windows", "scatter_slot", "scatter_slot_",
    "PoolFullError", "PoolSharding", "SessionPool", "ContinuousBatcher", "StreamRequest", "StreamResult",
]
