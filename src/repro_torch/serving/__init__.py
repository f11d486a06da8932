"""`repro_torch.serving` — many sensor streams on one fixed-shape batch.

A `SessionPool` multiplexes independent DVS streams onto one fixed-batch
step with slot-masked ring state and per-slot cursors (continuous batching);
`ContinuousBatcher` drives arrivals and departures over it.  Entry point:
`DeployedProgram.serve(pool_size, backend)`.

Layering: `masking` (pure state algebra) <- `pool` (mechanism) <-
`scheduler` (single-net policy).  The reference's `fleet` and `gating`
layers are not ported yet.
"""
from repro_torch.serving.masking import (
    PoolState,
    clear_slot,
    gather_slot,
    masked_push,
    ordered_windows,
    scatter_slot,
)
from repro_torch.serving.pool import PoolFullError, SessionPool
from repro_torch.serving.scheduler import ContinuousBatcher, StreamRequest, StreamResult

__all__ = [
    "PoolState", "clear_slot", "gather_slot", "masked_push", "ordered_windows",
    "scatter_slot", "PoolFullError", "SessionPool", "ContinuousBatcher",
    "StreamRequest", "StreamResult",
]
