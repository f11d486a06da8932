"""`repro_torch.obs` — zero-overhead-when-disabled observability of the port.
Counterpart of `repro.obs`; four modules:

  * `repro_torch.obs.tracer` — bounded ring-buffer event recorder
    (`Tracer`; `NULL_TRACER` is the always-available disabled instance the
    instrumented hot paths hold when tracing is off).  Its wall-clock spans
    around work on the card measure the host's enqueue time, or its wait
    where the span blocks on the card (the serving tick's ``flush``, a
    ``pool.stage_wait``).
  * `repro_torch.obs.device` — device time on the tracer's clock: CUDA
    timing events recorded around a pool's upload and replay, resolved
    without waiting into ``dev.upload`` / ``dev.replay`` spans on a device
    lane (`Tracer.complete`).
  * `repro_torch.obs.metrics` — label-keyed counter/gauge/histogram registry
    with a Prometheus text snapshot (`MetricsRegistry`), plus `SampleWindow`,
    the scheduler's bounded latency trace.
  * `repro_torch.obs.export` — Chrome/Perfetto trace JSON rendering,
    sim-derived `layer_timeline` hardware tracks, summaries and diffs; the
    same documents as the reference's for the same events and programs.

CLI: ``python -m repro_torch.obs {summarize,export,diff}`` (see `__main__`).
Wiring: ``--trace PATH`` on `repro_torch.launch.serve` / `repro_torch.launch.train`.
"""
from repro_torch.obs.export import (
    PORT_EVENTS,
    TICK_PHASES,
    layer_timeline,
    load,
    phase_breakdown,
    save_chrome,
    to_chrome,
    trace_diff,
    trace_summary,
    validate_nesting,
)
from repro_torch.obs.metrics import MetricsRegistry, SampleWindow
from repro_torch.obs.tracer import NULL_TRACER, Event, NullTracer, Tracer

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Event",
    "MetricsRegistry",
    "SampleWindow",
    "to_chrome",
    "save_chrome",
    "load",
    "layer_timeline",
    "phase_breakdown",
    "trace_summary",
    "trace_diff",
    "validate_nesting",
    "PORT_EVENTS",
    "TICK_PHASES",
]
