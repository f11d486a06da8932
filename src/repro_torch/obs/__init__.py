"""`repro_torch.obs` — zero-overhead-when-disabled observability of the port.
Counterpart of `repro.obs`; this part of the port holds two modules:

  * `repro_torch.obs.tracer` — bounded ring-buffer event recorder
    (`Tracer`; `NULL_TRACER` is the always-available disabled instance the
    instrumented hot paths hold when tracing is off).  Its wall-clock spans
    around work on the card measure the host's enqueue time.
  * `repro_torch.obs.metrics` — label-keyed counter/gauge/histogram registry
    with a Prometheus text snapshot (`MetricsRegistry`), plus `SampleWindow`,
    the scheduler's bounded latency trace.

The reference's Chrome/Perfetto export, its ``python -m repro.obs`` CLI and
the launchers' ``--trace``/``--metrics-out`` flags are not ported yet.
"""
from repro_torch.obs.metrics import MetricsRegistry, SampleWindow
from repro_torch.obs.tracer import NULL_TRACER, Event, NullTracer, Tracer

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Event",
    "MetricsRegistry",
    "SampleWindow",
]
