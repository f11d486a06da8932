"""Label-keyed metrics registry with a Prometheus-text-format snapshot.
Counterpart of `repro.obs.metrics`, plain Python and unchanged in behaviour:
the same operations render the same text.

Where `repro_torch.obs.tracer` answers "what happened, in order", the registry
answers "how much, in aggregate" — always-on, bounded-memory counters
that a scrape endpoint (or a CI log) can snapshot at any point:

    reg = MetricsRegistry()
    reg.counter("cutie_frames_processed_total", "Frames run on device")\
       .labels(net="dvs_a").inc()
    reg.gauge("cutie_pool_occupancy", "Active slots / pool size")\
       .labels(net="dvs_a").set(0.75)
    reg.histogram("cutie_tick_seconds", "Wall time per batcher tick")\
       .labels(net="dvs_a", pool_size="4").observe(3.2e-4)
    print(reg.render())          # Prometheus text exposition format

Series are keyed by sorted label tuples; a metric family renders as the
standard ``# HELP`` / ``# TYPE`` header followed by one sample line per
label set (histograms expand to cumulative ``_bucket{le=...}`` +
``_sum`` + ``_count``).

`SampleWindow` is the serving scheduler's bounded ``latency_trace``: a
deque with ``maxlen`` that forwards every append into a histogram series, so recent
samples stay available for exact p50/p99 while the histogram keeps the
all-time (bucketed) distribution in constant memory.
"""
from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Latency-oriented default buckets (seconds): 10 us .. 10 s, log-ish spacing.
DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt(value: float) -> str:
    # Prometheus accepts any float repr; integers render without ".0"
    if isinstance(value, float) and value.is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class _Series:
    """One (family, label set) sample; behaviour depends on the kind."""

    __slots__ = ("value", "count", "total", "buckets")

    def __init__(self, n_buckets: int = 0):
        self.value = 0.0
        self.count = 0
        self.total = 0.0
        self.buckets = [0] * n_buckets


class Metric:
    """A metric family: one name/help/kind, many label-keyed series.

    ``kind`` is one of ``"counter"``, ``"gauge"``, ``"histogram"``.
    Access a series with ``.labels(net="dvs_a")`` (or call the mutators
    directly for the unlabelled series)."""

    def __init__(self, name: str, help: str, kind: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.kind = kind
        self.buckets = tuple(sorted(buckets)) if kind == "histogram" else ()
        self._series: Dict[LabelKey, _Series] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: str) -> "_BoundSeries":
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(len(self.buckets))
        return _BoundSeries(self, series)

    # unlabelled convenience forms
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def value_for(self, **labels: str) -> float:
        """Current value (counter/gauge) or sum (histogram) of a series."""
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            return 0.0
        return series.total if self.kind == "histogram" else series.value

    def series_items(self) -> List[Tuple[LabelKey, _Series]]:
        with self._lock:
            return sorted(self._series.items())

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, s in self.series_items():
            if self.kind == "histogram":
                cum = 0
                for le, n in zip(self.buckets, s.buckets):
                    cum += n
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_render_labels(key, [('le', _fmt(le))])} {cum}")
                lines.append(
                    f"{self.name}_bucket{_render_labels(key, [('le', '+Inf')])}"
                    f" {s.count}")
                lines.append(f"{self.name}_sum{_render_labels(key)} {_fmt(s.total)}")
                lines.append(f"{self.name}_count{_render_labels(key)} {s.count}")
            else:
                lines.append(f"{self.name}{_render_labels(key)} {_fmt(s.value)}")
        return "\n".join(lines)


class _BoundSeries:
    """A series bound to its family — the object mutators live on."""

    __slots__ = ("_metric", "_series")

    def __init__(self, metric: Metric, series: _Series):
        self._metric = metric
        self._series = series

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("counters only go up")
        self._series.value += amount

    def set(self, value: float) -> None:
        self._series.value = float(value)

    def observe(self, value: float) -> None:
        s = self._series
        s.count += 1
        s.total += value
        buckets = self._metric.buckets
        if buckets:
            idx = bisect.bisect_left(buckets, value)
            if idx < len(buckets):
                s.buckets[idx] += 1

    @property
    def value(self) -> float:
        return self._series.value

    @property
    def count(self) -> int:
        return self._series.count

    @property
    def total(self) -> float:
        return self._series.total


class MetricsRegistry:
    """A process-local collection of metric families.

    ``counter``/``gauge``/``histogram`` get-or-create a family (idempotent
    — instrumented modules can all declare the family they touch); kind
    mismatches on an existing name raise.  ``render()`` emits the whole
    registry in Prometheus text exposition format, families sorted by
    name; ``snapshot()`` gives the same data as nested dicts for JSON."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, help: str, kind: str,
                       buckets: Sequence[float]) -> Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = Metric(name, help, kind, buckets)
            elif metric.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {metric.kind}, "
                    f"requested {kind}")
            return metric

    def counter(self, name: str, help: str = "") -> Metric:
        return self._get_or_create(name, help, "counter", ())

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._get_or_create(name, help, "gauge", ())

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Metric:
        return self._get_or_create(name, help, "histogram", buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def families(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render(self) -> str:
        """Prometheus text exposition format for every family."""
        return "\n".join(m.render() for m in self.families()) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-friendly view: {family: {kind, help, series: {labels: ...}}}."""
        out: Dict[str, dict] = {}
        for m in self.families():
            series = {}
            for key, s in m.series_items():
                label_str = ",".join(f"{k}={v}" for k, v in key) or "_"
                if m.kind == "histogram":
                    series[label_str] = {"count": s.count, "sum": s.total}
                else:
                    series[label_str] = s.value
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out


class SampleWindow(deque):
    """Bounded drop-in for the scheduler's old unbounded ``latency_trace``.

    A ``deque(maxlen=capacity)`` holding the most recent samples (so
    existing consumers — ``stats()`` p50/p99, ``latency_by_pool_size()``,
    the serving bench's mid-run ``clear()`` — keep exact behaviour while
    under capacity), with an optional ``observe`` hook that forwards every
    appended sample into a metrics histogram for all-time aggregates."""

    def __init__(self, capacity: int = 4096, observe=None,
                 iterable: Iterable = ()):  # noqa: D401 - deque signature
        super().__init__(iterable, capacity)
        self.capacity = capacity
        self._observe = observe

    def append(self, item) -> None:
        super().append(item)
        if self._observe is not None:
            self._observe(item)
