"""The traced run's profiled sub-window, reduced to what the metrics read.

``torch.profiler`` records every device operation (kernels, copies, sets)
of a short steady stretch of the window.  Its clock is aligned with the host's
``perf_counter`` through a marker at a known host time — the stretch's first
device operation, launched on an idle card (its start lags the host's mark by
one launch, microseconds), or on a host without a card a ``MARK`` range — and
the tracer's spans through one marker instant.  From the device intervals:
the busy seconds (the union of all operations), the device seconds by name,
K1's seconds (names matching the configuration's patterns), and each idle
gap, labelled by the tracer spans open on the host at its midpoint (outer to
inner, ``harness`` when no span was open).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

MARK = "cellbench.mark"


@dataclasses.dataclass
class Profile:
    window_s: float                 # the sub-window, host clock, synchronised at both ends
    busy_s: float                   # union of device operation intervals
    by_name: Dict[str, float]       # device seconds per operation name
    k1_s: float                     # device seconds of K1's kernels
    idle_by_label: Dict[str, float]  # idle seconds per host span path
    step_ticks: int                 # ticks inside the sub-window that stepped the pool
    frames: int                     # frames stepped inside the sub-window
    n_ops: int                      # device operations counted


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class SpanIndex:
    """Host spans ``(start_s, end_s, name)`` that nest (one thread), for
    looking up the spans open at an instant."""

    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def path(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        names: List[str] = []
        # the open spans are ancestors, which started before t: a tick's few
        # children lie between them, so a short walk back finds them all
        for s, e, name in reversed(self.spans[max(0, i - 16):i]):
            if e >= t:
                names.append(name)
        return "/".join(reversed(names)) or "harness"


def reduce(events, mark_ns: int, window: Tuple[float, float],
           spans: SpanIndex, k1_patterns: Sequence[str],
           step_ticks: int, frames: int) -> Profile:
    """``events`` are the profiler's `FunctionEvent`s; ``mark_ns`` the host's
    ``perf_counter_ns`` at the marker; ``window`` the sub-window's host-clock
    bounds in seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    mark_us = None
    device: List[Tuple[float, float, str]] = []
    for ev in events:
        if ev.device_type == cuda:
            device.append((ev.time_range.start, ev.time_range.end, ev.name))
        elif ev.name == MARK and mark_us is None:
            mark_us = ev.time_range.start
    if device:
        mark_us = min(s for s, _, _ in device)
    if mark_us is None:
        raise RuntimeError("the profiler's trace lacks the clock marker")
    lo, hi = window
    shift = mark_ns / 1e9 - mark_us / 1e6
    clipped: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = defaultdict(float)
    k1_s = 0.0
    for s_us, e_us, name in device:
        s, e = max(s_us / 1e6 + shift, lo), min(e_us / 1e6 + shift, hi)
        if e <= s:
            continue
        clipped.append((s, e))
        by_name[name] += e - s
        if any(p in name for p in k1_patterns):
            k1_s += e - s
    busy = _union(clipped)
    idle: Dict[str, float] = defaultdict(float)
    edge = lo
    for s, e in busy + [(hi, hi)]:
        if s > edge:
            idle[spans.path((edge + s) / 2)] += s - edge
        edge = max(edge, e)
    return Profile(window_s=hi - lo, busy_s=sum(e - s for s, e in busy),
                   by_name=dict(by_name), k1_s=k1_s, idle_by_label=dict(idle),
                   step_ticks=step_ticks, frames=frames, n_ops=len(clipped))


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as ``[[name, seconds], ...]``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
