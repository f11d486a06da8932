"""Bounded ring-buffer event tracer — the recording half of `repro_torch.obs`.
Counterpart of `repro.obs.tracer`, plain Python.

The paper's headline numbers are *per-inference measurements*; the serving
stack's analogue is per-tick attribution: which fraction of a tick went to
host-side batch assembly vs the device step vs gate bookkeeping,
when did a bucket autoscale, when did the feeder thread fill a buffer.
`Tracer` records exactly that as a stream of events in a bounded ring
buffer (newest events win — a long-running fleet can trace forever in
constant memory):

    tracer = Tracer(capacity=65536)
    with tracer.span("tick", track="dvs_a", tick=3):
        with tracer.span("assemble", track="dvs_a"):
            ...
    tracer.instant("wake", track="dvs_a", stream="cam-0")
    tracer.counter("occupancy", 0.75, track="dvs_a")

Three event phases (Chrome trace_event vocabulary; `repro_torch.obs.export`
renders them for Chrome/Perfetto):

  * ``"X"`` — a *complete span*: emitted when the ``span()`` context
    manager exits, carrying start timestamp + duration, or by `complete`
    with both given (device spans).  Spans on one track must nest properly.
  * ``"i"`` — an *instant*: park/wake/scale/queue-full markers.
  * ``"C"`` — a *counter sample*: occupancy, queue depth, sim counters.

**Zero overhead when disabled.**  Instrumented code holds a tracer
unconditionally — the module-level `NULL_TRACER` when none was requested —
so the hot path has *no* ``if tracing:`` branches.  `NullTracer.span`
returns one shared no-op context manager (no allocation, no event), and
``instant``/``counter``/``complete`` are empty methods.  The tick flow is observed,
never altered: traced and untraced runs are logit-byte-identical
(tests/test_torch_obs.py pins this).

**Host spans measure enqueue or wait; device spans measure device time.**
PyTorch returns from a kernel launch before the card has run it, so a
wall-clock span around work on the card brackets the host's enqueue of it,
not its device time.  A span measures a wait only where something inside it
blocks on the device: in the serving tick, ``flush`` (the departures'
device-to-host copy, which waits for this tick's replay) and a
``pool.stage_wait``; ``pool.upload`` (a copy from the pool's pinned staging
ring, which does not wait), ``pool.replay``, ``advance``, ``admit``,
``assemble`` and the gate's spans are host work and enqueue only.  Device
time comes from CUDA timing events that the instrumented code records
around its work and resolves later (`repro_torch.obs.device`): `complete`
emits them as ``"X"`` events with given times on a device lane
(``<track>.device``), placed on this tracer's clock.  A serving pool's are
``dev.upload`` and ``dev.replay``, for a sample of its steps; resolving
them is the host span ``obs.resolve``, the tracer's own cost.

**Clocks.**  ``clock="wall"`` stamps `time.perf_counter_ns` (monotonic,
microseconds in the export).  ``clock="tick"`` stamps a deterministic
per-event sequence number instead — no wall time anywhere — so tests can
pin the exact event sequence of a scheduling scenario across backends
(ref vs fused produce the *same* trace, because the schedule is the same).

**Threads.**  Every event is tagged with the emitting thread (the fleet's
``cutie-feeder`` ingestion threads get their own export track); timestamp
allocation uses `itertools.count` / the wall clock, both safe under
concurrent emitters, and the ring buffer is a `collections.deque`, whose
``append`` is atomic.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

CLOCKS = ("wall", "tick")
DEFAULT_CAPACITY = 65536


class Event(NamedTuple):
    """One trace record.  ``ts``/``dur`` are nanoseconds (wall clock) or
    sequence numbers (tick clock); ``tid`` is the small per-tracer thread
    index (resolve names via `Tracer.thread_names`); ``track`` optionally
    overrides the export lane (one lane per fleet bucket)."""

    phase: str  # "X" span | "i" instant | "C" counter
    name: str
    ts: int
    dur: int
    tid: int
    track: Optional[str]
    args: Optional[dict]


class _Span:
    """Live span handle from `Tracer.span` — records on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args
        self._t0 = 0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        tr._emit(Event("X", self._name, self._t0, tr._now() - self._t0,
                       tr._tid(), self._track, self._args))

    def set_args(self, **args) -> None:
        """Add args known only inside the span (a count of what it did)."""
        self._args = {**(self._args or {}), **args}


class _NullSpan:
    """The shared no-op span: entering/exiting records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set_args(self, **args) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method a no-op, `span` a shared
    singleton context manager.  Instrumented hot paths call this
    unconditionally instead of branching on "is tracing on" — the
    zero-overhead-when-disabled contract (tests/test_torch_obs.py)."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, track: Optional[str] = None, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, track: Optional[str] = None, **args) -> None:
        return None

    def counter(self, name: str, value, track: Optional[str] = None) -> None:
        return None

    def complete(self, name: str, ts: int, dur: int, track: Optional[str] = None,
                 **args) -> None:
        return None

    def events(self) -> List[Event]:
        return []

    def __bool__(self) -> bool:
        # `tracer or NULL_TRACER` keeps working if someone chains defaults
        return False


NULL_TRACER = NullTracer()


class Tracer:
    """Bounded ring-buffer event recorder (see module docstring).

    ``capacity`` bounds memory: the deque drops the *oldest* events on
    overflow (``dropped`` counts them), so a long-lived fleet keeps the
    most recent window.  ``clock="tick"`` makes timestamps deterministic
    sequence numbers for trace-pinning tests."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock: str = "wall"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if clock not in CLOCKS:
            raise ValueError(f"unknown clock {clock!r}; expected one of {CLOCKS}")
        self.capacity = capacity
        self.clock = clock
        self._buf: deque = deque(maxlen=capacity)
        self._seq = itertools.count()
        self._emitted = 0
        self._t0 = time.perf_counter_ns()
        # thread ident -> (small tid, name); the feeder threads register
        # lazily with their thread name (ThreadPoolExecutor's prefix)
        self._threads: Dict[int, Tuple[int, str]] = {}
        self._thread_lock = threading.Lock()

    # -- time and identity -------------------------------------------------

    def _now(self) -> int:
        if self.clock == "tick":
            return next(self._seq)
        return time.perf_counter_ns() - self._t0

    def now(self) -> int:
        """The tracer's current timestamp (wall clock: nanoseconds since the
        tracer was made; tick clock: the next sequence number)."""
        return self._now()

    def _tid(self) -> int:
        ident = threading.get_ident()
        entry = self._threads.get(ident)
        if entry is None:
            with self._thread_lock:
                entry = self._threads.get(ident)
                if entry is None:
                    name = threading.current_thread().name
                    if threading.current_thread() is threading.main_thread():
                        name = "main"
                    entry = self._threads[ident] = (len(self._threads), name)
        return entry[0]

    @property
    def thread_names(self) -> Dict[int, str]:
        """{small tid -> thread name} for every thread that emitted."""
        return {tid: name for tid, name in self._threads.values()}

    # -- recording ---------------------------------------------------------

    def _emit(self, event: Event) -> None:
        self._emitted += 1
        self._buf.append(event)

    def span(self, name: str, track: Optional[str] = None, **args) -> _Span:
        """Context manager recording one complete ("X") span on exit.
        ``track`` names the export lane (default: the emitting thread);
        keyword args land in the event's ``args`` payload."""
        return _Span(self, name, track, args or None)

    def instant(self, name: str, track: Optional[str] = None, **args) -> None:
        """One instantaneous ("i") marker — park/wake/scale/queue-full."""
        self._emit(Event("i", name, self._now(), 0, self._tid(), track,
                         args or None))

    def counter(self, name: str, value, track: Optional[str] = None) -> None:
        """One counter ("C") sample; ``value`` is a number or a
        {series: number} dict (multi-series counter track)."""
        args = value if isinstance(value, dict) else {name: value}
        self._emit(Event("C", name, self._now(), 0, self._tid(), track,
                         dict(args)))

    def complete(self, name: str, ts: int, dur: int, track: Optional[str] = None,
                 **args) -> None:
        """One complete ("X") span with given times on this tracer's clock:
        work timed elsewhere, such as a device span from CUDA events
        (`repro_torch.obs.device`), emitted once its times are known."""
        self._emit(Event("X", name, int(ts), int(dur), self._tid(), track,
                         args or None))

    # -- inspection --------------------------------------------------------

    def events(self) -> List[Event]:
        """Snapshot of the ring buffer, oldest first (newest ``capacity``
        events; earlier ones were dropped — see ``dropped``)."""
        return list(self._buf)

    @property
    def dropped(self) -> int:
        """Events evicted by ring wraparound since creation."""
        return self._emitted - len(self._buf)

    def clear(self) -> None:
        """Drop all buffered events (the drop counter resets too)."""
        self._buf.clear()
        self._emitted = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events())

    def __repr__(self) -> str:
        return (f"Tracer(clock={self.clock!r}, events={len(self._buf)}/"
                f"{self.capacity}, dropped={self.dropped})")
