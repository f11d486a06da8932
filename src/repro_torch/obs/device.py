"""Device time on a tracer's clock, from CUDA timing events.

A host span around work on the card measures the host's enqueue of it (see
`repro_torch.obs.tracer`).  The card's own time comes from CUDA timing
events recorded on the device's stream between the host's calls: the card
stamps each event when its stream reaches it, and ``elapsed_time`` between
two of them is the device time of the work in between.

`DeviceClock` places those events on a `Tracer`'s wall clock.  It is made
once per tracer and device: one ``synchronize``, then a timing event and the
tracer's timestamp taken together (the anchor).  A completed event lies at
``anchor_ns + elapsed(anchor, event)``.  ``elapsed_time`` is float32
milliseconds, whose step grows with the distance (0.06 us at 1 s, 1 us at
16 s), so once an event lies more than ``REBASE_MS`` past the anchor the
clock moves its anchor onto that event, which was placed already, with no
new synchronize: each move adds at most half of float32's step at
``REBASE_MS`` (4 ns).

The card's clock and the host's drift apart by parts per million (H100s
against the host's ``perf_counter``: 2.6 us a second one way on one
machine, 1.4 us the other way on another), so an anchor alone misplaces
events by a hundred microseconds after a minute.  The host's own times keep
the clock on its own, with no further synchronize.  `DeviceSpans` takes the
host's time just before it records a step's first event (``recorded``) and
when a ``query()`` finds the step complete (``seen``): the event completed
between the two, and a placement outside them moves the clock by the excess
(`DeviceClock.hold`).  Between them, the least lag of a placement behind its
``recorded`` in each ``WINDOW_NS`` of host time is an event recorded on an
idle stream, which the card stamps as soon as the host's record reaches it:
the clock keeps that least lag at what it was in the first window after the
anchor, so it follows the drift either way, to within the jitter of a
record call (microseconds).  A serving pool's stream idles after every tick
with a departure, and between ticks wherever the host sets the pace.

`DeviceSpans` records the events of one repeated step — a pool tick's upload
and replay — on each device the step runs on, from a reused set of events.
The step's code calls `mark` between its host calls and `close` after its
last one; `resolve` asks each pending step's last event with ``query()``
only, oldest first, and emits every step the card has passed as ``"X"``
spans (`Tracer.complete`) on the device's lane.  Nothing here waits for the
card, except `resolve(wait=True)` and `resolve_pending`, which a program
calls once before it writes its trace.  The events are recorded outside any
CUDA graph, so a captured step is the same graph traced or untraced.

Timing a step costs the host about 0.1 ms on an H100's host (each record
3.5 us and each ``elapsed_time`` 7.5 us, three of each, and the pageable
copy and the launch after a record slower), a third of a short pool tick.
So a step is timed only when ``MIN_GAP_NS`` of host time has passed since
the last timed step began: about one step in twelve of a 0.4 ms tick, one
in three of a 2 ms tick.  The spans are a sample of the steps, which the
host's clock at a step's start selects, not the step's own length; the
recorder's own host time is its ``obs.resolve`` spans.

Only a wall-clock `Tracer` has device spans: the code that records them
binds a `DeviceSpans` when its tracer is enabled, on the wall clock, and its
work is on a CUDA device (`records_device_time`), and otherwise holds
`NULL_DEVICE_SPANS`, whose methods are no-ops, as `NULL_TRACER`'s are: no
event is recorded, and the hot path has no ``if tracing:`` branch.
"""
from __future__ import annotations

import weakref
from collections import deque
from typing import Deque, List, Mapping, Optional, Sequence, Tuple

REBASE_MS = 100.0
WINDOW_NS = 1_000_000_000
MIN_GAP_NS = 5_000_000

# per tracer: its device clocks, and the recorders that may hold pending steps
_CLOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_RECORDERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def records_device_time(tracer, device) -> bool:
    """Whether work on ``device`` traced into ``tracer`` gets device spans:
    an enabled wall-clock tracer and a CUDA device."""
    return (bool(getattr(tracer, "enabled", False))
            and getattr(tracer, "clock", None) == "wall"
            and getattr(device, "type", None) == "cuda")


class DeviceClock:
    """One CUDA device's timing events on a tracer's wall clock (see the
    module docstring).  Get it with `device_clock`: one per tracer and
    device."""

    def __init__(self, event, ns: int):
        self.event, self.ns = event, ns      # the anchor
        self._lag_ref: Optional[int] = None  # least lag in the first window
        self._lag_min: Optional[int] = None  # least lag in this window
        self._window_end = ns + WINDOW_NS

    @classmethod
    def anchor(cls, tracer, device) -> "DeviceClock":
        """One synchronize, then a timing event and the tracer's time."""
        import torch

        with torch.cuda.device(device):
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            ns = tracer.now()
        event.synchronize()
        return cls(event, ns)

    def place(self, event) -> Tuple[int, float]:
        """A completed event's tracer time (ns), and its distance from the
        anchor in ms."""
        ms = self.event.elapsed_time(event)
        return self.ns + round(ms * 1e6), ms

    def rebase(self, event, ns: int):
        """Anchor on ``event`` (completed, placed at ``ns``).  Returns the
        old anchor event, free for reuse."""
        old, self.event, self.ns = self.event, event, ns
        return old

    def hold(self, placed: int, recorded: int, seen: int) -> int:
        """An event placed at ``placed`` was recorded by the host after
        ``recorded`` and seen complete by ``seen``: move the clock by any
        excess outside the two, and at the end of each window by the change
        of the window's least lag.  Returns the placement on the clock as it
        now stands."""
        if placed < recorded:
            self.ns += recorded - placed
            placed = recorded
        elif placed > seen:
            self.ns -= placed - seen
            placed = seen
        lag = placed - recorded
        if self._lag_min is None or lag < self._lag_min:
            self._lag_min = lag
        if recorded >= self._window_end:
            if self._lag_ref is None:
                self._lag_ref = self._lag_min
            else:
                self.ns -= self._lag_min - self._lag_ref
            self._lag_min = None
            self._window_end = recorded + WINDOW_NS
        return placed


def device_clock(tracer, device) -> DeviceClock:
    """The tracer's clock for ``device``, made on first use."""
    import torch

    device = torch.device(device)
    clocks = _CLOCKS.setdefault(tracer, {})
    clock = clocks.get(device)
    if clock is None:
        clock = clocks[device] = DeviceClock.anchor(tracer, device)
    return clock


class DeviceSpans:
    """Timing events around a repeated step, on every device it runs on.

    ``names`` are the step's stretches in order: n names take n + 1 marks,
    mark 0 before the first stretch and mark j after stretch j - 1.
    ``devices`` and ``lanes`` pair each device with the trace lane its
    spans go to.  A stretch's duration is always its own two events'
    ``elapsed_time``; the first stretch starts where the device's clock
    places mark 0, and each later one where the one before it ends.  A
    lane's spans keep their order: a start that rounding would put before
    the lane's last end is moved up to it (at most the clock's error).  A
    step that mark 0 opens less than ``min_gap_ns`` after the last timed
    one is not timed: its marks and its close do nothing.  ``track`` is the
    host lane of the recorder's own cost, its ``obs.resolve`` spans."""

    def __init__(self, tracer, devices: Sequence, lanes: Sequence[str],
                 names: Sequence[str], track: Optional[str] = None):
        import torch

        if len(devices) != len(lanes) or not devices:
            raise ValueError("one lane per device, at least one device")
        self.tracer = tracer
        self.names = tuple(names)
        self.devices = [torch.device(d) for d in devices]
        self.lanes = tuple(lanes)
        self.track = track  # the host lane of the recorder's own spans
        self.clocks = [device_clock(tracer, d) for d in self.devices]
        self.min_gap_ns = MIN_GAP_NS
        self._free: List[List[list]] = []
        self._open: Optional[List[list]] = None  # None: no step is being timed
        self._streams: list = []  # the open step's stream on each device
        self._recorded = -(1 << 62)  # host time just before the last timed mark 0
        # (events per device, host time before mark 0, args per device: {span name: args})
        self._pending: Deque[Tuple[List[list], int, Sequence[Mapping]]] = deque()
        self._last_end = [0] * len(self.devices)
        _RECORDERS.setdefault(tracer, weakref.WeakSet()).add(self)

    @property
    def pending(self) -> int:
        """Steps recorded and not yet emitted."""
        return len(self._pending)

    def _entry(self) -> List[list]:
        import torch

        if self._free:
            return self._free.pop()
        return [[torch.cuda.Event(enable_timing=True) for _ in range(len(self.names) + 1)]
                for _ in self.devices]

    def _current_streams(self) -> list:
        import torch

        return [torch.cuda.current_stream(d) for d in self.devices]

    def mark(self, i: int) -> None:
        """Record mark ``i`` on each device's current stream, as it was at
        mark 0, which opens a step (timed or not, see the class)."""
        if i == 0:
            now = self.tracer.now()
            if now - self._recorded < self.min_gap_ns:
                self._open = None
                return
            self._recorded = now
            self._open = self._entry()
            self._streams = self._current_streams()
        if self._open is None:
            return
        for events, stream in zip(self._open, self._streams):
            events[i].record(stream)

    def close(self, args: Optional[Sequence[Mapping]] = None) -> None:
        """End the open step; ``args`` (per device: {span name: args})
        land on its spans."""
        if self._open is None:
            return
        self._pending.append((self._open, self._recorded,
                              args if args is not None else [{}] * len(self.devices)))
        self._open = None

    def resolve(self, wait: bool = False) -> int:
        """Emit every pending step the card has passed, oldest first; with
        ``wait``, wait for each.  Returns how many were emitted.  The host
        time this takes, where anything is pending, is an ``obs.resolve``
        span (arg ``steps``) on the lane ``track``."""
        if not self._pending:
            return 0
        done = 0
        with self.tracer.span("obs.resolve", track=self.track) as span:
            while self._pending:
                entry, recorded, args = self._pending[0]
                if not self._complete(entry, wait):
                    break
                seen = self.tracer.now()  # every event of the step is complete by now
                self._pending.popleft()
                self._emit(entry, recorded, seen, args)
                self._free.append(entry)
                done += 1
            span.set_args(steps=done)
        return done

    @staticmethod
    def _complete(entry: List[list], wait: bool) -> bool:
        """Whether the card has passed a step's last events (with ``wait``,
        once it has)."""
        for events in entry:
            if wait:
                events[-1].synchronize()
            elif not events[-1].query():
                return False
        return True

    def _emit(self, entry: List[list], recorded: int, seen: int,
              args: Sequence[Mapping]) -> None:
        for k, (events, clock) in enumerate(zip(entry, self.clocks)):
            durs = [round(events[j].elapsed_time(events[j + 1]) * 1e6)
                    for j in range(len(self.names))]
            t, ms = clock.place(events[0])
            t = clock.hold(t, recorded, seen - sum(durs))
            t = max(t, self._last_end[k])
            for name, dur in zip(self.names, durs):
                self.tracer.complete(name, t, dur, track=self.lanes[k],
                                     **(args[k].get(name) or {}))
                t += dur
            self._last_end[k] = t
            if ms > REBASE_MS:
                end, _ = clock.place(events[-1])
                events[-1] = clock.rebase(events[-1], end)


class NullDeviceSpans:
    """The recorder of a step that is not timed: every method a no-op."""

    __slots__ = ()

    def mark(self, i: int) -> None:
        return None

    def close(self, args=None) -> None:
        return None

    def resolve(self, wait: bool = False) -> int:
        return 0


NULL_DEVICE_SPANS = NullDeviceSpans()


def resolve_pending(tracer) -> int:
    """Wait for and emit every step still pending in a recorder bound to
    ``tracer`` (before its trace is written).  Returns how many."""
    return sum(r.resolve(wait=True) for r in list(_RECORDERS.get(tracer, ())))
