"""Continuous-batching scheduler: arrivals, departures, slot refill.
Counterpart of `repro.serving.scheduler`.

`SessionPool` is mechanism (fixed-shape state, masking, admit/evict);
`ContinuousBatcher` is policy: a FIFO admission queue of `StreamRequest`s,
one `tick()` per step that (1) admits queued streams into free slots,
(2) steps every in-flight stream by its next frame, (3) evicts finished
streams — so a departing stream's slot is refilled on the very next tick.

    pool = deployed.serve(pool_size=4)
    batcher = ContinuousBatcher(pool)
    for i, (clip, label) in enumerate(zip(clips, labels)):
        batcher.submit(StreamRequest(f"sensor-{i}", clip, label=label, arrival=i))
    results = batcher.run()        # list of StreamResult, departure order

Ticks are logical time: a request with ``arrival=k`` is admissible from
tick k onward.  The batcher records per-tick occupancy and per-tick host
latency (tagged with the pool size it ran at).  On a CUDA pool a tick only
*enqueues* device work — the frame batch's copy, one replay of the pool's
captured step, one copy of its logits — apart from two waits: where streams
depart their logits reach the host in ONE device-to-host copy per tick, and
the batch is assembled into the pool's pinned staging ring (by
`SessionPool.stage`, or by a fleet feeder), whose pair waits for its copy of
two ticks ago where that has not landed — so a tick's host latency is
enqueue time plus those waits.

Fleet hooks (used by `repro_torch.serving.fleet`, inert otherwise):

  * ``feeder`` — async ingestion (`fleet.FrameFeeder`): when present,
    `tick()` consumes the batch the feeder assembled, in the pool's staging
    ring, during the *previous* step and kicks off assembly of the next one
    into the ring's next pair, so host ingestion overlaps the card's work.
  * `swap_pool(new_pool)` — migrate every in-flight stream into another
    (typically differently-sized) pool via evict/admit-with-state, which
    is how autoscaling rides the bucket ladder with bit-identical logits.
  * `cancel(stream_id)` — early departure of a queued, parked or in-flight
    stream (a sensor going offline before its clip ends).

Activity gating (``gate=ActivityGate(...)``): streams start *parked* —
host-side event counting decides per frame whether a stream deserves a
pool slot at all.  A parked stream consumes one frame per tick off the
gate (never the device); on a wake-threshold frame it enters the normal
admission FIFO and resumes from its retained ring state bit-identically.
An in-flight stream that goes quiet for ``park_after`` consecutive frames
is evicted *with* state and its slot refills immediately.  The processed-
frame set is exactly `ActivityGate.plan` of the stream's activity trace.
See `repro_torch.serving.gating`.

``tracer`` (a `repro_torch.obs.Tracer`; `NULL_TRACER` by default) records
park / wake instants and the spans that cover a tick: ``tick`` around it,
``gate.park`` / ``gate.scan``, ``admit``, ``assemble`` and ``advance`` (the
per-slot outputs, cursor advance, evictions and departures; arg
``departures``) are host work; ``step`` holds the pool's ``pool.step``,
whose ``pool.upload`` (from the pool's pinned staging ring) and
``pool.replay`` only enqueue; ``flush`` (arg ``rows``;
on ticks with departures only) is the departures' device-to-host copy and
its wait for this tick's replay.  On a CUDA pool under a wall-clock tracer
the pool adds ``dev.upload`` / ``dev.replay``, the card's own time of its
copy and its replay (`repro_torch.serving.pool`).  A `StreamResult` carries
the host clock (``time.perf_counter_ns``) at its ``submit`` and at its first
admission, traced or not.
``metrics`` (a `repro_torch.obs.MetricsRegistry`) keeps the always-on
occupancy, queue, frame and tick-latency series.

The tracer's events render for Chrome/Perfetto through
`repro_torch.obs.export`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, SampleWindow
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.gating import ActivityGate, GateState
from repro_torch.serving.pool import SessionPool, host_frame

# Most recent per-tick latency samples kept for exact p50/p99; the metrics
# histogram keeps the all-time distribution in constant memory beyond this.
LATENCY_WINDOW = 4096


@dataclasses.dataclass
class StreamRequest:
    """One sensor stream to serve: ``frames`` is the ``[T, H, W, C]`` clip
    (a numpy array or a tensor), ``arrival`` the first tick the stream
    exists, ``label`` an optional ground-truth class, ``net`` the registry
    net it runs (the fleet router's routing key; a lone batcher falls back
    to its pool's program name for stats)."""

    stream_id: str
    frames: object  # [T, H, W, C]
    label: Optional[int] = None
    arrival: int = 0
    net: Optional[str] = None

    def __post_init__(self):
        if getattr(self.frames, "ndim", 0) != 4:
            raise ValueError(
                f"{self.stream_id!r}: frames must be [T, H, W, C], got "
                f"shape {getattr(self.frames, 'shape', None)}"
            )
        if self.frames.shape[0] < 1:
            raise ValueError(f"{self.stream_id!r}: empty clip (0 frames)")


@dataclasses.dataclass
class StreamResult:
    """Departure record: final-frame logits (on the host) + lifecycle ticks.

    Under activity gating ``logits`` are those of the last *processed*
    frame (``None`` for a stream whose whole clip stayed below the wake
    threshold — it never touched the device), ``frames_processed`` /
    ``frames_skipped`` split the clip, and ``admitted_tick`` is -1 when
    the stream was never admitted.  Ungated serving leaves the defaults:
    every frame processed, none skipped.  ``submitted_ns`` and
    ``admitted_ns`` are the host clock at `ContinuousBatcher.submit` and at
    the first admission (the rule of ``admitted_tick``)."""

    stream_id: str
    logits: Optional[np.ndarray]  # [n_classes], after the last processed frame
    n_frames: int
    admitted_tick: int
    finished_tick: int
    label: Optional[int] = None
    net: Optional[str] = None
    frames_processed: int = -1  # -1: ungated, == n_frames
    frames_skipped: int = 0
    # host clock (time.perf_counter_ns) at submit and at the first admission
    # (0: never admitted); not part of a result's equality or repr
    submitted_ns: int = dataclasses.field(default=0, compare=False, repr=False)
    admitted_ns: int = dataclasses.field(default=0, compare=False, repr=False)

    def __post_init__(self):
        if self.frames_processed < 0:
            self.frames_processed = self.n_frames

    @property
    def pred(self) -> Optional[int]:
        return None if self.logits is None else int(np.argmax(self.logits))

    @property
    def correct(self) -> Optional[bool]:
        if self.label is None or self.logits is None:
            return None
        return self.pred == int(self.label)


class ContinuousBatcher:
    """FIFO admission over a `SessionPool`; finished streams free their
    slot for the head of the queue on the next tick."""

    def __init__(self, pool: SessionPool, feeder=None,
                 gate: Optional[ActivityGate] = None, tracer=None,
                 metrics: Optional[MetricsRegistry] = None,
                 track: Optional[str] = None):
        self.pool = pool
        self.feeder = feeder
        self.gate = gate
        # observability: the tracer is NULL_TRACER when tracing is off —
        # span()/instant() no-ops, so the tick path carries no branches;
        # the metrics registry is always on (bounded, cheap aggregates)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.track = track or getattr(pool.deployed.graph, "name", "pool")
        pool.bind_tracer(self.tracer, self.track)
        if feeder is not None:
            feeder.bind_tracer(self.tracer, self.track)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_occupancy = m.gauge(
            "cutie_pool_occupancy", "Active slots / pool size, last tick"
        ).labels(net=self.track)
        self._m_queue = m.gauge(
            "cutie_queue_depth", "Streams waiting for a slot"
        ).labels(net=self.track)
        self._m_frames = m.counter(
            "cutie_frames_processed_total", "Frames stepped on the device"
        ).labels(net=self.track)
        self._m_skipped = m.counter(
            "cutie_frames_skipped_total", "Frames the activity gate skipped"
        ).labels(net=self.track)
        self._m_parks = m.counter(
            "cutie_gate_parks_total", "In-flight streams parked by the gate"
        ).labels(net=self.track)
        self._m_wakes = m.counter(
            "cutie_gate_wakes_total", "Parked streams woken by the gate"
        ).labels(net=self.track)
        self._m_tick = m.histogram(
            "cutie_tick_seconds", "Wall time per non-idle batcher tick")
        self._queue: Deque[StreamRequest] = deque()
        self._inflight: Dict[str, StreamRequest] = {}
        self._next_frame: Dict[str, int] = {}
        self._admitted_tick: Dict[str, int] = {}
        # host clock at submit and at the first admission, per live stream
        self._submitted_ns: Dict[str, int] = {}
        self._admitted_ns: Dict[str, int] = {}
        # gated streams currently without a slot (asleep); gate states
        # persist after departure so stats can total processed/skipped
        self._parked: Dict[str, StreamRequest] = {}
        self._gate_state: Dict[str, GateState] = {}
        # results of this tick whose logits still lie on the device, as
        # (result, logits tensor, row): one copy to the host per tick
        self._departing: List[Tuple[StreamResult, torch.Tensor, int]] = []
        self.results: List[StreamResult] = []
        self.cancelled: List[str] = []
        self.tick_index = 0
        self.occupancy_trace: List[float] = []
        # (pool_size, seconds) per non-idle tick: the newest LATENCY_WINDOW
        # for exact percentiles, every sample also in cutie_tick_seconds
        self.latency_trace: SampleWindow = SampleWindow(
            LATENCY_WINDOW, observe=self._observe_latency)

    def _observe_latency(self, sample: Tuple[int, float]) -> None:
        size, seconds = sample
        self._m_tick.labels(net=self.track, pool_size=str(size)).observe(seconds)

    # -- submission --------------------------------------------------------

    def submit(self, request: StreamRequest) -> None:
        """Queue one stream for admission (from its ``arrival`` tick on).
        Stream ids must be unique across the batcher's lifetime.  Gated
        streams start parked — they enter the admission FIFO only when a
        frame crosses the wake threshold, so a quiet sensor never consumes
        a slot."""
        ids = (
            {r.stream_id for r in self._queue}
            | set(self._inflight)
            | set(self._parked)
            | {r.stream_id for r in self.results}
        )
        if request.stream_id in ids:
            raise ValueError(f"duplicate stream id {request.stream_id!r}")
        self._submitted_ns[request.stream_id] = time.perf_counter_ns()
        if self.gate is not None:
            self._gate_state[request.stream_id] = GateState()
            self._parked[request.stream_id] = request
        else:
            self._queue.append(request)

    def submit_many(self, requests) -> None:
        """`submit` each request in order (FIFO admission preserved)."""
        for r in requests:
            self.submit(r)

    def cancel(self, stream_id: str) -> str:
        """Early departure of a stream that has not finished its clip.

        A queued request is dropped before ever touching the pool
        (returns ``"queued"``); a parked one drops its retained ring
        (``"parked"``); an in-flight stream is evicted mid-clip — its slot
        frees for the next tick's refill, its partial state is discarded,
        and no `StreamResult` is recorded (``"inflight"``).  Unknown or
        already-finished ids raise KeyError."""
        for req in self._queue:
            if req.stream_id == stream_id:
                self._queue.remove(req)
                self._forget_clock(stream_id)
                self.cancelled.append(stream_id)
                return "queued"
        if stream_id in self._parked:
            del self._parked[stream_id]
            self._gate_state[stream_id].retained = None
            self._admitted_tick.pop(stream_id, None)
            self._forget_clock(stream_id)
            self.cancelled.append(stream_id)
            return "parked"
        if stream_id in self._inflight:
            self.pool.evict(stream_id)
            del self._inflight[stream_id], self._next_frame[stream_id]
            del self._admitted_tick[stream_id]
            self._forget_clock(stream_id)
            self.cancelled.append(stream_id)
            if self.feeder is not None:
                self.feeder.invalidate()
            return "inflight"
        raise KeyError(f"unknown or finished stream {stream_id!r}")

    def _forget_clock(self, sid: str) -> None:
        self._submitted_ns.pop(sid, None)
        self._admitted_ns.pop(sid, None)

    def _clock_stamps(self, sid: str) -> Dict[str, int]:
        """A departing stream's host-clock stamps, as `StreamResult` fields."""
        return {"submitted_ns": self._submitted_ns.pop(sid, 0),
                "admitted_ns": self._admitted_ns.pop(sid, 0)}

    @property
    def pending(self) -> bool:
        return bool(self._queue or self._inflight or self._parked)

    @property
    def queue_depth(self) -> int:
        """Streams waiting for a slot (admitted FIFO, arrival-gated)."""
        return len(self._queue)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def admissible(self, at_tick: Optional[int] = None) -> int:
        """Queued streams whose ``arrival`` has already passed — the
        demand the autoscaler sees (future arrivals don't count)."""
        t = self.tick_index if at_tick is None else at_tick
        return sum(1 for r in self._queue if r.arrival <= t)

    # -- pool migration (the autoscaler's mechanism) -----------------------

    def swap_pool(self, new_pool: SessionPool) -> SessionPool:
        """Migrate every in-flight stream into ``new_pool`` (evict with
        state -> admit with state, written into the new pool's state in
        place: bit-identical from then on) and make it the batcher's pool.
        Returns the old pool — the caller (the fleet bucket) caches it, so
        scaling back to that size builds and captures nothing.
        Raises ValueError when the in-flight streams don't fit."""
        if new_pool is self.pool:
            return self.pool
        if new_pool.free_slots < len(self._inflight):
            raise ValueError(
                f"cannot swap: {len(self._inflight)} in-flight streams, "
                f"target pool has {new_pool.free_slots} free slots"
            )
        old = self.pool
        # admission order preserved so slot assignment is deterministic
        for sid in list(old.active_streams):
            if sid in self._inflight:
                new_pool.admit(sid, state=old.evict(sid))
        self.pool = new_pool
        new_pool.bind_tracer(self.tracer, self.track)
        if self.feeder is not None:
            # prefetched slot assignments refer to the old pool's geometry
            self.feeder.invalidate()
        return old

    # -- the loop ----------------------------------------------------------

    def _admit_ready(self) -> None:
        # FIFO among the *admissible* (arrival <= now) — a head-of-queue
        # request with a far-future arrival must not block later-submitted
        # streams that are already here
        waiting: List[StreamRequest] = []
        while self._queue and self.pool.free_slots:
            req = self._queue.popleft()
            if req.arrival > self.tick_index:
                waiting.append(req)
                continue
            sid = req.stream_id
            cursor = 0
            state = None
            gs = self._gate_state.get(sid)
            if gs is not None:
                # waking: resume from the retained ring (None on the first
                # wake — a cold admit) at the frame that woke the stream
                state, gs.retained = gs.retained, None
                cursor = gs.cursor
            self.pool.admit(sid, state=state)
            self._inflight[sid] = req
            self._next_frame[sid] = cursor
            # the FIRST admission tick survives park/wake cycles
            if sid not in self._admitted_tick:
                self._admitted_tick[sid] = self.tick_index
                self._admitted_ns[sid] = time.perf_counter_ns()
        self._queue.extendleft(reversed(waiting))

    def _depart(self, result: StreamResult, logits: Optional[torch.Tensor],
                row: int) -> None:
        """Record a departure; its logits row reaches the host with the
        others of this tick in `_flush_departures`."""
        self.results.append(result)
        if logits is not None:
            self._departing.append((result, logits, row))

    def _flush_departures(self) -> None:
        """ONE device-to-host copy for every departure of the tick: the
        step's logits when all rows come from it, else the rows stacked."""
        if not self._departing:
            return
        with self.tracer.span("flush", track=self.track, rows=len(self._departing)):
            sources = {id(t): t for _, t, _ in self._departing}
            if len(sources) == 1:
                host = next(iter(sources.values())).detach().cpu().numpy()
                rows = [host[i] for _, _, i in self._departing]
            else:
                host = torch.stack([t[i] for _, t, i in self._departing]).detach().cpu().numpy()
                rows = list(host)
            for (result, _, _), row in zip(self._departing, rows):
                result.logits = row.copy()
            self._departing.clear()

    def _gate_finish(self, sid: str, req: StreamRequest) -> None:
        """Depart a stream that ran out of frames without a slot: its
        result carries the last *processed* frame's logits (None when the
        whole clip stayed quiet — the device never saw this stream)."""
        gs = self._gate_state[sid]
        gs.retained = None
        del self._parked[sid]
        logits, row = gs.last_logits if gs.last_logits is not None else (None, 0)
        self._depart(StreamResult(
            stream_id=sid,
            logits=None,
            n_frames=int(req.frames.shape[0]),
            admitted_tick=self._admitted_tick.pop(sid, -1),
            finished_tick=self.tick_index,
            label=req.label,
            net=req.net,
            frames_processed=gs.processed,
            frames_skipped=gs.skipped,
            **self._clock_stamps(sid),
        ), logits, row)

    def _gate_park_inflight(self) -> Set[str]:
        """Examine each in-flight stream's NEXT frame; park the ones that
        just hit ``park_after`` consecutive quiet frames — evicted WITH
        ring state (retention, not cancellation), slot free for this very
        tick's refill.  Returns the just-parked ids so the parked scan
        below does not consume a second frame from them this tick."""
        parked_now: Set[str] = set()
        if self.gate is None:
            return parked_now
        for sid in list(self._inflight):
            req = self._inflight[sid]
            gs = self._gate_state[sid]
            if self.gate.active(req.frames[self._next_frame[sid]]):
                gs.quiet_run = 0
                continue
            gs.quiet_run += 1
            if gs.quiet_run < self.gate.park_after:
                continue  # hysteresis window: borderline frames still step
            gs.retained = self.pool.evict(sid)
            gs.awake = False
            gs.parks += 1
            gs.cursor = self._next_frame[sid] + 1  # the park frame is skipped
            gs.skipped += 1
            self._m_parks.inc()
            self._m_skipped.inc()
            self.tracer.instant("park", track=self.track, stream=sid,
                                cursor=gs.cursor)
            self._parked[sid] = req
            del self._inflight[sid], self._next_frame[sid]
            parked_now.add(sid)
            if self.feeder is not None:
                self.feeder.invalidate()
            if gs.cursor >= req.frames.shape[0]:
                self._gate_finish(sid, req)
        return parked_now

    def _gate_scan_parked(self, skip: Set[str]) -> None:
        """One frame per tick off each parked stream's trace: a
        wake-threshold frame sends the stream into the admission FIFO
        *at that frame* (processed once a slot frees — no re-gating while
        queued); anything quieter is skipped without touching the device."""
        if self.gate is None:
            return
        for sid in list(self._parked):
            if sid in skip:
                continue  # parked THIS tick; its frame is already consumed
            req = self._parked[sid]
            if req.arrival > self.tick_index:
                continue
            gs = self._gate_state[sid]
            if self.gate.wakes(req.frames[gs.cursor]):
                gs.awake = True
                gs.quiet_run = 0
                gs.wakes += 1
                self._m_wakes.inc()
                self.tracer.instant("wake", track=self.track, stream=sid,
                                    frame=gs.cursor)
                del self._parked[sid]
                self._queue.append(req)
            else:
                gs.cursor += 1
                gs.skipped += 1
                self._m_skipped.inc()
                if gs.cursor >= req.frames.shape[0]:
                    self._gate_finish(sid, req)

    def _assemble(self) -> Tuple[np.ndarray, np.ndarray]:
        """The tick's (batch, active) pair of the pool's staging ring: the
        feeder's prefetched pair when one is valid (patched for
        admissions/cancellations since the prefetch; a lane's frame and its
        active mark change together, as `HostBatch.fill` requires), else
        `SessionPool.stage`."""
        prefetch = self.feeder.take() if self.feeder is not None else None
        if prefetch is None:
            return self.pool.stage({
                sid: req.frames[self._next_frame[sid]]
                for sid, req in self._inflight.items()
            })
        batch, active, covered = prefetch
        # clear lanes whose stream left (or moved) since the prefetch
        for sid, slot in covered.items():
            if sid not in self._inflight or self.pool.slot_of(sid) != slot:
                active[slot] = False
                batch[slot] = 0.0
        # fill lanes the prefetch could not know about (new admissions)
        for sid, req in self._inflight.items():
            slot = self.pool.slot_of(sid)
            if covered.get(sid) != slot:
                batch[slot] = host_frame(req.frames[self._next_frame[sid]])
                active[slot] = True
        return batch, active

    def _kick_feeder(self) -> None:
        """Start assembling the NEXT tick's batch on the feeder thread
        while the card is still working on the step just enqueued.  Every
        stream still in flight here steps next tick (finished ones were
        just evicted), so the assignment is exact modulo admissions, which
        `_assemble` patches in at consume time."""
        if self.feeder is None:
            return
        items = [
            (sid, self.pool.slot_of(sid), req.frames, self._next_frame[sid])
            for sid, req in self._inflight.items()
        ]
        self.feeder.prefetch(self.pool, items)

    def tick(self) -> Dict[str, torch.Tensor]:
        """One scheduling round: admit -> step -> evict.  Returns the
        per-stream logits (on the pool's device) of every stream that
        consumed a frame.  A tick with nothing in flight (gap before the
        next arrival) only advances logical time."""
        tr, track = self.tracer, self.track
        with tr.span("tick", track=track, tick=self.tick_index):
            if self.gate is not None:
                with tr.span("gate.park", track=track):
                    parked_now = self._gate_park_inflight()
                with tr.span("gate.scan", track=track):
                    self._gate_scan_parked(parked_now)
            with tr.span("admit", track=track):
                self._admit_ready()
            stepping = list(self._inflight)
            occupancy = len(stepping) / self.pool.pool_size
            self.occupancy_trace.append(occupancy)
            self._m_occupancy.set(occupancy)
            self._m_queue.set(len(self._queue))
            tr.counter("occupancy", occupancy, track=track)
            tr.counter("queue_depth", len(self._queue), track=track)
            if not stepping:
                if self.feeder is not None:
                    self.feeder.invalidate()
                self._flush_departures()
                self.tick_index += 1
                return {}
            t0 = time.perf_counter()
            with tr.span("assemble", track=track):
                batch, active = self._assemble()
            with tr.span("step", track=track, streams=len(stepping)):
                logits = self.pool.step_prepared(batch, active)
            with tr.span("advance", track=track) as span:
                slots = {sid: self.pool.slot_of(sid) for sid in stepping}
                out = {sid: logits[slot] for sid, slot in slots.items()}
                departures = 0
                for sid in stepping:
                    self._next_frame[sid] += 1
                    req = self._inflight[sid]
                    gs = self._gate_state.get(sid)
                    if gs is not None:
                        gs.cursor = self._next_frame[sid]
                        gs.processed += 1
                        gs.last_logits = (logits, slots[sid])  # stays on the device
                    if self._next_frame[sid] >= req.frames.shape[0]:
                        self.pool.evict(sid)
                        self._depart(
                            StreamResult(
                                stream_id=sid,
                                logits=None,
                                n_frames=int(req.frames.shape[0]),
                                admitted_tick=self._admitted_tick[sid],
                                finished_tick=self.tick_index,
                                label=req.label,
                                net=req.net,
                                frames_processed=gs.processed if gs else -1,
                                frames_skipped=gs.skipped if gs else 0,
                                **self._clock_stamps(sid),
                            ),
                            logits, slots[sid],
                        )
                        del self._inflight[sid], self._next_frame[sid]
                        del self._admitted_tick[sid]
                        departures += 1
                span.set_args(departures=departures)
            self._flush_departures()
            self._kick_feeder()
            self._m_frames.inc(len(stepping))
            self.latency_trace.append(
                (self.pool.pool_size, time.perf_counter() - t0)
            )
            self.tick_index += 1
            return out

    def run(self, max_ticks: Optional[int] = None) -> List[StreamResult]:
        """Tick until every submitted stream has departed (or ``max_ticks``
        elapses — a safety valve for arrival times set in the far future)."""
        while self.pending:
            if max_ticks is not None and self.tick_index >= max_ticks:
                break
            self.tick()
        return self.results

    # -- reporting ---------------------------------------------------------

    def _net_of(self, req_or_result) -> str:
        name = req_or_result.net
        if name is None:
            name = getattr(self.pool.deployed.graph, "name", "?")
        return name

    def stats(self) -> Dict:
        """Serving-report aggregates: ticks run, streams completed and
        cancelled, queue depth, in-flight count, frames processed, mean pool
        occupancy, accuracy over the labeled requests, per-net breakdowns,
        p50/p99 per-tick host latency (over non-idle ticks), and under
        gating the processed/skipped/park/wake totals."""
        occ = self.occupancy_trace
        done = self.results
        acc = [r.correct for r in done if r.correct is not None]
        per_net: Dict[str, Dict[str, int]] = {}

        def bump(name: str, field: str) -> None:
            row = per_net.setdefault(
                name, {"completed": 0, "inflight": 0, "queued": 0}
            )
            row[field] += 1

        for r in done:
            bump(self._net_of(r), "completed")
        for req in self._inflight.values():
            bump(self._net_of(req), "inflight")
        for req in self._queue:
            bump(self._net_of(req), "queued")
        lat = np.array([s for _, s in self.latency_trace], np.float64)
        if self.gate is None:
            frames = sum(r.n_frames for r in done) + sum(self._next_frame.values())
        else:
            # gated: only device-stepped frames count (the energy axis)
            frames = sum(g.processed for g in self._gate_state.values())
        out = {
            "ticks": self.tick_index,
            "completed": len(done),
            "cancelled": len(self.cancelled),
            "queue_depth": self.queue_depth,
            "inflight": self.inflight_count,
            "frames_processed": frames,
            "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
            "accuracy": float(np.mean(acc)) if acc else float("nan"),
            "per_net": per_net,
            "latency_ms_p50": float(np.percentile(lat, 50) * 1e3)
            if lat.size else float("nan"),
            "latency_ms_p99": float(np.percentile(lat, 99) * 1e3)
            if lat.size else float("nan"),
        }
        if self.gate is not None:
            gss = self._gate_state.values()
            out["gating"] = {
                "frames_processed": frames,
                "frames_skipped": sum(g.skipped for g in gss),
                "parks": sum(g.parks for g in gss),
                "wakes": sum(g.wakes for g in gss),
                "parked": len(self._parked),
            }
        return out
