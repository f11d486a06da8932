"""Fleet-scale multi-tenant serving: bucketed multi-net pools + autoscaling.
Counterpart of `repro.serving.fleet`.

The paper's deployment story is thousands of always-on uJ-budget sensor
nodes; one `SessionPool` serves many streams of ONE network.  Production
means many tenants running *different* registry nets concurrently — the
`FleetRouter` here is that layer:

  * **Bucketed multi-net pools.**  Each registered net gets a `NetBucket`
    owning its own `SessionPool`s and `ContinuousBatcher`; streams are
    routed to their net's bucket by `StreamRequest.net`.  One step program
    per (net, pool size) — nets never share one.  The pools of a bucket
    share its program object, so a program's weights reach the card once
    (a `DeployedProgram`'s tables, or a `LoadedProgram`'s one executor per
    backend), not once per pool.
  * **The bucket ladder / zero-rebuild contract.**  Pool sizes only ever
    come from a fixed ladder (powers of two up to a cap).  Every ladder
    size a bucket visits constructs its pool ONCE and caches it for the
    bucket's lifetime, so autoscaling — however often it bounces between
    sizes — builds nothing new: per (net, size) one pool object
    (``pools_built`` counts constructions) whose `trace_count` is 1 once it
    has stepped — on the card each rung's pool captures its own CUDA graph
    once (each graph keeps its own private memory pool).
  * **Autoscaling.**  Driven by the batcher's own occupancy/queue-depth
    stats: demand = in-flight + admissible queued.  Grow doubles along the
    ladder until demand fits (capped); shrink waits ``shrink_after``
    consecutive calm ticks (hysteresis — a single quiet tick must not
    thrash), then drops to the smallest rung that still fits.  Streams
    migrate pool-to-pool via evict-with-state/admit-with-state, which is
    bit-exact (the `SessionPool` migration contract).
  * **Async host-side ingestion.**  The deploy step is a pure function of
    ring state, so host ingestion and device compute pipeline cleanly: a
    `FrameFeeder` thread assembles the NEXT tick's `[P, H, W, C]` frame
    batch into host double buffers (pinned when the program lies on the
    card; the thread makes no CUDA call) while the card executes the
    current step.  Falls back to synchronous
    assembly when threads are unavailable (``ingest="sync"``, or a failed
    thread spawn) — results are bit-identical either way (tested).
  * **Admission overflow -> bounded FIFO.**  A full pool spills arrivals
    into the bucket's FIFO queue (the batcher's admission queue), bounded
    by ``queue_limit``; overflowing THAT raises `FleetQueueFull` — the
    backpressure signal a fronting ingest tier would shed load on.
  * **Activity gating.**  Pass an `ActivityGate` (router-wide or per
    bucket) and every bucket's batcher duty-cycles its streams: quiet
    streams park out of their pool slot with ring state retained and stop
    counting toward autoscale demand, waking bit-identically on an event
    burst (`repro_torch.serving.gating`).
  * **Device sharding.**  ``sharding="auto"`` lays every bucket's pool
    axis across the local cards when they divide it (`SessionPool`'s
    blocks); on one card each pool is one block.

Entry points::

    router = serve_fleet({"dvs_a": dep_a, "dvs_b": dep_b})   # this module
    router = deployed.serve_fleet()                          # DeployedProgram
    router = artifact.load("net.cutie").serve_fleet()        # LoadedProgram

    router.submit(StreamRequest("cam-0", clip, net="dvs_a", arrival=0))
    results = router.run()
    report  = router.stats()    # per-net p50/p99 per bucket size, scale events

Layering: `masking` <- `pool` <- `scheduler` <- this module (policy over
many schedulers).  Nothing below imports this.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.gating import ActivityGate
from repro_torch.serving.pool import SessionPool, host_frame
from repro_torch.serving.scheduler import ContinuousBatcher, StreamRequest, StreamResult

DEFAULT_MAX_POOL = 16
DEFAULT_QUEUE_LIMIT = 64
DEFAULT_SHRINK_AFTER = 3


class FleetQueueFull(RuntimeError):
    """Raised by `submit` when a bucket's bounded admission FIFO is full —
    the shed-load/backpressure signal (the pool itself overflowing spills
    into the FIFO; only a full FIFO rejects)."""


def bucket_ladder(cap: int, base: int = 1) -> Tuple[int, ...]:
    """The fixed pool-size ladder: ``base`` doubling up to (and including)
    ``cap``.  A non-power-of-two cap becomes the last rung as-is, so the
    cap is always reachable: ``bucket_ladder(12) == (1, 2, 4, 8, 12)``."""
    if cap < base or base < 1:
        raise ValueError(f"need cap >= base >= 1, got cap={cap}, base={base}")
    rungs = [base << i for i in range(int(math.log2(cap / base)) + 1)]
    if rungs[-1] != cap:
        rungs.append(cap)
    return tuple(rungs)


@dataclasses.dataclass
class ScaleEvent:
    """One autoscale decision: bucket ``net`` moved ``from_size`` ->
    ``to_size`` at ``tick`` because of ``demand`` (in-flight + admissible
    queued) — the audit trail `stats()` reports."""

    tick: int
    net: str
    from_size: int
    to_size: int
    demand: int
    reason: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FrameFeeder:
    """Async host-side frame ingestion: double buffers + one feeder thread
    per bucket.

    The pool step is a pure function of (ring state, frame batch), and the
    NEXT tick's stream->frame assignment is host-side bookkeeping (clip
    cursors), so the host can assemble tick t+1's batch while the device
    executes tick t.  `prefetch` schedules the assembly (on the thread, or
    inline in sync mode); `take` joins and hands the batch over; buffers
    alternate per prefetch so the one the device just copied from is the
    one being refilled.  The batcher patches the prefetched batch for
    admissions/cancellations that happened after the prefetch, so the
    pipelining is invisible to the numerics (async == sync bit-identical,
    tested in tests/test_torch_fleet.py).

    With ``pin_memory=True`` (a bucket whose program lies on the card)
    the buffers are pinned host tensors, allocated on the calling (main)
    thread, and the thread fills their numpy views: it makes no CUDA call.
    `SessionPool.step_prepared` copies a pinned buffer to the card without
    blocking and records an event (`SessionPool.last_upload`), which the
    batcher hands back through `copied`; before a buffer is given out for
    refilling, `prefetch` waits on that event, so no host buffer is
    rewritten while a copy from it is in flight.  Without pinning the
    buffers are plain numpy and the copy is synchronous.

    ``mode``: "thread" (require a thread; fall back to sync only if spawn
    fails), "sync" (always inline), "auto" (try thread, fall back quietly).
    """

    def __init__(self, mode: str = "auto", pin_memory: bool = False):
        if mode not in ("auto", "thread", "sync"):
            raise ValueError(f"unknown ingest mode {mode!r}")
        self.pin_memory = pin_memory
        self._executor: Optional[ThreadPoolExecutor] = None
        if mode != "sync":
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cutie-feeder"
            )
        self._pending: Optional[Future] = None
        # (pool_size, frame_shape) -> ([_HostBatch x 2], flip index): the
        # double buffers, one pair per ladder size the bucket visits
        self._bufs: Dict[Tuple[int, Tuple[int, ...]], list] = {}
        self._filling: Optional[_HostBatch] = None  # the buffer `_pending` fills
        self._taken: Optional[_HostBatch] = None    # handed out by `take`
        self._threaded = self._executor is not None
        # fill spans carry no track, so they land on the lane of the
        # thread that ran the fill — the cutie-feeder thread when threaded
        self.tracer = NULL_TRACER
        self.track: Optional[str] = None

    def bind_tracer(self, tracer, track: Optional[str] = None) -> None:
        """Attach a tracer (the batcher wires its own through, so feeder
        spans land in the same trace as the tick spans)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if track is not None:
            self.track = track

    @property
    def threaded(self) -> bool:
        """False once running in sync-fallback mode."""
        return self._threaded

    def _buffers(self, pool_size: int, frame_shape: Tuple[int, ...]) -> "_HostBatch":
        key = (pool_size, tuple(frame_shape))
        entry = self._bufs.get(key)
        if entry is None:
            pair = [_HostBatch(pool_size, frame_shape, self.pin_memory) for _ in range(2)]
            entry = self._bufs[key] = [pair, 0]
        pair, flip = entry
        entry[1] = flip ^ 1
        buf = pair[flip]
        if buf.copied is not None:
            buf.copied.synchronize()  # its last copy to the card has landed
            buf.copied = None
        return buf

    def copied(self, event) -> None:
        """Attach the event of the copy from the buffer `take` handed out
        (`SessionPool.last_upload`; None for a synchronous copy): that
        buffer is refilled only once the event has completed."""
        if self._taken is not None:
            self._taken.copied = event
            self._taken = None

    def _fill(self, batch: np.ndarray, active: np.ndarray, items):
        with self.tracer.span("feeder.fill", streams=len(items)):
            batch.fill(0.0)
            active.fill(False)
            covered: Dict[str, int] = {}
            for sid, slot, frames, idx in items:
                batch[slot] = host_frame(frames[idx])
                active[slot] = True
                covered[sid] = slot
            return batch, active, covered

    def prefetch(self, pool_size: int, frame_shape, items: Sequence) -> None:
        """Assemble the next tick's batch for ``items`` = [(stream_id,
        slot, clip, frame_index), ...] into the back buffer — on the
        feeder thread when available, inline otherwise."""
        self.invalidate()  # at most one prefetch outstanding
        buf = self._filling = self._buffers(pool_size, frame_shape)
        batch, active = buf.batch, buf.active
        if self._executor is not None:
            try:
                self._pending = self._executor.submit(
                    self._fill, batch, active, list(items)
                )
                return
            except RuntimeError:
                # interpreter shutting down / thread spawn refused: fall
                # back to synchronous assembly for the rest of this run
                self._executor = None
                self._threaded = False
        done: Future = Future()
        done.set_result(self._fill(batch, active, list(items)))
        self._pending = done

    def take(self):
        """The prefetched (batch, active, covered) triple, or None when no
        prefetch is outstanding (first tick, or after `invalidate`)."""
        self._taken = None
        if self._pending is None:
            return None
        with self.tracer.span("feeder.consume", track=self.track):
            result = self._pending.result()
        self._pending = None
        self._taken = self._filling
        return result

    def invalidate(self) -> None:
        """Discard any outstanding prefetch (joining the thread first —
        the buffer must not be written while a later prefetch reuses it).
        Called on pool swaps and cancellations, whose re-slotting the
        prefetched assignment can no longer describe."""
        if self._pending is not None:
            self.tracer.instant("feeder.invalidate", track=self.track)
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.invalidate()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None


class _HostBatch:
    """One of a feeder's double buffers: the ``(batch, active)`` numpy
    arrays the fill writes — views of pinned tensors when pinned — and the
    event of the last copy from them to the card still to be waited on."""

    def __init__(self, pool_size: int, frame_shape: Tuple[int, ...], pin: bool):
        shapes = ((pool_size, *frame_shape), (pool_size,))
        if pin:
            self.pinned = (torch.zeros(shapes[0], dtype=torch.float32, pin_memory=True),
                           torch.zeros(shapes[1], dtype=torch.bool, pin_memory=True))
            self.batch, self.active = (t.numpy() for t in self.pinned)
        else:
            self.pinned = None
            self.batch = np.zeros(shapes[0], np.float32)
            self.active = np.zeros(shapes[1], bool)
        self.copied = None


class NetBucket:
    """One net's serving unit inside the fleet: its pools (one per ladder
    size visited, each built once), its batcher, its feeder, and its
    autoscale state.  Not constructed directly — `FleetRouter.register`."""

    def __init__(
        self,
        name: str,
        program,
        backend: str,
        ladder: Tuple[int, ...],
        queue_limit: int = DEFAULT_QUEUE_LIMIT,
        shrink_after: int = DEFAULT_SHRINK_AFTER,
        ingest: str = "auto",
        sharding=None,
        gate: Optional[ActivityGate] = None,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        if not getattr(program.graph, "is_temporal", False):
            raise ValueError(
                f"{name}: fleet buckets pool TCN ring state; "
                f"{getattr(program.graph, 'name', program)} is not temporal"
            )
        if list(ladder) != sorted(set(ladder)) or ladder[0] < 1:
            raise ValueError(f"ladder must be ascending positive sizes, got {ladder}")
        if queue_limit < 1 or shrink_after < 1:
            raise ValueError("queue_limit and shrink_after must be >= 1")
        self.name = name
        self.program = program
        self.backend = backend
        self.ladder = tuple(ladder)
        self.queue_limit = queue_limit
        self.shrink_after = shrink_after
        self.sharding = sharding
        self.gate = gate
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pools: Dict[int, SessionPool] = {}
        # rung -> SessionPool constructions: the zero-rebuild audit (1 each)
        self.pools_built: Dict[int, int] = {}
        self.feeder = FrameFeeder(
            mode=ingest, pin_memory=torch.device(program.device).type == "cuda",
        ) if ingest != "off" else None
        # the bucket's routing key is the export lane: every tick / gate /
        # step span of this bucket lands on one named Perfetto track
        self.batcher = ContinuousBatcher(
            self._pool(self.ladder[0]), feeder=self.feeder, gate=gate,
            tracer=tracer, metrics=metrics, track=name,
        )
        self.scale_events: List[ScaleEvent] = []
        self._calm_ticks = 0

    # -- the zero-rebuild pool cache ---------------------------------------

    def _pool(self, size: int) -> SessionPool:
        """The bucket's pool at ladder rung ``size`` — constructed at most
        once in the bucket's lifetime, then reused on every return to that
        rung."""
        pool = self.pools.get(size)
        if pool is None:
            pool = self.pools[size] = SessionPool(
                self.program, size, backend=self.backend,
                sharding=self.sharding,
            )
            self.pools_built[size] = self.pools_built.get(size, 0) + 1
        return pool

    @property
    def size(self) -> int:
        """Current ladder rung (the active pool's slot count)."""
        return self.batcher.pool.pool_size

    # -- admission ---------------------------------------------------------

    def submit(self, request: StreamRequest) -> None:
        """Admit into the pool or spill into the bounded FIFO; a full FIFO
        raises `FleetQueueFull` (shed load upstream)."""
        if self.batcher.queue_depth >= self.queue_limit:
            self.tracer.instant(
                "queue_full", track=self.name, stream=request.stream_id,
                queued=self.batcher.queue_depth, pool_size=self.size)
            raise FleetQueueFull(
                f"bucket {self.name!r}: admission FIFO full "
                f"({self.queue_limit} queued; pool {self.size} slots)"
            )
        if request.net is None:
            request = dataclasses.replace(request, net=self.name)
        self.batcher.submit(request)

    # -- autoscaling -------------------------------------------------------

    def _rung_for(self, demand: int) -> int:
        """Smallest ladder rung holding ``demand`` streams (the cap when
        nothing does)."""
        for size in self.ladder:
            if size >= demand:
                return size
        return self.ladder[-1]

    def autoscale(self) -> Optional[ScaleEvent]:
        """One scaling decision, called at the top of every tick.

        Grow immediately when demand exceeds the current rung (doubling
        along the ladder to the first rung that fits, capped).  Shrink
        only after ``shrink_after`` consecutive ticks of demand fitting a
        smaller rung — the hysteresis that keeps a flickering sensor from
        thrashing pool swaps.  Swaps migrate in-flight state bit-exactly
        and never build a pool twice (pools are cached per rung)."""
        b = self.batcher
        demand = b.inflight_count + b.admissible()
        cur = self.size
        if demand > cur and cur < self.ladder[-1]:
            self._calm_ticks = 0
            return self._swap(self._rung_for(demand), demand, "grow")
        fit = self._rung_for(max(demand, 1))
        if fit < cur:
            self._calm_ticks += 1
            if self._calm_ticks >= self.shrink_after:
                self._calm_ticks = 0
                return self._swap(fit, demand, "shrink")
        else:
            self._calm_ticks = 0
        return None

    def _swap(self, new_size: int, demand: int, reason: str) -> ScaleEvent:
        event = ScaleEvent(
            tick=self.batcher.tick_index, net=self.name,
            from_size=self.size, to_size=new_size,
            demand=demand, reason=reason,
        )
        self.batcher.swap_pool(self._pool(new_size))
        self.scale_events.append(event)
        self.tracer.instant("scale", track=self.name, **event.to_dict())
        return event

    # -- the loop ----------------------------------------------------------

    def tick(self) -> Dict[str, object]:
        self.autoscale()
        return self.batcher.tick()

    @property
    def pending(self) -> bool:
        return self.batcher.pending

    # -- reporting ---------------------------------------------------------

    def latency_by_pool_size(self) -> Dict[int, Dict[str, float]]:
        """p50/p99 per-tick latency grouped by the rung each tick ran at —
        the "how does tail latency scale with batch width" table."""
        groups: Dict[int, List[float]] = {}
        for size, seconds in self.batcher.latency_trace:
            groups.setdefault(size, []).append(seconds)
        return {
            size: {
                "ticks": len(samples),
                "p50_ms": float(np.percentile(samples, 50) * 1e3),
                "p99_ms": float(np.percentile(samples, 99) * 1e3),
            }
            for size, samples in sorted(groups.items())
        }

    def stats(self) -> Dict:
        """The batcher's stats plus bucket-level serving state: current
        rung, per-rung step builds (``pools_traced``: CUDA-graph captures
        on the card) and pool constructions (the zero-rebuild audit), scale
        events, per-rung latency percentiles, and the ingestion mode."""
        s = self.batcher.stats()
        s.update(
            net=self.name,
            backend=self.backend,
            pool_size=self.size,
            ladder=list(self.ladder),
            pools_traced={
                size: pool.trace_count for size, pool in sorted(self.pools.items())
            },
            pools_built=dict(sorted(self.pools_built.items())),
            scale_events=[e.to_dict() for e in self.scale_events],
            latency_by_pool_size=self.latency_by_pool_size(),
            ingest_threaded=bool(self.feeder is not None and self.feeder.threaded),
        )
        return s

    def close(self) -> None:
        if self.feeder is not None:
            self.feeder.close()


class FleetRouter:
    """Multi-tenant serving front: routes streams to per-net buckets and
    advances every bucket in lockstep logical time.

        router = FleetRouter()
        router.register("gesture", deployed_a)
        router.register("gesture_lite", deployed_b, backend="ref")
        router.submit(StreamRequest("cam-0", clip, net="gesture"))
        results = router.run()

    ``tick()`` rounds all buckets once (so `StreamRequest.arrival` means
    the same tick in every bucket); `run()` drains the whole fleet.
    """

    def __init__(
        self,
        backend: str = "fused",
        max_pool_size: int = DEFAULT_MAX_POOL,
        ladder: Optional[Sequence[int]] = None,
        queue_limit: int = DEFAULT_QUEUE_LIMIT,
        shrink_after: int = DEFAULT_SHRINK_AFTER,
        ingest: str = "auto",
        sharding=None,
        gate: Optional[ActivityGate] = None,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.backend = backend
        self.ladder = tuple(ladder) if ladder else bucket_ladder(max_pool_size)
        self.queue_limit = queue_limit
        self.shrink_after = shrink_after
        self.ingest = ingest
        self.sharding = sharding
        self.gate = gate
        # one tracer + one registry span the whole fleet: every bucket's
        # events land in one trace (lane per bucket), every bucket's
        # series in one scrape, keyed by net label
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.buckets: Dict[str, NetBucket] = {}
        self.tick_index = 0

    # -- registration ------------------------------------------------------

    def register(
        self,
        name: str,
        program,
        backend: Optional[str] = None,
        ladder: Optional[Sequence[int]] = None,
        queue_limit: Optional[int] = None,
        gate: Optional[ActivityGate] = None,
    ) -> NetBucket:
        """Add a net to the fleet under routing key ``name``.  ``program``
        is anything the pool serves — a `DeployedProgram` or a loaded
        ``.cutie`` `LoadedProgram`.  Per-net overrides default to the
        router-wide settings."""
        if name in self.buckets:
            raise ValueError(f"net {name!r} already registered")
        bucket = NetBucket(
            name=name,
            program=program,
            backend=backend or self.backend,
            ladder=tuple(ladder) if ladder else self.ladder,
            queue_limit=queue_limit or self.queue_limit,
            shrink_after=self.shrink_after,
            ingest=self.ingest,
            sharding=self.sharding,
            gate=gate if gate is not None else self.gate,
            tracer=self.tracer,
            metrics=self.metrics,
        )
        self.buckets[name] = bucket
        return bucket

    def _bucket(self, net: Optional[str]) -> NetBucket:
        if not self.buckets:
            raise KeyError("no nets registered; call register() first")
        if net is None:
            if len(self.buckets) == 1:
                return next(iter(self.buckets.values()))
            raise KeyError(
                f"request has no net and the fleet serves "
                f"{sorted(self.buckets)}; set StreamRequest.net"
            )
        if net not in self.buckets:
            raise KeyError(
                f"unknown net {net!r}; registered: {sorted(self.buckets)}"
            )
        return self.buckets[net]

    # -- admission ---------------------------------------------------------

    def submit(self, request: StreamRequest) -> None:
        """Route one stream to its net's bucket (`FleetQueueFull` when the
        bucket's bounded FIFO is already full)."""
        self._bucket(request.net).submit(request)

    def submit_many(self, requests) -> None:
        for r in requests:
            self.submit(r)

    # -- the loop ----------------------------------------------------------

    def tick(self) -> Dict[str, Dict[str, object]]:
        """One fleet round: every bucket autoscales and ticks once.
        Returns {net: {stream_id: logits row on the device}} for buckets
        that stepped."""
        out: Dict[str, Dict[str, object]] = {}
        for name, bucket in self.buckets.items():
            step_out = bucket.tick()
            if step_out:
                out[name] = step_out
        self.tick_index += 1
        return out

    @property
    def pending(self) -> bool:
        return any(b.pending for b in self.buckets.values())

    def run(self, max_ticks: Optional[int] = None) -> List[StreamResult]:
        """Tick until every bucket drains (or ``max_ticks``); returns all
        `StreamResult`s, grouped by net in registration order."""
        while self.pending:
            if max_ticks is not None and self.tick_index >= max_ticks:
                break
            self.tick()
        return self.results

    @property
    def results(self) -> List[StreamResult]:
        out: List[StreamResult] = []
        for bucket in self.buckets.values():
            out.extend(bucket.batcher.results)
        return out

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict:
        """Fleet report: per-net bucket stats (latency percentiles per
        rung, scale events, rebuild audit) + cross-net aggregates."""
        nets = {name: b.stats() for name, b in self.buckets.items()}
        lat = np.array(
            [s for b in self.buckets.values()
             for _, s in b.batcher.latency_trace],
            np.float64,
        )
        gated = [s["gating"] for s in nets.values() if "gating" in s]
        return {
            "nets": nets,
            "gating": {
                "frames_processed": sum(g["frames_processed"] for g in gated),
                "frames_skipped": sum(g["frames_skipped"] for g in gated),
                "parks": sum(g["parks"] for g in gated),
                "wakes": sum(g["wakes"] for g in gated),
                "parked": sum(g["parked"] for g in gated),
            } if gated else None,
            "aggregate": {
                "nets": len(self.buckets),
                "ticks": self.tick_index,
                "completed": sum(s["completed"] for s in nets.values()),
                "cancelled": sum(s["cancelled"] for s in nets.values()),
                "frames_processed": sum(
                    s["frames_processed"] for s in nets.values()
                ),
                "latency_ms_p50": float(np.percentile(lat, 50) * 1e3)
                if lat.size else float("nan"),
                "latency_ms_p99": float(np.percentile(lat, 99) * 1e3)
                if lat.size else float("nan"),
            },
        }

    def close(self) -> None:
        """Shut down every bucket's feeder thread (idempotent)."""
        for bucket in self.buckets.values():
            bucket.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"FleetRouter(nets={sorted(self.buckets)}, "
            f"ladder={self.ladder}, backend={self.backend!r})"
        )


def serve_fleet(
    programs: Mapping[str, object], backend: str = "fused", **kwargs
) -> FleetRouter:
    """Build a `FleetRouter` serving ``programs`` ({net name -> deployed/
    loaded program}).  Keyword arguments pass through to `FleetRouter`."""
    router = FleetRouter(backend=backend, **kwargs)
    for name, program in programs.items():
        router.register(name, program)
    return router
