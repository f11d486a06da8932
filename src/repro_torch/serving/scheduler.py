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
latency.  On a CUDA pool a tick only *enqueues* device work; the host waits
for the device where a stream departs (its logits are copied to the host,
once per tick), so a tick's host latency is enqueue time unless a stream
finished in it.

Not carried over yet from the reference: the activity gate, the feeder
double buffer, the tracer and metrics registry arguments, `cancel` and
`swap_pool` — they arrive with the fleet, gating and observability parts of
the port.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.pool import SessionPool

# Most recent per-tick latency samples kept for p50/p99.
LATENCY_WINDOW = 4096


@dataclasses.dataclass
class StreamRequest:
    """One sensor stream to serve: ``frames`` is the ``[T, H, W, C]`` clip
    (a numpy array or a tensor), ``arrival`` the first tick the stream
    exists, ``label`` an optional ground-truth class, ``net`` an optional
    tag of the registry net it runs (stats fall back to the pool's program
    name)."""

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
    """Departure record: final-frame logits (on the host) + lifecycle ticks."""

    stream_id: str
    logits: np.ndarray  # [n_classes], after the last frame
    n_frames: int
    admitted_tick: int
    finished_tick: int
    label: Optional[int] = None
    net: Optional[str] = None

    @property
    def pred(self) -> int:
        return int(np.argmax(self.logits))

    @property
    def correct(self) -> Optional[bool]:
        if self.label is None:
            return None
        return self.pred == int(self.label)


class ContinuousBatcher:
    """FIFO admission over a `SessionPool`; finished streams free their
    slot for the head of the queue on the next tick."""

    def __init__(self, pool: SessionPool):
        self.pool = pool
        self._queue: Deque[StreamRequest] = deque()
        self._inflight: Dict[str, StreamRequest] = {}
        self._next_frame: Dict[str, int] = {}
        self._admitted_tick: Dict[str, int] = {}
        self.results: List[StreamResult] = []
        self.tick_index = 0
        self.occupancy_trace: List[float] = []
        # (pool_size, host seconds) per non-idle tick, newest LATENCY_WINDOW
        self.latency_trace: Deque[Tuple[int, float]] = deque(maxlen=LATENCY_WINDOW)

    # -- submission --------------------------------------------------------

    def submit(self, request: StreamRequest) -> None:
        """Queue one stream for admission (from its ``arrival`` tick on).
        Stream ids must be unique across the batcher's lifetime."""
        ids = (
            {r.stream_id for r in self._queue}
            | set(self._inflight)
            | {r.stream_id for r in self.results}
        )
        if request.stream_id in ids:
            raise ValueError(f"duplicate stream id {request.stream_id!r}")
        self._queue.append(request)

    def submit_many(self, requests) -> None:
        """`submit` each request in order (FIFO admission preserved)."""
        for r in requests:
            self.submit(r)

    @property
    def pending(self) -> bool:
        return bool(self._queue or self._inflight)

    @property
    def queue_depth(self) -> int:
        """Streams waiting for a slot (admitted FIFO, arrival-gated)."""
        return len(self._queue)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def admissible(self, at_tick: Optional[int] = None) -> int:
        """Queued streams whose ``arrival`` has already passed."""
        t = self.tick_index if at_tick is None else at_tick
        return sum(1 for r in self._queue if r.arrival <= t)

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
            self.pool.admit(sid)
            self._inflight[sid] = req
            self._next_frame[sid] = 0
            self._admitted_tick[sid] = self.tick_index
        self._queue.extendleft(reversed(waiting))

    def _assemble(self) -> Tuple[np.ndarray, np.ndarray]:
        """The tick's (batch, active) pair: every in-flight stream's next
        frame, slot-scattered by `pool.prepare`."""
        return self.pool.prepare({
            sid: req.frames[self._next_frame[sid]]
            for sid, req in self._inflight.items()
        })

    def tick(self) -> Dict[str, torch.Tensor]:
        """One scheduling round: admit -> step -> evict.  Returns the
        per-stream logits (on the pool's device) of every stream that
        consumed a frame.  A tick with nothing in flight (gap before the
        next arrival) only advances logical time."""
        self._admit_ready()
        stepping = list(self._inflight)
        self.occupancy_trace.append(len(stepping) / self.pool.pool_size)
        if not stepping:
            self.tick_index += 1
            return {}
        t0 = time.perf_counter()
        batch, active = self._assemble()
        logits = self.pool.step_prepared(batch, active)
        out = {sid: logits[self.pool.slot_of(sid)] for sid in stepping}
        host_logits: Optional[np.ndarray] = None  # one device->host copy per tick
        for sid in stepping:
            self._next_frame[sid] += 1
            req = self._inflight[sid]
            if self._next_frame[sid] >= req.frames.shape[0]:
                if host_logits is None:
                    host_logits = logits.detach().cpu().numpy()
                slot = self.pool.slot_of(sid)
                self.pool.evict(sid)
                self.results.append(
                    StreamResult(
                        stream_id=sid,
                        logits=host_logits[slot].copy(),
                        n_frames=int(req.frames.shape[0]),
                        admitted_tick=self._admitted_tick[sid],
                        finished_tick=self.tick_index,
                        label=req.label,
                        net=req.net,
                    )
                )
                del self._inflight[sid], self._next_frame[sid]
                del self._admitted_tick[sid]
        self.latency_trace.append((self.pool.pool_size, time.perf_counter() - t0))
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
        """Serving-report aggregates: ticks run, streams completed, queue
        depth, in-flight count, frames processed, mean pool occupancy,
        accuracy over the labeled requests, per-net breakdowns, and p50/p99
        per-tick host latency (over non-idle ticks)."""
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
        frames = sum(r.n_frames for r in done) + sum(self._next_frame.values())
        return {
            "ticks": self.tick_index,
            "completed": len(done),
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
