"""`SessionPool` — continuous batching of many sensor streams on one
fixed-shape step.  Counterpart of `repro.serving.pool`.

    pool = deployed.serve(pool_size=8, backend="fused")
    pool.admit("sensor-a"); pool.admit("sensor-b")
    out = pool.step({"sensor-a": frame_a, "sensor-b": frame_b})
    state = pool.evict("sensor-a")          # slot free, refill next tick
    pool.admit("sensor-c")                  # shapes unchanged

Key properties (tested in tests/test_torch_serving.py and
tests/test_torch_serving_static.py):

  * **Fixed shape, one step — captured once on the card.**  Every tick
    runs the same ``[P, H, W, C]`` batch through the same kernels; admit /
    evict / partial ticks are data (the ``active`` mask and the frame
    batch), never shapes.  The pool owns static device tensors — the frame
    batch, the ``active`` mask, the `PoolState` — and every tick and every
    slot operation writes into them in place, so they keep their addresses
    for the pool's life.  On a CUDA device with ``jit=True`` (the default)
    the first tick runs the step eagerly and then captures it as a CUDA
    graph (`repro_torch.capture.CapturedStep`, the counterpart of the
    reference's ``jax.jit``); every later tick copies the batch in and
    replays the graph.  On the CPU, or with ``jit=False``, the step runs
    eagerly every tick.  `trace_count` counts captures on the card and
    step builds elsewhere: 0 before the first step, 1 after, never more.
    A capture or replay that fails raises; ``jit=False`` is the only way to
    the eager step on the card.
  * **Bit-exact per stream.**  Each slot's logits equal an independent
    `StreamSession` fed the same frames, on every backend.
  * **Migratable sessions.**  `evict` returns the stream's `StreamState`;
    `admit(sid, state=...)` scatters it back in — into this pool, another
    pool, or a standalone `StreamSession`.

Empty slots still compute (a zero frame through the CNN) — like the silicon,
which clocks every OCU whether or not the pixel is useful.

The pool is duck-typed over its program: anything exposing
``spatial_forward(frames, backend)`` / ``temporal_forward(windows,
backend)``, a ``.device`` and a ``.graph`` with ``name`` / ``is_temporal`` /
``input_hw`` / ``input_ch`` / ``tcn_steps`` / ``feature_channels`` — a
`DeployedProgram`, or a `repro_torch.artifact.LoadedProgram` whose ``.graph``
is the artifact's `ProgramInfo` header.

Frames reach the card from the pool's own staging ring: two `HostBatch`
pairs, pinned on a card (plain host tensors elsewhere), made on first use
and handed out in turn by `next_pair`, which waits, where needed, for the
pair's last copy to the card to land.  `stage` fills the next pair with a
tick's frames (`HostBatch.fill`: of what the pair held, only the active
lanes that get no frame now are zeroed); a fleet feeder fills it on its own
thread (`repro_torch.serving.fleet.FrameFeeder`).  `step_prepared` copies
a pair without blocking where it is pinned, records the pair's events
after the copy, and refuses arrays that are not a pair of this pool's
ring; it returns a new logits tensor every tick.

**Tracing.**  Under the bound tracer's ``pool.step`` span, ``pool.upload``
(args ``bytes``, ``pinned``, and ``staged``, always true: the batch is a
pair of the pool's ring) covers the batch's copy, an enqueue from the
pinned pair on a card, and ``pool.replay`` (arg ``k1``: the K1 launches
the replays hold, from `CapturedStep.k1_per_replay`, 0 on the tick that
builds the step; ``k1_wgmma``: those of them on K1's wgmma route) the
blocks' steps and the concatenation, host enqueue only.  An instant ``pool.stage_wait`` (arg ``waited_us``) marks a
`next_pair` that had to wait for a ring pair's earlier copy to land.  An
instant ``pool.build`` (arg ``capture_s``) marks each block's build of its
step.
With an enabled wall-clock tracer on a CUDA pool, `bind_tracer` binds a
`repro_torch.obs.device.DeviceSpans`: timing events before the upload,
between upload and replay, and after the replay, recorded outside the
graph, resolved without waiting at the next step into ``dev.upload`` and
``dev.replay`` spans of device time on the lane ``<track>.device`` (one
lane per device, ``<track>.device<i>``, for a sharded pool); a step is
timed at most every 5 ms of host time, and resolving is an ``obs.resolve``
span under ``pool.step`` (`repro_torch.obs.device`).  Otherwise the pool
holds `NULL_DEVICE_SPANS`, whose calls do nothing.

**Batch-axis sharding.**  ``sharding`` lays the pool axis across devices as
the reference's ``PartitionSpec("pool")`` does: a `PoolSharding` over n
devices gives device i the contiguous block of slots ``[i*P/n, (i+1)*P/n)``.
Each block owns its static tensors and its own step (one capture on the
card); a tick splits the assembled batch by block, runs every block's step
and returns the logits in slot order; slot surgery addresses the block
that holds the slot, in place.  ``sharding="auto"`` (or True) takes every
local device of the program's kind when there are several and they divide
the pool (else None: one block); an int asks for exactly that many.  A
block on another device than the program's runs a copy of it there
(``program.to(device)``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.capture import CapturedStep
from repro_torch.core.tcn import StreamState
from repro_torch.obs.device import NULL_DEVICE_SPANS, DeviceSpans, records_device_time
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.masking import (
    PoolState,
    clear_slot_,
    gather_slot,
    masked_push_,
    ordered_windows,
    scatter_slot_,
)


def host_frame(frame) -> np.ndarray:
    """One frame (numpy array, or a tensor) as a host float32 array."""
    if isinstance(frame, torch.Tensor):
        frame = frame.detach().cpu().numpy()
    return np.asarray(frame, np.float32)


class HostBatch:
    """A pair of a pool's staging ring: ``tensors``, a ``[P, *frame_shape]``
    float32 batch and a ``[P]`` bool active mask, pinned when ``pin``
    (copies to a card then do not block), and their numpy views ``batch`` /
    ``active``, which the host writes; ``copied``, the events of the last
    copy from them to the card, which must have completed before the host
    rewrites them (None: nothing to wait for; `SessionPool.next_pair`
    waits).  A lane is non-zero only where ``active`` is set: every writer
    sets the two together."""

    def __init__(self, pool_size: int, frame_shape: Tuple[int, ...], pin: bool):
        self.tensors = (
            torch.zeros((pool_size, *frame_shape), dtype=torch.float32, pin_memory=pin),
            torch.zeros((pool_size,), dtype=torch.bool, pin_memory=pin))
        self.batch, self.active = (t.numpy() for t in self.tensors)
        self.pinned = pin
        self.copied = None

    def fill(self, frames: Sequence[Tuple[str, int, object]]) -> None:
        """One tick's batch: each ``(stream id, lane, frame)`` of ``frames``
        (a frame may carry a leading length-1 axis) into its lane, marked
        active; every other lane zero and inactive.  Zeroes only the active
        lanes that get no frame now.  Makes no CUDA call and reads no slot
        bookkeeping, so a feeder thread may run it."""
        lanes = {lane for _, lane, _ in frames}
        stale = [lane for lane in np.flatnonzero(self.active).tolist() if lane not in lanes]
        if stale:
            self.batch[stale] = 0.0
            self.active[stale] = False
        shape = self.batch.shape[1:]
        for sid, lane, frame in frames:
            f = host_frame(frame)
            if f.shape == (1, *shape):
                f = f[0]
            if f.shape != shape:
                raise ValueError(f"stream {sid!r}: frame shape {f.shape} != {shape}")
            self.batch[lane] = f
            self.active[lane] = True


class PoolFullError(RuntimeError):
    """Raised by `admit` when every slot is occupied (callers queue — see
    `repro_torch.serving.scheduler.ContinuousBatcher`)."""


class PoolSharding:
    """The pool axis laid over ``devices`` (the reference's
    ``NamedSharding(Mesh(devices, ("pool",)), PartitionSpec("pool"))``):
    device i holds the i-th contiguous block of P/n slots.  A device may
    repeat: two blocks on one device run the same code as two cards."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("PoolSharding needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"PoolSharding({[str(d) for d in self.devices]})"


def _local_devices(device: torch.device) -> List[torch.device]:
    """Every local device of ``device``'s kind: each card, or the one CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _resolve_sharding(sharding, pool_size: int,
                      device: torch.device) -> Optional[PoolSharding]:
    """Turn the user-facing ``sharding`` argument into a `PoolSharding` (or
    None).  "auto"/True shard over all local devices when that divides the
    pool evenly; an int requests exactly that many devices (hard error when
    impossible); a `PoolSharding` passes through."""
    if sharding is None or sharding is False:
        return None
    if isinstance(sharding, PoolSharding):
        if pool_size % len(sharding):
            raise ValueError(
                f"pool_size {pool_size} not divisible by {len(sharding)} devices")
        return sharding
    devices = _local_devices(torch.device(device))
    if sharding == "auto" or sharding is True:
        n = len(devices)
        if n <= 1 or pool_size % n:
            return None
    elif isinstance(sharding, int):
        n = sharding
        if n > len(devices):
            raise ValueError(f"requested {n} devices, host has {len(devices)}")
        if pool_size % n:
            raise ValueError(f"pool_size {pool_size} not divisible by {n} devices")
    else:
        raise ValueError(f"unknown sharding spec {sharding!r}")
    return PoolSharding(devices[:n])


class _Block:
    """Slots ``[lo, lo + size)`` of a pool on one device: the program there,
    the static tensors the step reads and writes in place, and the step."""

    def __init__(self, program, lo: int, size: int, backend: str, jit: bool,
                 frame_shape: Tuple[int, ...]):
        g = program.graph
        self.program = program
        self.lo, self.size = lo, size
        self.backend = backend
        self.device = program.device
        self.state = PoolState.create(size, g.tcn_steps, g.feature_channels,
                                      device=self.device)
        self.frames = torch.zeros((size, *frame_shape), dtype=torch.float32,
                                  device=self.device)
        self.active = torch.zeros((size,), dtype=torch.bool, device=self.device)
        self.step = CapturedStep(self._run_step, self.device, capture=jit)

    def _run_step(self) -> torch.Tensor:
        """The block's step over its static tensors: CNN frontend ->
        masked ring push (in place) -> TCN head.  Returns the logits."""
        feats = self.program.spatial_forward(self.frames, self.backend)
        masked_push_(self.state, feats, self.active)
        return self.program.temporal_forward(ordered_windows(self.state), self.backend)


class _Events(tuple):
    """The events of one upload, one per device of the pool."""

    def query(self) -> bool:
        return all(event.query() for event in self)

    def synchronize(self) -> None:
        for event in self:
            event.synchronize()


class SessionPool:
    """Fixed-shape multi-stream serving state over one `DeployedProgram`.

    The pool owns a slot-masked `PoolState` (``[P, T, C]`` ring + per-slot
    cursors), a ``[P, H, W, C]`` frame batch and a ``[P]`` active mask on
    the program's device, and one step: CNN frontend on the frame batch ->
    masked ring push -> TCN head on the ``[P, T, C]`` ordered windows.
    With ``sharding``, each device's block of slots has its own (see the
    module docstring).  Slot bookkeeping (which stream sits where) is plain
    host-side Python.
    """

    def __init__(self, deployed, pool_size: int, backend: str = "fused",
                 jit: bool = True, sharding=None, tracer=None):
        from repro_torch.api.program import check_backend

        check_backend(backend)
        if not deployed.graph.is_temporal:
            raise ValueError(f"{deployed.graph.name} has no TCN memory to pool: serve "
                             "its images with DeployedProgram.classify()")
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.deployed = deployed
        self.pool_size = pool_size
        self.backend = backend
        self.jit = jit
        self.device = deployed.device
        self.sharding = _resolve_sharding(sharding, pool_size, self.device)
        g = deployed.graph
        self.frame_shape: Tuple[int, ...] = (*g.input_hw, g.input_ch)
        devices = self.sharding.devices if self.sharding is not None else (self.device,)
        size = pool_size // len(devices)
        self._blocks = [
            _Block(deployed if dev == self.device else deployed.to(dev), i * size, size,
                   backend, jit, self.frame_shape)
            for i, dev in enumerate(devices)
        ]
        self._devices = list(dict.fromkeys(b.device for b in self._blocks))
        # the staging ring (`next_pair`): two HostBatch pairs once used, the next one's index
        self._ring: List[HostBatch] = []
        self._flip = 0
        self._slots: List[Optional[str]] = [None] * pool_size
        self._slot_of: Dict[str, int] = {}
        # observability: NULL_TRACER when tracing is off (no-op span, no
        # branch in the hot path); spans wrap the step from the outside
        self.tracer = NULL_TRACER
        self.track = getattr(deployed.graph, "name", "pool")
        self._device_spans = NULL_DEVICE_SPANS
        self._k1 = self._k1_wgmma = 0  # K1 launches a replay of every block holds
        self._dev_args: List[Dict] = []  # the device spans' args, per device
        self.bind_tracer(tracer)

    @property
    def state(self) -> PoolState:
        """The pooled ring state: the block's own on one device, else a copy
        of every block's, in slot order, on the first block's device."""
        if len(self._blocks) == 1:
            return self._blocks[0].state
        dev = self._blocks[0].device
        return PoolState(*(torch.cat([getattr(b.state, f).to(dev) for b in self._blocks])
                           for f in ("buf", "cursor", "steps")))

    def _locate(self, slot: int) -> Tuple[_Block, int]:
        """The block holding ``slot`` and the slot's index in it."""
        block = self._blocks[slot // self._blocks[0].size]
        return block, slot - block.lo

    # -- admission control -------------------------------------------------

    def admit(self, stream_id: str, state: Optional[StreamState] = None) -> int:
        """Claim a free slot for ``stream_id`` and return its index.

        With ``state`` given, the stream resumes exactly where it left off;
        without it the slot is zeroed — a fresh ring.  Raises
        `PoolFullError` when no slot is free and ValueError on a duplicate
        id — admission never silently displaces a live stream."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id!r} already admitted")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise PoolFullError(
                f"all {self.pool_size} slots busy; evict before admitting"
            ) from None
        block, i = self._locate(slot)
        if state is None:
            clear_slot_(block.state, i)
        else:
            scatter_slot_(block.state, i, state)
        self._slots[slot] = stream_id
        self._slot_of[stream_id] = slot
        return slot

    def evict(self, stream_id: str) -> StreamState:
        """Release the stream's slot and hand back its `StreamState` (resume
        later via ``admit(sid, state=...)`` or ``StreamSession.load_state``).
        The slot is refillable immediately."""
        slot = self._slot_of.pop(self._require(stream_id))
        self._slots[slot] = None
        block, i = self._locate(slot)
        return gather_slot(block.state, i)

    def reset(self, stream_id: str) -> None:
        """Per-slot reset: zero this stream's ring and age, leaving every
        other slot untouched."""
        block, i = self._locate(self._slot_of[self._require(stream_id)])
        clear_slot_(block.state, i)

    def _require(self, stream_id: str) -> str:
        if stream_id not in self._slot_of:
            raise KeyError(
                f"unknown stream {stream_id!r}; active: {sorted(self._slot_of)}"
            )
        return stream_id

    # -- the hot path ------------------------------------------------------

    def stage(self, frames: Mapping[str, object]) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side batch assembly: each admitted stream's frame of
        ``frames`` (numpy arrays or tensors, ``[H, W, C]`` or with a leading
        length-1 axis) into its slot's lane of the ring's next pair
        (`next_pair`, `HostBatch.fill`), marked active; every other lane
        zero and inactive.  Returns the pair's ``(batch, active)`` numpy
        views, which the ring hands out again after its other pair.  No
        device work; `step_prepared` copies them without blocking where
        they are pinned."""
        lanes = [(sid, self._slot_of[self._require(sid)], f) for sid, f in frames.items()]
        pair = self.next_pair()
        pair.fill(lanes)
        return pair.batch, pair.active

    def next_pair(self) -> HostBatch:
        """The ring's next pair, once the last copy from it has landed:
        waits for it, as an instant ``pool.stage_wait``, if it is still in
        flight.  `stage` fills the pair; a fleet feeder takes it on the
        calling thread and fills it on its own."""
        if not self._ring:
            pin = self.device.type == "cuda"
            self._ring = [HostBatch(self.pool_size, self.frame_shape, pin) for _ in range(2)]
        pair = self._ring[self._flip]
        self._flip ^= 1
        if pair.copied is not None and not pair.copied.query():
            t0 = time.perf_counter_ns()
            pair.copied.synchronize()
            self.tracer.instant("pool.stage_wait", track=self.track,
                                waited_us=(time.perf_counter_ns() - t0) / 1e3)
        return pair

    def _upload(self, batch: np.ndarray, active: np.ndarray) -> None:
        """Copy a pair of the staging ring into the static device inputs:
        without blocking from pinned memory, then recording the pair's
        events (``copied``) on each device's stream; synchronously
        otherwise.  Arrays that are not a pair of this pool's ring are
        refused."""
        with self.tracer.span("pool.upload", track=self.track) as span:
            pair = next((p for p in self._ring if batch is p.batch and active is p.active),
                        None)
            if pair is None:
                raise ValueError("step_prepared takes a (batch, active) pair from this "
                                 "pool's stage(); these arrays are not one")
            src_b, src_a = pair.tensors
            span.set_args(bytes=src_b.nbytes + src_a.nbytes, pinned=pair.pinned, staged=True)
            self._device_spans.mark(0)
            for b in self._blocks:
                b.frames.copy_(src_b[b.lo:b.lo + b.size], non_blocking=pair.pinned)
                b.active.copy_(src_a[b.lo:b.lo + b.size], non_blocking=pair.pinned)
            if pair.pinned:
                if pair.copied is None:
                    pair.copied = _Events(torch.cuda.Event() for _ in self._devices)
                for event, dev in zip(pair.copied, self._devices):
                    event.record(torch.cuda.current_stream(dev))

    def step_prepared(self, batch: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """The device half of a tick: copy a pair of the staging ring
        (`stage`) into the static inputs, run the step (a graph replay once
        captured) of every block, and return the full ``[P, n_classes]``
        logits as a new tensor, in slot order on the first block's device —
        callers map slots back to stream ids.  A pinned pair has been read
        once its ``copied`` events have completed (`next_pair` waits for
        them); raises ValueError for arrays that are not a pair of this
        pool's ring."""
        tr, track, timed = self.tracer, self.track, self._device_spans
        with tr.span("pool.step", track=track, pool_size=self.pool_size):
            timed.resolve()
            self._upload(batch, active)
            with tr.span("pool.replay", track=track, k1=self._k1, k1_wgmma=self._k1_wgmma):
                timed.mark(1)
                outs = []
                for b in self._blocks:
                    builds = b.step.builds
                    outs.append(b.step())
                    if b.step.builds != builds:
                        tr.instant("pool.build", track=track, capture_s=b.step.capture_s)
                        self._count_k1()
                timed.mark(2)
                timed.close(self._dev_args)
                if len(outs) == 1:
                    return outs[0]
                dev = self._blocks[0].device
                return torch.cat([o.to(dev) for o in outs])

    def step(self, frames: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        """One pool tick.  ``frames`` maps stream id -> ``[H, W, C]`` frame
        (a leading length-1 batch axis is accepted and squeezed); streams
        that skip this tick keep their ring frozen via the slot mask.
        Returns per-stream logits for exactly the streams that stepped."""
        logits = self.step_prepared(*self.stage(frames))
        return {sid: logits[self._slot_of[sid]] for sid in frames}

    def bind_tracer(self, tracer, track: Optional[str] = None) -> None:
        """Attach a tracer (the batcher wires its own through so pool.step
        spans land on the same lane as the tick spans).  An enabled
        wall-clock tracer on a CUDA pool also gets the pool's device spans
        (module docstring); the first binding to a tracer synchronises each
        device once, to anchor its clock."""
        tracer = tracer if tracer is not None else NULL_TRACER
        track = self.track if track is None else track
        if tracer is self.tracer and track == self.track:
            return  # rebound as it was (a fleet bucket's pool swapped back in)
        self._device_spans.resolve(wait=True)  # into the tracer they were recorded for
        self.tracer, self.track = tracer, track
        self._device_spans = NULL_DEVICE_SPANS
        if records_device_time(tracer, self.device):
            devices = self._devices
            lanes = ([f"{track}.device"] if len(devices) == 1
                     else [f"{track}.device{i}" for i in range(len(devices))])
            self._device_spans = DeviceSpans(tracer, devices, lanes,
                                             ("dev.upload", "dev.replay"), track=track)
        self._count_k1()

    def _count_k1(self) -> None:
        """K1 launches a replay holds (`CapturedStep.k1_per_replay`): in all,
        for ``pool.replay`` (with those on K1's wgmma route), and per device,
        for each ``dev.replay``."""
        per_device: Dict[torch.device, int] = {}
        for b in self._blocks:
            per_device[b.device] = per_device.get(b.device, 0) + b.step.k1_per_replay
        self._k1 = sum(per_device.values())
        self._k1_wgmma = sum(b.step.k1_wgmma_per_replay for b in self._blocks)
        self._dev_args = [{"dev.replay": {"k1": n}} for n in per_device.values()]

    # -- introspection -----------------------------------------------------

    def slot_of(self, stream_id: str) -> int:
        """The pool slot this stream occupies (KeyError if not admitted)."""
        return self._slot_of[self._require(stream_id)]

    def steps_seen(self, stream_id: str) -> int:
        """Frames this stream has absorbed since (re)admission.  Reading it
        waits for the device."""
        block, i = self._locate(self._slot_of[self._require(stream_id)])
        return int(block.state.steps[i])

    def window_warm(self, stream_id: str) -> bool:
        """True once this stream's full tcn_steps window is real frames."""
        return self.steps_seen(stream_id) >= self.deployed.graph.tcn_steps

    @property
    def active_streams(self) -> Tuple[str, ...]:
        return tuple(s for s in self._slots if s is not None)

    @property
    def free_slots(self) -> int:
        return self.pool_size - len(self._slot_of)

    @property
    def occupancy(self) -> float:
        """Live-stream fraction of the batch, 0..1."""
        return len(self._slot_of) / self.pool_size

    @property
    def trace_count(self) -> int:
        """How many times this pool built its step, summed over its blocks:
        captures of the CUDA graph on the card (``jit=True``), eager step
        builds on the CPU or with ``jit=False``.  0 before the first step,
        then one per block for the pool's whole life — the
        continuous-batching contract (admit / evict / partial ticks /
        migration never rebuild)."""
        return sum(b.step.builds for b in self._blocks)

    @property
    def captured(self) -> bool:
        """True once every block's step is a captured CUDA graph (``jit=True``
        on the card, after the first step)."""
        return all(b.step.captured for b in self._blocks)

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._slot_of

    def __len__(self) -> int:
        return len(self._slot_of)

    def __repr__(self) -> str:
        return (
            f"SessionPool(size={self.pool_size}, backend={self.backend!r}, "
            f"device={str(self.device)!r}, jit={self.jit}, sharding={self.sharding!r}, "
            f"active={len(self._slot_of)}, "
            f"occupancy={self.occupancy:.2f})"
        )
