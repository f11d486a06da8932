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

Frames reach the card from host memory: a batch in pinned memory (the
fleet feeder's double buffers) is copied without blocking and an event
marks when the copy is done (`last_upload`); any other batch is copied
synchronously.  `step_prepared` returns a new logits tensor every tick.

``sharding`` is accepted for the reference's signature and is a no-op on
one device (``None``, ``False``, ``True``, ``"auto"`` or ``1``); laying the
pool axis across several cards is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.capture import CapturedStep
from repro_torch.core.tcn import StreamState
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


class PoolFullError(RuntimeError):
    """Raised by `admit` when every slot is occupied (callers queue — see
    `repro_torch.serving.scheduler.ContinuousBatcher`)."""


class SessionPool:
    """Fixed-shape multi-stream serving state over one `DeployedProgram`.

    The pool owns a slot-masked `PoolState` (``[P, T, C]`` ring + per-slot
    cursors), a ``[P, H, W, C]`` frame batch and a ``[P]`` active mask on
    the program's device, and one step: CNN frontend on the frame batch ->
    masked ring push -> TCN head on the ``[P, T, C]`` ordered windows.
    Slot bookkeeping (which stream sits where) is plain host-side Python.
    """

    def __init__(self, deployed, pool_size: int, backend: str = "fused",
                 jit: bool = True, sharding=None, tracer=None):
        from repro_torch.api.program import check_backend

        check_backend(backend)
        if not deployed.graph.is_temporal:
            raise ValueError(f"{deployed.graph.name} has no TCN memory to pool")
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        if not (sharding is None or sharding is False or sharding is True
                or sharding == "auto" or sharding == 1):
            raise ValueError(
                f"sharding={sharding!r}: the port's pool runs on one device; "
                "laying the pool axis across devices is not ported"
            )
        self.sharding = None  # one device: the reference's "auto" resolves to None
        self.deployed = deployed
        self.pool_size = pool_size
        self.backend = backend
        self.jit = jit
        self.device = deployed.device
        g = deployed.graph
        self.frame_shape: Tuple[int, ...] = (*g.input_hw, g.input_ch)
        # the static tensors the step reads and writes in place
        self.state = PoolState.create(
            pool_size, g.tcn_steps, g.feature_channels, device=self.device
        )
        self._frames = torch.zeros((pool_size, *self.frame_shape),
                                   dtype=torch.float32, device=self.device)
        self._active = torch.zeros((pool_size,), dtype=torch.bool, device=self.device)
        self._step = CapturedStep(self._run_step, self.device, capture=jit)
        # the event after the last non-blocking upload (None: it was synchronous)
        self.last_upload: Optional[torch.cuda.Event] = None
        self._slots: List[Optional[str]] = [None] * pool_size
        self._slot_of: Dict[str, int] = {}
        # observability: NULL_TRACER when tracing is off (no-op span, no
        # branch in the hot path); spans wrap the step from the outside
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.track = getattr(deployed.graph, "name", "pool")

    def _run_step(self) -> torch.Tensor:
        """The pool's one step over its static tensors: CNN frontend ->
        masked ring push (in place) -> TCN head.  Returns the logits."""
        feats = self.deployed.spatial_forward(self._frames, self.backend)
        masked_push_(self.state, feats, self._active)
        return self.deployed.temporal_forward(ordered_windows(self.state), self.backend)

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
        if state is None:
            clear_slot_(self.state, slot)
        else:
            scatter_slot_(self.state, slot, state)
        self._slots[slot] = stream_id
        self._slot_of[stream_id] = slot
        return slot

    def evict(self, stream_id: str) -> StreamState:
        """Release the stream's slot and hand back its `StreamState` (resume
        later via ``admit(sid, state=...)`` or ``StreamSession.load_state``).
        The slot is refillable immediately."""
        slot = self._slot_of.pop(self._require(stream_id))
        self._slots[slot] = None
        return gather_slot(self.state, slot)

    def reset(self, stream_id: str) -> None:
        """Per-slot reset: zero this stream's ring and age, leaving every
        other slot untouched."""
        clear_slot_(self.state, self._slot_of[self._require(stream_id)])

    def _require(self, stream_id: str) -> str:
        if stream_id not in self._slot_of:
            raise KeyError(
                f"unknown stream {stream_id!r}; active: {sorted(self._slot_of)}"
            )
        return stream_id

    # -- the hot path ------------------------------------------------------

    def prepare(
        self,
        frames: Mapping[str, object],
        out_batch: Optional[np.ndarray] = None,
        out_active: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side batch assembly: slot-scatter ``frames`` (numpy arrays
        or tensors) into a ``[P, *frame_shape]`` float32 batch and a ``[P]``
        bool active mask.  Pure numpy, no device work.  ``out_batch`` /
        ``out_active`` reuse caller-owned buffers (the feeder's pinned
        double buffers) instead of allocating."""
        for sid in frames:
            self._require(sid)
        if out_batch is None:
            out_batch = np.zeros((self.pool_size, *self.frame_shape), np.float32)
        else:
            out_batch.fill(0.0)
        if out_active is None:
            out_active = np.zeros((self.pool_size,), bool)
        else:
            out_active.fill(False)
        for sid, f in frames.items():
            f = host_frame(f)
            if f.shape == (1, *self.frame_shape):
                f = f[0]
            if f.shape != self.frame_shape:
                raise ValueError(
                    f"stream {sid!r}: frame shape {f.shape} != {self.frame_shape}"
                )
            out_batch[self._slot_of[sid]] = f
            out_active[self._slot_of[sid]] = True
        return out_batch, out_active

    def _upload(self, batch, active) -> None:
        """Copy a host ``(batch, active)`` pair into the static device
        inputs: without blocking from pinned memory (recording
        `last_upload`), synchronously otherwise."""
        src_b, src_a = torch.as_tensor(batch), torch.as_tensor(active)
        if tuple(src_b.shape) != tuple(self._frames.shape) or tuple(src_a.shape) != (
                self.pool_size,):
            raise ValueError(
                f"batch {tuple(src_b.shape)} / active {tuple(src_a.shape)} do not "
                f"fit the pool's {tuple(self._frames.shape)} / ({self.pool_size},)"
            )
        pinned = (self.device.type == "cuda" and src_b.is_pinned()
                  and src_a.is_pinned())
        self._frames.copy_(src_b, non_blocking=pinned)
        self._active.copy_(src_a, non_blocking=pinned)
        self.last_upload = None
        if pinned:
            self.last_upload = torch.cuda.Event()
            self.last_upload.record()

    def step_prepared(self, batch: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """The device half of a tick: copy an assembled ``(batch, active)``
        pair (see `prepare`) into the static inputs, run the step (a graph
        replay once captured), and return the full ``[P, n_classes]``
        logits on the device as a new tensor — callers map slots back to
        stream ids.  A pageable host buffer has been read when this
        returns; a pinned one once `last_upload` has completed."""
        with self.tracer.span("pool.step", track=self.track,
                              pool_size=self.pool_size):
            self._upload(batch, active)
            return self._step()

    def step(self, frames: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        """One pool tick.  ``frames`` maps stream id -> ``[H, W, C]`` frame
        (a leading length-1 batch axis is accepted and squeezed); streams
        that skip this tick keep their ring frozen via the slot mask.
        Returns per-stream logits for exactly the streams that stepped."""
        logits = self.step_prepared(*self.prepare(frames))
        return {sid: logits[self._slot_of[sid]] for sid in frames}

    def bind_tracer(self, tracer, track: Optional[str] = None) -> None:
        """Attach a tracer (the batcher wires its own through so pool.step
        spans land on the same lane as the tick spans)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if track is not None:
            self.track = track

    # -- introspection -----------------------------------------------------

    def slot_of(self, stream_id: str) -> int:
        """The pool slot this stream occupies (KeyError if not admitted)."""
        return self._slot_of[self._require(stream_id)]

    def steps_seen(self, stream_id: str) -> int:
        """Frames this stream has absorbed since (re)admission.  Reading it
        waits for the device."""
        return int(self.state.steps[self._slot_of[self._require(stream_id)]])

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
        """How many times this pool built its step: captures of the CUDA
        graph on the card (``jit=True``), eager step builds on the CPU or
        with ``jit=False``.  0 before the first step, then 1 for the pool's
        whole life — the continuous-batching contract (admit / evict /
        partial ticks / migration never rebuild)."""
        return self._step.builds

    @property
    def captured(self) -> bool:
        """True once the step is a captured CUDA graph (``jit=True`` on the
        card, after the first step)."""
        return self._step.captured

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._slot_of

    def __len__(self) -> int:
        return len(self._slot_of)

    def __repr__(self) -> str:
        return (
            f"SessionPool(size={self.pool_size}, backend={self.backend!r}, "
            f"device={str(self.device)!r}, jit={self.jit}, active={len(self._slot_of)}, "
            f"occupancy={self.occupancy:.2f})"
        )
