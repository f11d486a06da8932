"""`SessionPool` — continuous batching of many sensor streams on one
fixed-shape step.  Counterpart of `repro.serving.pool`.

    pool = deployed.serve(pool_size=8, backend="fused")
    pool.admit("sensor-a"); pool.admit("sensor-b")
    out = pool.step({"sensor-a": frame_a, "sensor-b": frame_b})
    state = pool.evict("sensor-a")          # slot free, refill next tick
    pool.admit("sensor-c")                  # shapes unchanged

Key properties (tested in tests/test_torch_serving.py):

  * **Fixed shape, one step program.**  Every tick runs the same
    ``[P, H, W, C]`` batch through the same kernels; admit / evict /
    partial ticks are data (the ``active`` mask and the frame batch), never
    shapes.  The pool builds its step program once, at its first step, and
    reuses it for its whole life; `trace_count` counts those builds (the
    reference's jit trace count: 0 before the first step, 1 after, never
    more).  The step runs eagerly; capturing it as a CUDA graph is not
    done yet.
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

``sharding`` is accepted for the reference's signature and is a no-op on
one device (``None``, ``False``, ``True``, ``"auto"`` or ``1``); laying the
pool axis across several cards is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tcn import StreamState
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.masking import (
    PoolState,
    clear_slot,
    gather_slot,
    masked_push,
    ordered_windows,
    scatter_slot,
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
    cursors) on the program's device and one step: CNN frontend on the full
    ``[P, H, W, C]`` frame batch -> masked ring push -> TCN head on the
    ``[P, T, C]`` ordered windows.  Slot bookkeeping (which stream sits
    where) is plain host-side Python.
    """

    def __init__(self, deployed, pool_size: int, backend: str = "fused",
                 sharding=None, tracer=None):
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
        self.device = deployed.device
        g = deployed.graph
        self.frame_shape: Tuple[int, ...] = (*g.input_hw, g.input_ch)
        self.state = PoolState.create(
            pool_size, g.tcn_steps, g.feature_channels, device=self.device
        )
        self._slots: List[Optional[str]] = [None] * pool_size
        self._slot_of: Dict[str, int] = {}
        self._step = None
        self._trace_count = 0
        # observability: NULL_TRACER when tracing is off (no-op span, no
        # branch in the hot path); spans wrap the step from the outside
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.track = getattr(deployed.graph, "name", "pool")

    def _build_step(self):
        """The pool's one step program: CNN frontend -> masked ring push ->
        TCN head, bound to this pool's program and backend.  Built at the
        first step, counted in `trace_count`, never rebuilt."""
        self._trace_count += 1
        deployed, backend = self.deployed, self.backend

        def step(state: PoolState, frames: torch.Tensor, active: torch.Tensor):
            feats = deployed.spatial_forward(frames, backend)
            new = masked_push(state, feats, active)
            logits = deployed.temporal_forward(ordered_windows(new), backend)
            return logits, new

        return step

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
            self.state = clear_slot(self.state, slot)
        else:
            self.state = scatter_slot(self.state, slot, state)
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
        self.state = clear_slot(self.state, self._slot_of[self._require(stream_id)])

    def _require(self, stream_id: str) -> str:
        if stream_id not in self._slot_of:
            raise KeyError(
                f"unknown stream {stream_id!r}; active: {sorted(self._slot_of)}"
            )
        return stream_id

    # -- the hot path ------------------------------------------------------

    def prepare(self, frames: Mapping[str, object]) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side batch assembly: slot-scatter ``frames`` (numpy arrays
        or tensors) into a ``[P, *frame_shape]`` float32 batch and a ``[P]``
        bool active mask.  Pure numpy, no device work."""
        for sid in frames:
            self._require(sid)
        batch = np.zeros((self.pool_size, *self.frame_shape), np.float32)
        active = np.zeros((self.pool_size,), bool)
        for sid, f in frames.items():
            f = host_frame(f)
            if f.shape == (1, *self.frame_shape):
                f = f[0]
            if f.shape != self.frame_shape:
                raise ValueError(
                    f"stream {sid!r}: frame shape {f.shape} != {self.frame_shape}"
                )
            batch[self._slot_of[sid]] = f
            active[self._slot_of[sid]] = True
        return batch, active

    def step_prepared(self, batch: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """The device half of a tick: copy an assembled ``(batch, active)``
        pair (see `prepare`) to the pool's device, run the step, and return
        the full ``[P, n_classes]`` logits there — callers map slots back
        to stream ids.  The copies from the host buffers are synchronous
        (pageable memory, ``non_blocking=False``): when this returns the
        buffers have been read, so a feeder may refill them at once."""
        if self._step is None:
            self._step = self._build_step()
        with self.tracer.span("pool.step", track=self.track,
                              pool_size=self.pool_size):
            logits, self.state = self._step(
                self.state,
                torch.from_numpy(batch).to(self.device),
                torch.from_numpy(active).to(self.device),
            )
        return logits

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
        """How many times this pool built its step program: 0 before the
        first step, then 1 for the pool's whole life — the continuous-
        batching contract (admit / evict / partial ticks never rebuild)."""
        return self._trace_count

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._slot_of

    def __len__(self) -> int:
        return len(self._slot_of)

    def __repr__(self) -> str:
        return (
            f"SessionPool(size={self.pool_size}, backend={self.backend!r}, "
            f"device={str(self.device)!r}, active={len(self._slot_of)}, "
            f"occupancy={self.occupancy:.2f})"
        )
