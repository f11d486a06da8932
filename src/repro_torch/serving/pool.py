"""`SessionPool` — continuous batching of many sensor streams on one
fixed-shape step.  Counterpart of `repro.serving.pool`.

    pool = deployed.serve(pool_size=8, backend="fused")
    pool.admit("sensor-a"); pool.admit("sensor-b")
    out = pool.step({"sensor-a": frame_a, "sensor-b": frame_b})
    state = pool.evict("sensor-a")          # slot free, refill next tick
    pool.admit("sensor-c")                  # shapes unchanged

Key properties (tested in tests/test_torch_serving.py):

  * **Fixed shape.**  Every tick runs the same ``[P, H, W, C]`` batch
    through the same kernels; admit / evict / partial ticks are data (the
    ``active`` mask and the frame batch), never shapes.  The step runs
    eagerly; capturing it once as a CUDA graph is later work.
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
``input_hw`` / ``input_ch`` / ``tcn_steps`` / ``feature_channels``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tcn import StreamState
from repro_torch.serving.masking import (
    PoolState,
    clear_slot,
    gather_slot,
    masked_push,
    ordered_windows,
    scatter_slot,
)


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

    def __init__(self, deployed, pool_size: int, backend: str = "fused"):
        from repro_torch.api.program import check_backend

        check_backend(backend)
        if not deployed.graph.is_temporal:
            raise ValueError(f"{deployed.graph.name} has no TCN memory to pool")
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
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

    def _step(self, state: PoolState, frames: torch.Tensor, active: torch.Tensor):
        feats = self.deployed.spatial_forward(frames, self.backend)
        new = masked_push(state, feats, active)
        logits = self.deployed.temporal_forward(ordered_windows(new), self.backend)
        return logits, new

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
            if isinstance(f, torch.Tensor):
                f = f.detach().cpu().numpy()
            f = np.asarray(f, np.float32)
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
        to stream ids."""
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
