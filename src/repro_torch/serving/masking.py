"""Slot-masked TCN ring state — the pure algebra under `SessionPool`.
Counterpart of `repro.serving.masking`.

A **fixed-shape** batched ring state ``[P, T, C]`` where P is the pool size.
Streams come and go mid-flight, so every slot carries its own write cursor
and its own monotonic step counter.  Everything here is functional (a new
`PoolState` is returned, the old one is untouched), shape-stable, and stays
on the state's device: admission, eviction and masking are data (the
``active`` mask), never shapes, and nothing waits for the device.

Slot surgery (`gather_slot` / `scatter_slot` / `clear_slot`) converts
between the pooled state and the single-stream `StreamState` that
`StreamSession` exposes, which is what makes sessions migratable.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tcn import StreamState, TCNStream


@dataclasses.dataclass
class PoolState:
    """Ring memory for P independent streams: per-slot cursor and age.

    buf    : [P, T, C]  ring contents (slot-major, time, feature channels)
    cursor : [P] int64  next write position per slot (wraps mod T)
    steps  : [P] int64  frames absorbed per slot since (re)admission
    """

    buf: torch.Tensor
    cursor: torch.Tensor
    steps: torch.Tensor

    @staticmethod
    def create(pool_size: int, n_steps: int, channels: int,
               dtype=torch.float32, device="cuda") -> "PoolState":
        """All-empty pool: zero rings, every cursor at 0, no frames seen."""
        return PoolState(
            buf=torch.zeros((pool_size, n_steps, channels), dtype=dtype, device=device),
            cursor=torch.zeros((pool_size,), dtype=torch.int64, device=device),
            steps=torch.zeros((pool_size,), dtype=torch.int64, device=device),
        )

    @property
    def pool_size(self) -> int:
        return self.buf.shape[0]

    @property
    def n_steps(self) -> int:
        return self.buf.shape[1]


def masked_push(state: PoolState, feats: torch.Tensor, active: torch.Tensor) -> PoolState:
    """Write ``feats[p]`` at ``cursor[p]`` for every active slot; freeze the
    rest.  feats: [P, C]; active: [P] bool.  Inactive slots keep buf, cursor
    and steps unchanged — the compute for their lane still runs (the pool
    batch is always full) but their state is masked."""
    p, _, c = state.buf.shape
    index = state.cursor.view(p, 1, 1).expand(p, 1, c)
    pushed = state.buf.scatter(1, index, feats.to(state.buf.dtype).unsqueeze(1))
    return PoolState(
        buf=torch.where(active.view(p, 1, 1), pushed, state.buf),
        cursor=torch.where(active, (state.cursor + 1) % state.n_steps, state.cursor),
        steps=torch.where(active, state.steps + 1, state.steps),
    )


def ordered_windows(state: PoolState) -> torch.Tensor:
    """[P, T, C] time-ordered (oldest-first) view per slot — what the TCN
    head consumes.  The per-slot roll by the per-slot cursor is a gather
    with ``(arange(T) + cursor[:, None]) % T``; identical values to
    `TCNStream.ordered()` for each stream in isolation."""
    p, t, c = state.buf.shape
    idx = (torch.arange(t, device=state.buf.device)[None, :] + state.cursor[:, None]) % t
    return state.buf.gather(1, idx[:, :, None].expand(p, t, c))


# ---------------------------------------------------------------------------
# Slot surgery — pooled state <-> single-stream state
# ---------------------------------------------------------------------------


def gather_slot(state: PoolState, slot: int) -> StreamState:
    """Extract slot ``slot`` as a standalone (batch-free) StreamState — a
    copy, so later pool steps never show through it."""
    return StreamState(
        ring=TCNStream(buf=state.buf[slot].clone(), cursor=state.cursor[slot].clone()),
        steps_seen=state.steps[slot].clone(),
    )


def _with_slot(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = t.clone()
    out[slot] = value
    return out


def scatter_slot(state: PoolState, slot: int, stream: StreamState) -> PoolState:
    """Place a StreamState into slot ``slot`` (batch-free states only)."""
    if stream.ring.buf.ndim != 2:
        raise ValueError(
            "only batch-free StreamStates scatter into a pool slot; got ring "
            f"buf shape {tuple(stream.ring.buf.shape)}"
        )
    if stream.ring.buf.shape != state.buf.shape[1:]:
        raise ValueError(
            f"ring shape {tuple(stream.ring.buf.shape)} does not fit pool slots "
            f"{tuple(state.buf.shape[1:])}"
        )
    dev = state.buf.device
    return PoolState(
        buf=_with_slot(state.buf, slot, stream.ring.buf.to(dev, state.buf.dtype)),
        cursor=_with_slot(state.cursor, slot, stream.ring.cursor.to(dev, torch.int64)),
        steps=_with_slot(state.steps, slot, stream.steps_seen.to(dev, torch.int64)),
    )


def clear_slot(state: PoolState, slot: int) -> PoolState:
    """Zero a slot's ring and counters — per-slot `reset`."""
    return PoolState(
        buf=_with_slot(state.buf, slot, 0),
        cursor=_with_slot(state.cursor, slot, 0),
        steps=_with_slot(state.steps, slot, 0),
    )
