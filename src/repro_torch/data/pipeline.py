"""Deterministic synthetic data pipelines with checkpointable cursors.
Counterpart of `repro.data.pipeline`; this part of the port holds the DVS
event pipeline only.

The pipeline is a pure function of (seed, step) in numpy, so it yields
byte-identical frames and labels to the reference for the same seed, and a
restore resumes the exact stream.  Batches are numpy arrays: the caller
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "PipelineState":
        return PipelineState(seed=int(d["seed"]), step=int(d["step"]))


class DVSEventPipeline:
    """Gesture-like event streams: [B, T, H, W, 2] sparse 0/1 frames.

    Each class is a blob moving along a class-specific direction; polarity
    channels encode on/off events — the unstructured-sparsity regime (~2-6%
    events/frame) of the paper's DVS128 workload.

    ``duty_cycle`` < 1 leaves the complementary fraction of frames all-zero
    (sensor sees nothing).  The active/quiet mask is drawn only when
    duty_cycle < 1, so the default stream is unchanged by the knob.
    """

    def __init__(self, batch: int, *, steps: int = 5, hw: int = 64,
                 n_classes: int = 12, seed: int = 0, duty_cycle: float = 1.0):
        if not 0.0 <= duty_cycle <= 1.0:
            raise ValueError(f"duty_cycle {duty_cycle} outside [0, 1]")
        self.batch, self.steps, self.hw, self.n_classes = batch, steps, hw, n_classes
        self.duty_cycle = duty_cycle
        self.state = PipelineState(seed=seed, step=0)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.state.seed << 20) ^ (step + 7))
        b, t, hw = self.batch, self.steps, self.hw
        labels = rng.integers(0, self.n_classes, size=b)
        frames = np.zeros((b, t, hw, hw, 2), np.float32)
        ang = 2 * np.pi * labels / self.n_classes
        cx = hw // 2 + (rng.integers(-8, 8, size=b))
        cy = hw // 2 + (rng.integers(-8, 8, size=b))
        active = (np.ones((b, t), bool) if self.duty_cycle >= 1.0
                  else rng.random((b, t)) < self.duty_cycle)
        yy, xx = np.mgrid[0:hw, 0:hw]
        for i in range(b):
            for ti in range(t):
                if not active[i, ti]:
                    continue  # quiet frame: zero events
                px = cx[i] + np.cos(ang[i]) * ti * 4
                py = cy[i] + np.sin(ang[i]) * ti * 4
                d2 = (xx - px) ** 2 + (yy - py) ** 2
                blob = d2 < 25
                on = blob & (rng.random((hw, hw)) < 0.5)
                off = blob & ~on
                bg = rng.random((hw, hw)) < 0.01  # noise events
                frames[i, ti, :, :, 0] = (on | bg).astype(np.float32)
                frames[i, ti, :, :, 1] = off.astype(np.float32)
        return frames, labels.astype(np.int32)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b
