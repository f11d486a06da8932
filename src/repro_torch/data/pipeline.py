"""Deterministic synthetic data pipelines with checkpointable cursors.
Counterpart of `repro.data.pipeline`:

  * LMTokenPipeline        — zipf-distributed token ids (+ shifted targets)
                             for the LM scaffold (`launch/train_lm.py`)
  * CifarLikePipeline      — ternarized images + labels (``cifar10_tnn``)
  * DVSEventPipeline       — sparse event frames [T, H, W, 2] (``dvs_cnn_tcn``)
  * KWSSpectrogramPipeline — ternary spectrogram clips [T, H, W, 1]
                             (``kws_tcn``)

Each pipeline is a pure function of (seed, step) in numpy, so it yields
byte-identical batches to the reference for the same seed, and a restore
resumes the exact stream.  Batches are numpy arrays: the caller moves them
to its device.  The temporal pipelines take a ``duty_cycle``: the fraction
of frames carrying events; the rest are all-zero frames the activity gate
parks on.
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


class LMTokenPipeline:
    """Synthetic LM stream.  Batch = {tokens [B,S], targets [B,S]} int32
    (+ ``frontend_embeds`` [B,P,D] / ``enc_embeds`` [B,S_enc,D] float32 for
    stub-fronted and encoder-decoder configs), drawn in the reference's
    order so the batches are its own bit for bit."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, *, seed: int = 0,
                 frontend_seq: int = 0, d_model: int = 0, enc_seq: int = 0):
        self.vocab, self.seq, self.batch = vocab_size, seq_len, batch
        self.frontend_seq, self.d_model, self.enc_seq = frontend_seq, d_model, enc_seq
        self.state = PipelineState(seed=seed, step=0)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.state.seed << 20) ^ step)
        # zipf-ish marginal: realistic softmax-loss magnitudes
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.frontend_seq:
            out["frontend_embeds"] = rng.standard_normal(
                (self.batch, self.frontend_seq, self.d_model), np.float32)
        if self.enc_seq:
            out["enc_embeds"] = rng.standard_normal(
                (self.batch, self.enc_seq, self.d_model), np.float32)
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


class CifarLikePipeline:
    """Ternarized CIFAR-like images: x in {-1,0,1}^[B,32,32,3], 10 classes.

    Labels are derivable from the data (class-conditional means)."""

    def __init__(self, batch: int, *, seed: int = 0, n_classes: int = 10, hw: int = 32,
                 ch: int = 3, noise: float = 1.0):
        self.batch, self.n_classes, self.hw, self.ch = batch, n_classes, hw, ch
        self.noise = noise
        self.state = PipelineState(seed=seed, step=0)
        rng = np.random.default_rng(seed)
        # fixed class prototypes
        self.protos = rng.standard_normal((n_classes, hw, hw, ch)).astype(np.float32)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.state.seed << 20) ^ (step + 1))
        labels = rng.integers(0, self.n_classes, size=self.batch)
        noise = rng.standard_normal((self.batch, self.hw, self.hw, self.ch)).astype(np.float32)
        x = self.protos[labels] + self.noise * noise
        x_ternary = np.sign(x) * (np.abs(x) > 0.5)
        return x_ternary.astype(np.float32), labels.astype(np.int32)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


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


class KWSSpectrogramPipeline:
    """Keyword-spotting-like spectrogram clips: [B, T, H, W, 1] ternary
    "mel patch" frames for the single-channel ``kws_tcn`` nets.

    Each class has a fixed sparse spectral prototype; a clip's frames roll
    it along the frequency axis over time with per-frame event noise.
    ``duty_cycle`` < 1 leaves the complementary frames silent (all-zero).
    """

    def __init__(self, batch: int, *, steps: int = 4, hw: int = 32,
                 n_classes: int = 12, seed: int = 0, duty_cycle: float = 1.0):
        if not 0.0 <= duty_cycle <= 1.0:
            raise ValueError(f"duty_cycle {duty_cycle} outside [0, 1]")
        self.batch, self.steps, self.hw, self.n_classes = batch, steps, hw, n_classes
        self.duty_cycle = duty_cycle
        self.state = PipelineState(seed=seed, step=0)
        rng = np.random.default_rng(seed)
        keep = rng.random((n_classes, hw, hw, 1)) < 0.15
        self.protos = (np.sign(rng.standard_normal((n_classes, hw, hw, 1)))
                       * keep).astype(np.float32)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.state.seed << 20) ^ (step + 13))
        b, t, hw = self.batch, self.steps, self.hw
        labels = rng.integers(0, self.n_classes, size=b)
        frames = np.zeros((b, t, hw, hw, 1), np.float32)
        active = rng.random((b, t)) < self.duty_cycle
        for i in range(b):
            for ti in range(t):
                if not active[i, ti]:
                    continue  # silence: zero bins, below any gate threshold
                x = np.roll(self.protos[labels[i]], ti, axis=0)
                flip = rng.random((hw, hw, 1)) < 0.02
                x = np.where(flip, np.sign(rng.standard_normal((hw, hw, 1))), x)
                frames[i, ti] = x
        return frames, labels.astype(np.int32)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


def pipeline_for_net(graph, batch: int, *, seed: int = 0, noise: float = 0.5,
                     duty_cycle: float = 1.0):
    """The data source matching a `repro_torch.api.CutieGraph`: event clips
    for temporal graphs — 2-channel graphs get DVS event streams, 1-channel
    graphs get KWS spectrogram clips, ``passes_per_inference`` frames each —
    and ternarized images for spatial ones, sized to the graph's input
    geometry and class count."""
    if graph.is_temporal:
        if graph.input_ch == 2:
            return DVSEventPipeline(
                batch, steps=graph.passes_per_inference, hw=graph.input_hw[0],
                n_classes=graph.n_classes, seed=seed, duty_cycle=duty_cycle,
            )
        if graph.input_ch == 1:
            return KWSSpectrogramPipeline(
                batch, steps=graph.passes_per_inference, hw=graph.input_hw[0],
                n_classes=graph.n_classes, seed=seed, duty_cycle=duty_cycle,
            )
        raise ValueError(
            f"{graph.name}: temporal pipelines emit 2 (DVS) or 1 (KWS) "
            f"channels, graph wants {graph.input_ch}"
        )
    return CifarLikePipeline(
        batch, seed=seed, n_classes=graph.n_classes, hw=graph.input_hw[0],
        ch=graph.input_ch, noise=noise,
    )


def pipeline_for(cfg, shape, *, seed: int = 0) -> LMTokenPipeline:
    """The LM pipeline matching an (arch, shape) cell: a
    `repro_torch.models.ModelConfig` and a `ShapeConfig`."""
    return LMTokenPipeline(
        cfg.vocab_size, shape.seq_len, shape.global_batch, seed=seed,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model,
        enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0,
    )
