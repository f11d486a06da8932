"""The general traffic generator: what every mix file's parameters become.

A mix (``traffic/<mix>.json``) gives the loop kind, the pool, the gate, the
clip lengths, the arrivals and the sensor's activity.  From the seed this
module draws:

* clip lengths, arrival gaps and on/off activity runs as *quantile grids*
  of their distributions, permuted by the seed: every seed gets the same
  multiset of sizes and gaps in another order, so a seed changes the order
  of the work and not its amount;
* a bank of frame sequences (``sources/<frames>.py`` draws their content on
  the device; silent frames are all zero), which clips are views into:
  clip i plays ``length`` frames of sequence ``seq`` from ``off`` on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: Dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` clip lengths from ``{"dist": "uniform"|"loguniform", "min", "max"}``
    (whole frames, both ends included), a quantile grid in seeded order."""
    lo, hi, q = int(spec["min"]), int(spec["max"]), _grid(n)
    if spec["dist"] == "uniform":
        out = lo + np.floor(q * (hi - lo + 1))
    elif spec["dist"] == "loguniform":
        out = np.floor(np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo))))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return gen.permutation(np.clip(out, lo, hi).astype(np.int64))


def gaps(rate_per_s: float, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` exponential inter-arrival gaps (seconds) of a Poisson stream at
    ``rate_per_s``, a quantile grid in seeded order."""
    return gen.permutation(-np.log1p(-_grid(n)) / float(rate_per_s))


def _runs(mean: float, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` whole-frame run lengths, geometric-like with mean ``mean``."""
    return gen.permutation(np.maximum(1, np.rint(-np.log1p(-_grid(n)) * mean)).astype(np.int64))


def activity_mask(spec: Dict, n_seqs: int, seq_len: int,
                  gen: np.random.Generator) -> np.ndarray:
    """[n_seqs, seq_len] bool: which frames carry events.  ``{"duty": 1.0}``
    is always on; otherwise on-runs of mean ``mean_on_run`` alternate with
    off-runs of mean ``mean_on_run * (1 - duty) / duty`` (speech in bursts)."""
    duty = float(spec["duty"])
    if duty >= 1.0:
        return np.ones((n_seqs, seq_len), bool)
    on_mean = float(spec["mean_on_run"])
    off_mean = on_mean * (1.0 - duty) / duty
    total = n_seqs * seq_len
    n = int(total / (on_mean + off_mean) * 1.25) + 8
    on, off = _runs(on_mean, n, gen), _runs(off_mean, n, gen)
    flat = np.zeros(total, bool)
    pos = int(gen.integers(0, int(off[0]) + 1))  # the first run's phase
    for a, b in zip(on, off[1:]):
        if pos >= total:
            break
        flat[pos:pos + a] = True
        pos += int(a + b)
    return flat.reshape(n_seqs, seq_len)


@dataclasses.dataclass
class Clip:
    """One stream request: ``length`` frames of bank sequence ``seq`` from
    ``off``; ``due`` seconds after the window opens (open loops) or the
    ``client`` that submits it (closed loops)."""

    idx: int
    length: int
    seq: int
    off: int
    due: float = 0.0
    client: int = -1
    prefix: str = "k"

    @property
    def stream_id(self) -> str:
        return f"{self.prefix}{self.idx}"


class Bank:
    """Host frames ``[n_seqs, seq_len, H, W, C]`` float32 that clips view."""

    def __init__(self, frames: np.ndarray, content: np.ndarray):
        self.frames = frames     # with silence
        self.content = content   # the same sequences, every frame on
        self.n_seqs, self.seq_len = frames.shape[:2]

    def clip(self, c: Clip) -> np.ndarray:
        return self.frames[c.seq, c.off:c.off + c.length]


def make_bank(source, cfg: Dict, mix: Dict, seed: int, device) -> Bank:
    """The mix's bank: ``mix["bank"]`` sequences as long as its longest clip,
    content from ``source.make_bank`` on ``device``, silence from the mix's
    activity (all zero frames)."""
    import torch

    n_seqs, seq_len = int(mix["bank"]), int(mix["length"]["max"])
    gen = torch.Generator(device=device).manual_seed(derive(seed, "frames"))
    content = source.make_bank(cfg, n_seqs, seq_len, gen, torch.device(device))
    mask = activity_mask(mix["activity"], n_seqs, seq_len, rng(seed, "activity"))
    content = content.cpu().numpy()
    frames = content if mask.all() else content * mask[:, :, None, None, None]
    return Bank(np.ascontiguousarray(frames, np.float32), content)


def calibration(bank: Bank, cfg: Dict) -> np.ndarray:
    """The calibration frames, every one on: for a net with a ring memory the
    first ``calib_clips`` sequences' first ``tcn_steps`` frames ``[clips,
    steps, H, W, C]``; for a net without one the bank's first ``calib_frames``
    frames ``[N, H, W, C]``."""
    if "tcn_steps" in cfg:
        return bank.content[:int(cfg["calib_clips"]), :cfg["tcn_steps"]].copy()
    return bank.content.reshape(-1, *bank.content.shape[2:])[:int(cfg["calib_frames"])].copy()


def clips(mix: Dict, n: int, bank: Bank, seed: int, tag: str, *, start: int = 0,
          dues: Optional[np.ndarray] = None, prefix: str = "k") -> List[Clip]:
    """``n`` clips of the mix, numbered from ``start``: lengths from its grid,
    each a seeded window of a seeded bank sequence; ``dues`` (seconds) for
    open loops."""
    gen = rng(seed, tag)
    lens = lengths(mix["length"], n, gen)
    seqs = gen.integers(0, bank.n_seqs, n)
    offs = (gen.random(n) * (bank.seq_len - lens + 1)).astype(np.int64)
    return [Clip(idx=start + i, length=int(lens[i]), seq=int(seqs[i]), off=int(offs[i]),
                 due=0.0 if dues is None else float(dues[i]), prefix=prefix)
            for i in range(n)]
