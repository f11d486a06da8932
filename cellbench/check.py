"""The comparison that decides ``correct``.

After the window (and its drain) every clip that was due in it must have its
answer: the logits of its last stepped frame, on the host.  The window
counted, from the keys of each tick's output, the frames every clip
stepped, and kept the logits of two frames of one clip in four (`bench.Probes`):
one within its first ``tcn_steps`` frames, so that the ring's window holds
zero history there and a slot admitted with an old stream's ring shows, and
one anywhere in the clip.  A sample of the answered clips, drawn from the
seed among the probed ones and holding the longest clip, is served again by
the plain reference (`reference.cutie`) from the benchmark's own weights,
calibration frames and clip frames: the reference derives the deploy tables
anew, replays the gate's plan where the cell has a gate, runs the frames of
each compared step's window (the newest ``tcn_steps`` stepped frames up to
it, zero history before) through the frontend and the TCN head, in blocks.

Numbers compared, each against the configuration's limit:

* ``logit_gap`` — the widest gap between the program's logits and the
  reference's, as a share of the reference's largest logit magnitude, over
  the sample's last frames and probed frames;
* ``frames_mismatch`` — clips, of every answered one, whose count of stepped
  frames differs from the reference's (every frame without a gate, the
  gate's plan with one), or whose having logits at all does;
* ``missing`` — clips due in the window whose answer never came.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cellbench import traffic
from cellbench.reference import cutie

SAMPLE = 256
BLOCK = 256  # frames (or windows) per reference call


@dataclasses.dataclass
class Answer:
    """What the program answered for one clip."""

    frames: np.ndarray                 # the clip's host frames [T, H, W, C]
    logits: Optional[np.ndarray]       # None: no frame reached the device
    steps: int                         # frames it stepped, counted by the harness
    probes: List[Tuple[int, np.ndarray]] = dataclasses.field(default_factory=list)


def sample(lengths: Sequence[int], probed: Sequence[bool], seed: int,
           k: int = SAMPLE) -> List[int]:
    """Indices of up to ``k`` answers, drawn from the seed among the probed
    ones (then the others), the longest clip always among them."""
    n = len(lengths)
    if n <= k:
        return list(range(n))
    gen = traffic.rng(seed, "sample")
    picked = {int(np.argmax(lengths))}
    for pool in ([i for i in range(n) if probed[i]], [i for i in range(n) if not probed[i]]):
        pool = [i for i in pool if i not in picked]
        take = min(k - len(picked), len(pool))
        if take > 0:
            picked.update(int(i) for i in gen.choice(pool, size=take, replace=False))
    return sorted(picked)


def stepped(frames: np.ndarray, gate: Optional[Dict]) -> List[int]:
    """Indices of the clip's frames that reach the device."""
    if not gate:
        return list(range(len(frames)))
    events = np.count_nonzero(frames.reshape(len(frames), -1), axis=1)
    plan = cutie.gate_plan(events.tolist(), gate["wake_threshold"],
                           gate["park_threshold"], gate["park_after"])
    return [i for i, p in enumerate(plan) if p]


def reference_logits(cfg: Dict, tables: Dict, clips: Sequence[np.ndarray],
                     device, precision: str = "fp32") -> List[Optional[np.ndarray]]:
    """Per window (the stepped frames up to a step, at most ``tcn_steps``),
    the reference's logits after its last frame; None for an empty one."""
    import torch

    steps = cfg["tcn_steps"]
    c = [layer for layer in cfg["layers"] if layer["kind"] == "conv2d"][-1]["c_out"]
    frames = [f[-steps:] for f in clips]
    flat = [fr for f in frames for fr in f]
    feats = []
    for i in range(0, len(flat), BLOCK):
        x = torch.from_numpy(np.stack(flat[i:i + BLOCK])).to(device)
        feats.append(cutie.spatial(cfg, tables, x, precision))
    feats = torch.cat(feats) if feats else torch.zeros((0, c), device=device)
    windows, owners, pos = [], [], 0
    for j, f in enumerate(frames):
        n = len(f)
        if n:
            w = torch.zeros((steps, feats.shape[1]), device=device)
            w[steps - n:] = feats[pos:pos + n]
            windows.append(w)
            owners.append(j)
        pos += n
    out: List[Optional[np.ndarray]] = [None] * len(clips)
    for i in range(0, len(windows), BLOCK):
        logits = cutie.temporal(cfg, tables, torch.stack(windows[i:i + BLOCK]), precision)
        for j, row in zip(owners[i:i + BLOCK], logits.cpu().numpy()):
            out[j] = row
    return out


def logit_gap(got: Optional[np.ndarray], want: Optional[np.ndarray]) -> float:
    """``max|got - want| / max|want|`` (0 where either is absent: that is
    ``frames_mismatch``'s to count)."""
    if got is None or want is None:
        return 0.0
    scale = max(float(np.max(np.abs(want))), 1e-12)
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))) / scale


def count(answers: Sequence[Answer], gate: Optional[Dict]) -> Dict:
    """``mismatch``: answers whose stepped-frame count, or whose having
    logits, differs from the reference's; ``wrong``: their indices."""
    wrong: Set[int] = set()
    for j, a in enumerate(answers):
        n = len(stepped(a.frames, gate))
        if a.steps != n or (a.logits is None) != (n == 0):
            wrong.add(j)
    return {"mismatch": len(wrong), "wrong": wrong}


def windows(a: Answer, kept: List[int],
            steps: int) -> List[Tuple[Optional[np.ndarray], np.ndarray]]:
    """The answer's compared steps — its last and its probes — as
    ``(program's logits, the window of frames the reference serves)``."""
    out = []
    for s, logits in [(len(kept) - 1, a.logits)] + list(a.probes):
        if 0 <= s < len(kept):
            out.append((logits, a.frames[kept[max(0, s + 1 - steps):s + 1]]))
    return out


def compare(cfg: Dict, gate: Optional[Dict], tables: Dict, answers: Sequence[Answer],
            device, precision: str = "fp32") -> Dict:
    """The numbers of `answers` against the reference (served at
    ``precision``): ``logit_gap``; ``wrong``, the indices of the answers
    whose gap fails the configuration's limit; ``probes``, the probed steps
    compared."""
    steps = cfg["tcn_steps"]
    pairs, owners, lasts = [], [], 0
    for j, a in enumerate(answers):
        kept = stepped(a.frames, gate)
        lasts += bool(kept)
        for pair in windows(a, kept, steps):
            pairs.append(pair)
            owners.append(j)
    want = reference_logits(cfg, tables, [f for _, f in pairs], device, precision)
    gap, wrong = 0.0, set()
    for j, (got, _), w in zip(owners, pairs, want):
        g = logit_gap(got, w)
        if g > cfg["limits"]["logit_gap"]:
            wrong.add(j)
        gap = max(gap, g)
    return {"logit_gap": gap, "wrong": wrong, "probes": len(pairs) - lasts}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every number that has a limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
