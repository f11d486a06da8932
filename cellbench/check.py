"""The comparison that decides ``correct``: the parts any system shares.

After the window (and its drain) every clip that was due in it must have its
answer.  The system (``systems/<system>.py``, its ``compare``) judges the
answers against its plain reference (``reference/``) served from the
benchmark's own weights,
calibration frames and clip frames, with what this module gives it: the
sample of answers the reference serves again, drawn from the seed; the gap
between two logit rows; the count of answers whose stepped frames differ
from the reference's.  A run's numbers, each against the configuration's
limit:

* ``logit_gap`` — the widest gap between the program's logits and the
  reference's, as a share of the reference's largest logit magnitude, over
  the sample's compared frames;
* ``frames_mismatch`` — answers, of every answered clip, whose count of
  stepped frames differs from the reference's, or whose having logits at
  all does;
* ``missing`` — clips due in the window whose answer never came.

A limit whose number the system did not give is a failed check.  Before
any of that, `check_graph` holds the program's graph to the configuration's
sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cellbench import traffic

SAMPLE = 256


def check_graph(graph, cfg: Dict) -> None:
    """The program's graph has exactly the configuration's sizes (its ring
    depth too, where the configuration has one)."""
    want = {"input_hw": tuple(cfg["input_hw"]), "input_ch": cfg["input_ch"],
            "n_classes": cfg["n_classes"], "act_threshold": cfg["act_threshold"],
            "weight_nu": cfg["weight_nu"], "qat_per_channel": False}
    if "tcn_steps" in cfg:
        want["tcn_steps"] = cfg["tcn_steps"]
    got = {k: getattr(graph, k) for k in want}
    if got != want:
        raise ValueError(f"{graph.name}: {got} != the configuration's {want}")
    fields = {"conv2d": ("c_in", "c_out", "kernel", "stride"), "pool": ("window",),
              "tcn": ("c_in", "c_out", "kernel", "taps", "dilation"), "fc": ("c_in", "c_out")}
    layers = [(l.kind, {f: getattr(l, f) for f in fields.get(l.kind, ())}) for l in graph.layers]
    mine = [(l["kind"], {f: tuple(l[f]) if f == "kernel" else l.get(f, 1)
                         for f in fields.get(l["kind"], ())}) for l in cfg["layers"]]
    if layers != mine:
        raise ValueError(f"{graph.name}: the registry's layers differ from the configuration's")


@dataclasses.dataclass
class Answer:
    """What the program answered for one clip."""

    frames: np.ndarray                 # the clip's host frames [T, H, W, C]
    logits: Optional[np.ndarray]       # None: no frame reached the device
    steps: int                         # frames it stepped, counted by the harness
    probes: List[Tuple[int, np.ndarray]] = dataclasses.field(default_factory=list)  # (step, logits)


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


def logit_gap(got: Optional[np.ndarray], want: Optional[np.ndarray]) -> float:
    """``max|got - want| / max|want|`` (0 where either is absent: that is
    ``frames_mismatch``'s to count)."""
    if got is None or want is None:
        return 0.0
    scale = max(float(np.max(np.abs(want))), 1e-12)
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))) / scale


def count(answers: Sequence[Answer], want: Sequence[int]) -> Dict:
    """``mismatch``: answers whose stepped-frame count differs from the
    reference's ``want``, or whose having logits differs from its having a
    stepped frame; ``wrong``: their indices."""
    wrong: Set[int] = set()
    for j, (a, n) in enumerate(zip(answers, want)):
        if a.steps != n or (a.logits is None) != (n == 0):
            wrong.add(j)
    return {"mismatch": len(wrong), "wrong": wrong}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every limit; the value is None
    where the system gave no such number."""
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every limited number was given and is within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
