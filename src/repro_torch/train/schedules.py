"""Piecewise-constant schedules for the QAT quantization knobs (nu, threshold).
Counterpart of `repro.train.schedules`, carried over verbatim (plain Python).

Why piecewise-constant and not smooth: the TWN threshold factor ``nu`` is a
*static* argument of the weight STE (`core.ternary.ste_ternary_weights`
gives it no gradient), so every distinct value costs the reference one
retrace of its jitted train step (the port builds one step closure per
segment in the same places).  A handful of segments captures the useful recipes — start with
a lower nu (denser ternary weights, more gradient signal) and anneal to the
deployment value — at a bounded retrace count.  The activation threshold can
either ride the same schedule machinery (static per segment) or be learned
per layer through the STE threshold gradient (`repro_torch.train.loop`'s
``thresholds="learned"``), which needs no schedule at all.

The segment values are Python floats on purpose: they are closed over by the
step function, never traced, and the final segment's value is what
`CutieProgram.quantize(nu=...)` packs with — training grid == deploy grid.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PiecewiseConstant:
    """value(step) = values[i] on [boundaries[i-1], boundaries[i]).

    ``boundaries`` are the step indices where the value CHANGES (strictly
    increasing); ``values`` has exactly one more entry than ``boundaries``.
    """

    boundaries: Tuple[int, ...]
    values: Tuple[float, ...]

    def __post_init__(self):
        if len(self.values) != len(self.boundaries) + 1:
            raise ValueError(
                f"need len(values) == len(boundaries)+1, got "
                f"{len(self.values)} vs {len(self.boundaries)}"
            )
        if list(self.boundaries) != sorted(set(self.boundaries)):
            raise ValueError(f"boundaries must strictly increase: {self.boundaries}")

    def __call__(self, step: int) -> float:
        return self.values[bisect.bisect_right(self.boundaries, step)]

    @property
    def final(self) -> float:
        """The last segment's value — what deployment packing should use."""
        return self.values[-1]

    def segments(self, total_steps: int) -> List[Tuple[int, int, float]]:
        """[(start, end, value)] covering [0, total_steps) — the train loop
        runs one jitted step function per segment."""
        edges = [0] + [b for b in self.boundaries if b < total_steps] + [total_steps]
        return [(s, e, self(s)) for s, e in zip(edges[:-1], edges[1:]) if e > s]


def constant(value: float) -> PiecewiseConstant:
    return PiecewiseConstant(boundaries=(), values=(float(value),))


def anneal(
    target: float,
    total_steps: int,
    *,
    start_frac: float = 0.6,
    segments: int = 4,
    hold_frac: float = 0.5,
) -> PiecewiseConstant:
    """Ramp ``start_frac * target -> target`` over the first
    ``(1 - hold_frac)`` of training in ``segments`` equal steps, then hold
    the target.  Used for nu: early training keeps more weights alive, the
    final half trains on the exact deployment grid."""
    if segments < 1:
        raise ValueError("need >= 1 segments")
    ramp_steps = max(int(total_steps * (1.0 - hold_frac)), segments)
    bounds = tuple(ramp_steps * (i + 1) // segments for i in range(segments))
    vals = tuple(
        float(target * (start_frac + (1.0 - start_frac) * i / segments))
        for i in range(segments)
    ) + (float(target),)
    # dedupe any repeated boundaries from tiny ramps
    ded_b: List[int] = []
    ded_v: List[float] = [vals[0]]
    for b, v in zip(bounds, vals[1:]):
        if ded_b and b <= ded_b[-1]:
            ded_v[-1] = v
            continue
        ded_b.append(b)
        ded_v.append(v)
    return PiecewiseConstant(boundaries=tuple(ded_b), values=tuple(ded_v))


def resolve(spec: str, target: float, total_steps: int) -> PiecewiseConstant:
    """CLI string -> schedule.  ``"const"`` holds ``target``; ``"anneal"``
    ramps to it (see `anneal`); a bare float holds that value instead."""
    if spec == "const":
        return constant(target)
    if spec == "anneal":
        return anneal(target, total_steps)
    try:
        return constant(float(spec))
    except ValueError:
        raise ValueError(f"unknown schedule spec {spec!r} (const|anneal|<float>)")


def merged_segments(
    total_steps: int, *scheds: PiecewiseConstant
) -> List[Tuple[int, int, Sequence[float]]]:
    """Split [0, total_steps) at every boundary of every schedule:
    [(start, end, (value_of_sched_0, value_of_sched_1, ...))].  The train
    loop jits one step function per merged segment."""
    edges = {0, total_steps}
    for s in scheds:
        edges.update(b for b in s.boundaries if 0 < b < total_steps)
    out = []
    se = sorted(edges)
    for a, b in zip(se[:-1], se[1:]):
        out.append((a, b, tuple(s(a) for s in scheds)))
    return out
