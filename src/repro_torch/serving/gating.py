"""Activity-gated serving: park quiet sensor streams, wake them on events.
Counterpart of `repro.serving.gating`.

The paper's autonomous mode steps the DVS network on EVERY frame, even
when the sensor sees nothing — but a DVS frame is an event histogram, so
"nothing happened" is host-readable for free: count the nonzero event
bins.  `ActivityGate` is that host-side policy: a per-stream event-count
threshold with hysteresis, TinyVers-style state-retentive duty cycling
mapped onto the serving stack:

  * **park**   — a stream whose frames go quiet is evicted from its
    `SessionPool` slot *with* its ring state (`pool.evict` returns the
    stream's `StreamState`); the slot refills with other traffic while the
    parked stream costs nothing.  The retained ring stays where the pool
    keeps it — on the card — and is NOT discarded: this is retention, not
    cancellation.
  * **wake**   — when a parked stream's frame crosses the (higher) wake
    threshold it re-enters admission and resumes via
    ``pool.admit(sid, state=retained)`` — bit-identical resumption, the
    session export/load seam doing duty-cycle work.
  * **skip**   — frames examined while parked are never sent to the
    device.  Skipped frames are the energy win; `energy_summary` prices
    them through the same sim counters `silicon_report` uses.

Hysteresis (``wake_threshold > park_threshold``, ``park_after`` > 1)
keeps borderline sensors from flapping: a stream parks only after
``park_after`` *consecutive* quiet frames, and needs the stronger wake
burst to come back.

The gate reads frames on the host only (numpy arrays or CPU tensors —
the clips a `StreamRequest` carries); it never reads device data.

The correctness contract (tests/test_torch_gating.py): the
set of processed frames is a pure function of the activity trace —
`ActivityGate.plan` is that function, and a lone `StreamSession` fed
exactly the processed frames must reproduce the gated pool's logits
bit-for-bit on every processed frame.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ActivityGate:
    """Host-side activity policy over incoming event frames.

    ``activity(frame)`` is the nonzero-bin count of the frame (for a DVS
    event histogram: how many pixels saw any event).  A frame is *active*
    at ``>= park_threshold`` events, and wakes a parked stream at
    ``>= wake_threshold``; ``park_after`` consecutive quiet frames park an
    awake stream.  ``wake_threshold > park_threshold`` is the flap guard —
    a sensor hovering at the park line stays wherever it already is."""

    wake_threshold: int = 16
    park_threshold: int = 4
    park_after: int = 2

    def __post_init__(self):
        if self.park_threshold < 0:
            raise ValueError(f"park_threshold {self.park_threshold} < 0")
        if self.wake_threshold <= self.park_threshold:
            raise ValueError(
                f"wake_threshold {self.wake_threshold} must exceed "
                f"park_threshold {self.park_threshold} (hysteresis)"
            )
        if self.park_after < 1:
            raise ValueError(f"park_after {self.park_after} < 1")

    @staticmethod
    def activity(frame) -> int:
        """Event count of one frame — a host-side popcount, no device
        work.  This is the only thing the gate ever reads from a frame."""
        return int(np.count_nonzero(np.asarray(frame)))

    def active(self, frame) -> bool:
        return self.activity(frame) >= self.park_threshold

    def wakes(self, frame) -> bool:
        return self.activity(frame) >= self.wake_threshold

    # -- the differential oracle -------------------------------------------

    def plan(self, activities: Sequence[int]) -> List[bool]:
        """Processed/skipped decision per frame for one stream's activity
        trace — THE deterministic function the gated batcher implements.
        Streams start parked (cold), so a zero-activity trace is all-skip.

        tests/test_torch_gating.py replays this against the live batcher;
        the two must agree frame for frame."""
        out: List[bool] = []
        awake, quiet = False, 0
        for a in activities:
            if not awake:
                if a >= self.wake_threshold:
                    awake, quiet = True, 0
                    out.append(True)
                else:
                    out.append(False)
            elif a >= self.park_threshold:
                quiet = 0
                out.append(True)
            else:
                quiet += 1
                if quiet >= self.park_after:
                    awake = False
                    out.append(False)
                else:
                    out.append(True)  # hysteresis: ride out short dips
        return out


@dataclasses.dataclass
class GateState:
    """Per-stream gate bookkeeping inside a `ContinuousBatcher`.

    ``retained`` holds the parked ring (`core.tcn.StreamState`, on the
    pool's device) between eviction and re-admission — the TinyVers
    retention mechanism.  ``cursor`` is the stream's frame index while it
    has no pool slot (in flight, `ContinuousBatcher._next_frame` is
    authoritative).  ``last_logits`` is ``(logits, slot)`` of the last
    processed frame: the pool step's logits tensor, left on its device,
    and the stream's row in it — the row reaches the host only when the
    stream departs."""

    awake: bool = False
    quiet_run: int = 0
    cursor: int = 0
    retained: Optional[object] = None
    processed: int = 0
    skipped: int = 0
    parks: int = 0
    wakes: int = 0
    last_logits: Optional[object] = None


# ---------------------------------------------------------------------------
# Energy accounting — skipped frames priced in uJ via the sim counters
# ---------------------------------------------------------------------------

def frame_energy_uj(program, v: float = 0.5, hw=None) -> float:
    """uJ of ONE sensor-frame step of ``program``: the spatial frontend
    once plus the TCN head once — the unit of work the gate skips.

    Priced on the same `repro_torch.sim` counters `silicon_report(source="sim")`
    uses (sparsity-aware when the program carries packed images) and scaled
    by the program's paper-corner calibration factor when it has one, so
    the saved-energy numbers live on the same axis as the Table-1 loop.
    Accepts a `DeployedProgram` or an artifact `LoadedProgram`."""
    from repro_torch.api.program import silicon_report_from_plan
    from repro_torch.sim.counters import evaluate_frame

    plan = getattr(program, "plan", None)
    if plan is None:
        plan = program.execution_plan()
    memory = getattr(program, "memory", None)
    if memory is None and hasattr(program, "_bitsim"):
        memory = program._bitsim().memory
    info = program.graph  # CutieGraph or ProgramInfo: both carry the corner
    rep = silicon_report_from_plan(
        plan, v=v, hw=hw, source="sim", memory=memory,
        paper_energy_uj=getattr(info, "paper_energy_uj", None),
        paper_inf_per_s=getattr(info, "paper_inf_per_s", None),
    )
    cal = rep.report.energy_j / rep.ideal.energy_j  # 1.0 when uncalibrated
    frame = evaluate_frame(plan, hw=hw, v=v, memory=memory)
    return float(frame.energy_j * 1e6 * cal)


def energy_summary(program, *, frames_processed: int, frames_total: int,
                   completed: int, v: float = 0.5, hw=None) -> Dict:
    """The energy block of a gated run: what gating saved, in uJ of the
    CUTIE silicon model (not a measurement of the host or the card).

    ``energy_uj_per_classification`` divides the energy actually spent
    (processed frames only) over completed classifications; the
    ``_ungated`` twin prices every frame — the strictly-greater baseline
    whenever any frame was skipped.  All fields are deterministic
    arithmetic over the sim counters (no wall clock)."""
    per_frame = frame_energy_uj(program, v=v, hw=hw)
    skipped = frames_total - frames_processed
    gated = frames_processed * per_frame
    ungated = frames_total * per_frame
    return {
        "frames_total": int(frames_total),
        "frames_processed": int(frames_processed),
        "frames_skipped": int(skipped),
        "duty_cycle": frames_processed / frames_total if frames_total else 0.0,
        "energy_uj_per_frame": per_frame,
        "energy_uj_gated": gated,
        "energy_uj_ungated": ungated,
        "energy_uj_saved": ungated - gated,
        "energy_uj_per_classification": gated / completed
        if completed else float("nan"),
        "energy_uj_per_classification_ungated": ungated / completed
        if completed else float("nan"),
    }
