"""Chrome/Perfetto `trace_event` export, sim layer timelines, summaries.
Counterpart of `repro.obs.export`, plain Python: the same documents for
the same events and programs.

`to_chrome` renders a `repro_torch.obs.tracer.Tracer` into the Chrome trace
JSON object format (load at ``ui.perfetto.dev`` or ``chrome://tracing``):
one timeline track per fleet bucket plus one per emitting thread (the
``cutie-feeder`` ingestion thread shows up as its own lane), instants as
``"i"`` marks, counters as ``"C"`` counter tracks.

`layer_timeline` adds the *modeled silicon* next to the wall clock: it
prices a deployed/loaded program with `repro_torch.sim.counters.count_plan`
and lays the per-layer cycles out as a virtual hardware track (1 cycle
rendered as 1 us of virtual time) with stall/dyn-op/utilisation counter
tracks — the software analogue of the paper's per-layer duty-cycle and
energy breakdowns, in the same Perfetto view as the serving ticks.

`trace_summary` / `validate_nesting` are the structural checks behind
``python -m repro_torch.obs summarize`` (the CI ``obs-smoke`` gate): span
nesting must be proper per track and the trace non-empty.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import Event, Tracer

# Tick-phase taxonomy: the spans a `ContinuousBatcher.tick` decomposes
# into, in emission order.  `phase_breakdown` reports each as a fraction
# of total tick time (serving_bench schema-4 cell, ci_summary table).
TICK_PHASES = ("gate.park", "gate.scan", "admit", "assemble", "step")

SERVING_PID = 1
SIM_PID = 100


def _us(ts: int, clock: str) -> float:
    """Native timestamps -> Chrome microseconds (tick clock: 1 seq = 1 us)."""
    return ts / 1000.0 if clock == "wall" else float(ts)


def to_chrome(tracer: Tracer, meta: Optional[dict] = None) -> dict:
    """Render a tracer into the Chrome trace_event JSON object format.

    Track layout: events carrying ``track=...`` land on a named lane (one
    per fleet bucket / net), everything else on a lane named after its
    emitting thread — so the feeder thread is visibly parallel to the
    scheduler's tick spans.  Counter events always attach per-process."""
    clock = tracer.clock
    thread_names = tracer.thread_names
    # lane name -> chrome tid (stable, in order of first appearance)
    lanes: Dict[str, int] = {}
    events: List[dict] = []

    def lane_tid(event: Event) -> int:
        name = event.track or thread_names.get(event.tid, f"thread-{event.tid}")
        tid = lanes.get(name)
        if tid is None:
            tid = lanes[name] = len(lanes)
        return tid

    for ev in tracer.events():
        if ev.phase == "X":
            rec = {"ph": "X", "name": ev.name, "pid": SERVING_PID,
                   "tid": lane_tid(ev), "ts": _us(ev.ts, clock),
                   "dur": _us(ev.dur, clock), "cat": "serving"}
            if ev.args:
                rec["args"] = ev.args
            events.append(rec)
        elif ev.phase == "i":
            rec = {"ph": "i", "name": ev.name, "pid": SERVING_PID,
                   "tid": lane_tid(ev), "ts": _us(ev.ts, clock),
                   "s": "t", "cat": "serving"}
            if ev.args:
                rec["args"] = ev.args
            events.append(rec)
        elif ev.phase == "C":
            name = f"{ev.track}/{ev.name}" if ev.track else ev.name
            events.append({"ph": "C", "name": name, "pid": SERVING_PID,
                           "tid": 0, "ts": _us(ev.ts, clock),
                           "args": ev.args or {}})

    header = [{"ph": "M", "name": "process_name", "pid": SERVING_PID, "tid": 0,
               "args": {"name": "repro.serving"}}]
    for name, tid in lanes.items():
        header.append({"ph": "M", "name": "thread_name", "pid": SERVING_PID,
                       "tid": tid, "args": {"name": name}})
        header.append({"ph": "M", "name": "thread_sort_index",
                       "pid": SERVING_PID, "tid": tid,
                       "args": {"sort_index": tid}})

    other = {"clock": clock, "dropped_events": tracer.dropped}
    if meta:
        other.update(meta)
    return {"traceEvents": header + events, "displayTimeUnit": "ms",
            "otherData": other}


def layer_timeline(program, name: Optional[str] = None,
                   pid: int = SIM_PID) -> List[dict]:
    """Virtual hardware track: the program's plan layers priced by the
    sim counters, one span per layer with ``dur = cycles`` (1 cycle
    rendered as 1 us of virtual time), plus stall/dyn-op counter tracks.

    Accepts a `DeployedProgram` or artifact `LoadedProgram` — the same
    plan/memory duck-typing as `repro_torch.serving.gating.frame_energy_uj`."""
    from repro_torch.sim.counters import count_plan

    plan = getattr(program, "plan", None)
    if plan is None:
        plan = program.execution_plan()
    memory = getattr(program, "memory", None)
    if memory is None and hasattr(program, "_bitsim"):
        memory = program._bitsim().memory
    name = name or getattr(plan, "graph_name", None) or "program"

    counts = count_plan(plan, memory=memory)
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"sim:{name} (1 cycle = 1 us virtual)"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": "layers"}},
    ]
    t = 0.0
    for lc in counts:
        dur = float(max(lc.cycles, 1))
        events.append({
            "ph": "X", "name": lc.label, "pid": pid, "tid": 0,
            "ts": t, "dur": dur, "cat": "sim",
            "args": {"index": lc.index, "kind": lc.kind, "tiles": lc.tiles,
                     "cycles": lc.cycles, "macs": lc.macs,
                     "util": round(lc.util, 4),
                     "stall_cycles": lc.stall_cycles,
                     "dyn_ops": lc.dyn_ops,
                     "w_sparsity": round(lc.w_sparsity, 4)}})
        events.append({"ph": "C", "name": f"sim:{name}/stall_cycles",
                       "pid": pid, "tid": 0, "ts": t,
                       "args": {"bank": lc.bank_stall_cycles,
                                "ndb": lc.ndb_stall_cycles}})
        events.append({"ph": "C", "name": f"sim:{name}/dyn_ops",
                       "pid": pid, "tid": 0, "ts": t,
                       "args": {"dyn_ops": lc.dyn_ops}})
        events.append({"ph": "C", "name": f"sim:{name}/util",
                       "pid": pid, "tid": 0, "ts": t,
                       "args": {"util": round(lc.util, 4)}})
        t += dur
    return events


def save_chrome(path: str, tracer: Tracer,
                sim_programs: Optional[Dict[str, object]] = None,
                meta: Optional[dict] = None) -> dict:
    """`to_chrome` + per-program `layer_timeline` tracks, written to
    ``path`` as one Perfetto-loadable JSON file.  Returns the document."""
    doc = to_chrome(tracer, meta=meta)
    for i, (name, program) in enumerate(sorted((sim_programs or {}).items())):
        doc["traceEvents"].extend(
            layer_timeline(program, name=name, pid=SIM_PID + i))
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def load(path: str) -> dict:
    """Load a saved Chrome trace JSON document."""
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents)")
    return doc


def validate_nesting(doc: dict) -> List[str]:
    """Check that complete spans nest properly per (pid, tid) lane.

    Returns a list of human-readable violations (empty = valid).  A span
    must either start after the enclosing span's end (sibling) or lie
    entirely within it (child); partial overlap means instrumentation
    lost track of a boundary."""
    lanes: Dict[Tuple[int, int], List[dict]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X":
            lanes.setdefault((ev.get("pid", 0), ev.get("tid", 0)), []).append(ev)
    problems: List[str] = []
    for key, events in sorted(lanes.items()):
        # sort by start; ties: longer (outer) span first
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[Tuple[float, float, str]] = []
        for ev in events:
            start, end = ev["ts"], ev["ts"] + ev.get("dur", 0)
            while stack and stack[-1][1] <= start:
                stack.pop()
            if stack and end > stack[-1][1]:
                problems.append(
                    f"pid {key[0]} tid {key[1]}: span {ev['name']!r} "
                    f"[{start}, {end}] overlaps {stack[-1][2]!r} "
                    f"ending at {stack[-1][1]}")
                continue
            stack.append((start, end, ev["name"]))
    return problems


def phase_breakdown(doc: dict) -> Dict[str, dict]:
    """Per-lane tick-phase attribution from a Chrome trace document.

    For every lane that carries ``tick`` spans, reports total tick time
    and each `TICK_PHASES` member's summed duration + fraction of it.
    The residue (tick time in none of the phases — cursor bookkeeping,
    feeder kicks) is reported as ``other``."""
    lane_names: Dict[Tuple[int, int], str] = {}
    sums: Dict[Tuple[int, int], Dict[str, float]] = {}
    ticks: Dict[Tuple[int, int], Tuple[float, int]] = {}
    for ev in doc.get("traceEvents", []):
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            lane_names[key] = ev["args"]["name"]
        elif ev.get("ph") == "X":
            if ev["name"] == "tick":
                total, n = ticks.get(key, (0.0, 0))
                ticks[key] = (total + ev.get("dur", 0), n + 1)
            elif ev["name"] in TICK_PHASES:
                lane = sums.setdefault(key, {})
                lane[ev["name"]] = lane.get(ev["name"], 0.0) + ev.get("dur", 0)
    out: Dict[str, dict] = {}
    for key, (tick_total, n_ticks) in sorted(ticks.items()):
        name = lane_names.get(key, f"lane-{key[1]}")
        phases = sums.get(key, {})
        accounted = sum(phases.values())
        row = {"ticks": n_ticks, "tick_total_us": tick_total, "phases": {}}
        for phase in TICK_PHASES:
            dur = phases.get(phase, 0.0)
            row["phases"][phase] = {
                "us": dur,
                "fraction": (dur / tick_total) if tick_total else 0.0,
            }
        row["phases"]["other"] = {
            "us": max(tick_total - accounted, 0.0),
            "fraction": (max(tick_total - accounted, 0.0) / tick_total
                         if tick_total else 0.0),
        }
        out[name] = row
    return out


def trace_summary(doc: dict) -> dict:
    """Structural digest of a trace document: event counts by phase,
    span/instant counts by name, lanes, tick-phase breakdown, and any
    nesting violations.  ``ok`` is False on an empty trace or improper
    nesting — the ``obs-smoke`` CI contract."""
    by_phase: Dict[str, int] = {}
    spans: Dict[str, int] = {}
    instants: Dict[str, int] = {}
    lanes: Dict[str, int] = {}
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph", "?")
        if ph == "M":
            if ev.get("name") == "thread_name":
                lanes[ev["args"]["name"]] = ev.get("tid", 0)
            continue
        by_phase[ph] = by_phase.get(ph, 0) + 1
        if ph == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
        elif ph == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
    problems = validate_nesting(doc)
    n_events = sum(by_phase.values())
    return {
        "ok": n_events > 0 and not problems,
        "events": n_events,
        "by_phase": by_phase,
        "spans": dict(sorted(spans.items())),
        "instants": dict(sorted(instants.items())),
        "lanes": dict(sorted(lanes.items(), key=lambda kv: kv[1])),
        "nesting_problems": problems,
        "dropped_events": doc.get("otherData", {}).get("dropped_events", 0),
        "phase_breakdown": phase_breakdown(doc),
    }


def trace_diff(a: dict, b: dict) -> dict:
    """Compare two trace documents structurally: span/instant count
    deltas by name and per-lane tick-phase fraction shifts.  Wall times
    differ run to run; the *shape* of two runs of the same scenario
    should not."""
    sa, sb = trace_summary(a), trace_summary(b)
    names = sorted(set(sa["spans"]) | set(sb["spans"]))
    span_delta = {
        n: {"a": sa["spans"].get(n, 0), "b": sb["spans"].get(n, 0)}
        for n in names
        if sa["spans"].get(n, 0) != sb["spans"].get(n, 0)
    }
    inames = sorted(set(sa["instants"]) | set(sb["instants"]))
    instant_delta = {
        n: {"a": sa["instants"].get(n, 0), "b": sb["instants"].get(n, 0)}
        for n in inames
        if sa["instants"].get(n, 0) != sb["instants"].get(n, 0)
    }
    phase_shift: Dict[str, dict] = {}
    pa, pb = sa["phase_breakdown"], sb["phase_breakdown"]
    for lane in sorted(set(pa) & set(pb)):
        shifts = {}
        for phase in (*TICK_PHASES, "other"):
            fa = pa[lane]["phases"][phase]["fraction"]
            fb = pb[lane]["phases"][phase]["fraction"]
            if abs(fa - fb) > 1e-9:
                shifts[phase] = {"a": round(fa, 4), "b": round(fb, 4),
                                 "delta": round(fb - fa, 4)}
        if shifts:
            phase_shift[lane] = shifts
    return {
        "identical_shape": not span_delta and not instant_delta,
        "span_count_delta": span_delta,
        "instant_count_delta": instant_delta,
        "lanes_only_in_a": sorted(set(sa["lanes"]) - set(sb["lanes"])),
        "lanes_only_in_b": sorted(set(sb["lanes"]) - set(sa["lanes"])),
        "phase_fraction_shift": phase_shift,
    }
