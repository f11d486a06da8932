"""One run of one cell: set-up, warm-up, the measured window, the check.

The system under test is the configuration's ``system``, the module
``systems/<system>.py`` (``stream_pool``: the port's serving stack over a
captured pool step), and the check's plain reference is its ``reference``,
``reference/<reference>.py``.  This module is the part of a run that any
system shares.

Set-up (``setup_s``, from process start to the window's first tick) makes
the weights on the device from the seed in one call, draws the frame bank and
the calibration frames, has the system build itself (the program quantized
from those weights and frames) and warm up every shape the mix uses.  The
window then runs the mix's loop (``loops/<loop>.py``) for ``seconds``; it
ends in a synchronise.  Clips due in the window that are still in flight are
served to the end afterwards (at most a minute), so each has its answer and
its latency counts the wait.  The system keeps on the way what its check
reads, and once the window has closed and the system is freed, compares its
answers with the reference's.

A system module has ``build(cell, params, calib, bank, device, tracer)``,
whose object has ``batch`` (frames one step holds), ``pending``,
``tick_index``, ``warm_up(seed)``, ``watch(seed)`` (from here on keep what
the check reads), ``submit(clip)``, ``tick()`` -> ``(host clock when its
outputs were on hand, frames stepped, [(clip id, result)])`` and
``answers(records)``; ``compare(cell, params, calib, answers, seed,
device)`` -> ``(numbers, info)``, against the plain reference that the
module imports from ``reference/``; and ``control(cell, params, calib, bank,
seed, device, n)``, the numbers of that reference served in the precision
below in the program's place.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from cellbench import check, devtrace, traffic
from cellbench.spec import Cell, load_module

TRACER_CAPACITY = 1 << 22
DRAIN_S = 60.0
PROFILE_S = 0.5     # the profiled sub-window: the window's last half second


@dataclasses.dataclass
class ClipRecord:
    clip: traffic.Clip
    due: float                   # host clock: when the clip was due
    submitted: float             # host clock: when the harness submitted it
    done: Optional[float] = None  # host clock: when its logits were on the host
    result: object = None         # the system's answer (the program's StreamResult)


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: Cell
    setup_s: float
    window_s: float
    frames: int                  # frames stepped in the window
    ticks: int
    step_ticks: int
    batch: int                   # frames one step holds (the system's)
    clips: List[ClipRecord]      # every clip due in the window
    tick_walls: List[float]      # host clock at each tick's start, window and drain
    tick_base: int               # the system's tick index of tick_walls[0]
    spans: Dict[str, List[Tuple[float, float]]]  # traced: name -> [(start, dur)] in the window
    profile: Optional[devtrace.Profile]

    def tick_wall(self, index: int) -> float:
        return self.tick_walls[index - self.tick_base]

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def mix(self) -> Dict:
        return self.cell.traffic


class Window:
    """The measured stretch of a run: ticks, submissions, departures."""

    def __init__(self, system, *, tracer=None, seconds: float = 0.0, k1_patterns=()):
        self.system = system
        self.tracer = tracer
        self.records: Dict[str, ClipRecord] = {}
        self.order: List[ClipRecord] = []
        self.tick_walls: List[float] = []
        self.tick_base = system.tick_index
        self.frames = self.ticks = self.step_ticks = 0
        self.t0 = self.t_close = None
        self.window_s = 0.0
        self.k1_patterns = tuple(k1_patterns)
        # the profiled sub-window (traced runs only)
        self.prof = None
        self.prof_at = max(0.0, seconds - PROFILE_S) if tracer is not None else None
        self.prof_bounds: Optional[Tuple[float, float]] = None
        self.prof_counts = [0, 0]  # stepping ticks, frames
        self.prof_mark_ns = 0
        self.late: List[float] = []
        self.frames_by_second: List[int] = []

    # -- clock -------------------------------------------------------------

    def open(self) -> None:
        sync()
        if self.tracer is not None:  # aligns the tracer's clock with the host's
            self._tracer_mark_ns = time.perf_counter_ns()
            self.tracer.instant(devtrace.MARK)
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def wait_until(self, at: float) -> None:
        """Sleep, then spin, until ``at`` seconds after the window opened."""
        left = self.t0 + at - time.perf_counter()
        if left > 0.002:
            time.sleep(left - 0.001)
        while time.perf_counter() < self.t0 + at:
            pass

    @property
    def pending(self) -> bool:
        return self.system.pending

    # -- traffic -----------------------------------------------------------

    def submit(self, clip: traffic.Clip, due: Optional[float] = None) -> ClipRecord:
        """Hand the clip to the system; ``due`` (host clock) defaults to now."""
        now = time.perf_counter()
        rec = ClipRecord(clip, now if due is None else due, now)
        if due is not None:
            self.late.append(now - due)
        self.records[clip.stream_id] = rec
        self.order.append(rec)
        self.system.submit(clip)
        return rec

    def tick(self) -> List[ClipRecord]:
        """One tick of the system; returns the clips that departed in it."""
        if self.prof_at is not None and self.prof is None and self.t_close is None \
                and self.elapsed() >= self.prof_at:
            self._profile_start()
        self.tick_walls.append(time.perf_counter())
        done, n, results = self.system.tick()
        if self.t_close is None:
            self.ticks += 1
            self.frames += n
            self.step_ticks += n > 0
            second = int(done - self.t0)
            while len(self.frames_by_second) <= second:
                self.frames_by_second.append(0)
            self.frames_by_second[second] += n
            if self.prof_bounds is None and self.prof is not None:
                self.prof_counts[0] += n > 0
                self.prof_counts[1] += n
        departed = []
        for sid, result in results:
            rec = self.records[sid]
            rec.done, rec.result = done, result
            departed.append(rec)
        return departed

    def close(self) -> None:
        """End the window: synchronise, stop the clock (and the profiler,
        whose stop costs time that the window does not see)."""
        sync()
        self.t_close = time.perf_counter()
        self.window_s = self.t_close - self.t0
        if self.prof is not None:
            self.prof_bounds = (self._prof_t0, self.t_close)
            self.prof.stop()

    def drain(self, limit: float = DRAIN_S) -> None:
        """Serve what is in flight to its end (at most ``limit`` seconds)."""
        start = time.perf_counter()
        while self.system.pending and time.perf_counter() - start < limit:
            self.tick()
        sync()

    # -- the profiled sub-window ---------------------------------------------

    def _profile_start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
        # on the card only device activity is recorded (host-side recording
        # would slow the host this window measures); the clocks are aligned
        # by the sub-window's first device operation, a one-element fill
        # launched on an idle card at a known host time
        act = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
        marker = torch.zeros(1, device="cuda") if on_card else None
        sync()
        self.prof = profile(activities=[act])
        self.prof.start()
        if on_card:
            self.prof_mark_ns = time.perf_counter_ns()
            marker.fill_(1.0)
        else:
            with record_function(devtrace.MARK):
                self.prof_mark_ns = time.perf_counter_ns()
        sync()
        self._prof_t0 = time.perf_counter()

    def profile(self) -> devtrace.Profile:
        """The sub-window's reduction (after the run)."""
        events = self.prof.events()
        return devtrace.reduce(events, self.prof_mark_ns, self.prof_bounds,
                               devtrace.SpanIndex(self.host_spans()), self.k1_patterns,
                               *self.prof_counts)

    def record(self, cell: Cell, setup_s: float, spans=None, profile=None) -> RunRecord:
        """What the metric readers read, once the window has closed."""
        return RunRecord(cell=cell, setup_s=setup_s, window_s=self.window_s, frames=self.frames,
                         ticks=self.ticks, step_ticks=self.step_ticks, batch=self.system.batch,
                         clips=list(self.order),
                         tick_walls=self.tick_walls, tick_base=self.tick_base,
                         spans=spans or {}, profile=profile)

    def host_spans(self) -> List[Tuple[float, float, str]]:
        """The tracer's spans on the host clock: ``(start_s, end_s, name)``."""
        events = self.tracer.events()
        mark = next(e for e in events if e.phase == "i" and e.name == devtrace.MARK)
        shift = self._tracer_mark_ns - mark.ts
        return [((e.ts + shift) / 1e9, (e.ts + e.dur + shift) / 1e9, e.name)
                for e in events if e.phase == "X"]


def read_metrics(record: RunRecord, metrics: List[Dict]) -> Dict:
    """``{name: {"value", "unit"}}`` from each metric's reader; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _export_trace(prof, name: str) -> None:
    """The profiled sub-window as a Chrome trace under ``TMPDIR``."""
    import tempfile

    path = os.path.join(tempfile.gettempdir(), name)
    try:
        prof.export_chrome_trace(path)
    except OSError as e:
        print(f"cellbench: trace not written to {path}: {e}", file=sys.stderr)


def _warm_profiler(dev) -> None:
    """Start and stop the profiler once, so that its first start (seconds of
    set-up) is not inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        torch.ones(8, device=dev).add_(1)
        sync()
    prof.events()


def sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- the inputs -------------------------------------------------------------------

def make_params(cfg: Dict, seed: int, device) -> Dict:
    """Float32 weights in the port's layout, Kaiming-normal as the port's
    ``init`` draws them, made on ``device`` from the seed in one call."""
    import torch

    shapes, stds = [], []
    for layer in cfg["layers"]:
        if layer["kind"] == "conv2d":
            kh, kw = layer["kernel"]
            shapes.append(("conv", (kh, kw, layer["c_in"], layer["c_out"])))
            stds.append((2.0 / (kh * kw * layer["c_in"])) ** 0.5)
        elif layer["kind"] == "tcn":
            shapes.append(("tcn", (layer["taps"], layer["c_in"], layer["c_out"])))
            stds.append((2.0 / (layer["taps"] * layer["c_in"])) ** 0.5)
        elif layer["kind"] == "fc":
            shapes.append(("fc", (layer["c_in"], layer["c_out"])))
            stds.append(0.05)
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(traffic.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    params: Dict = {"conv": [], "tcn": []}
    for (kind, shape), std, chunk in zip(shapes, stds, torch.split(flat, sizes)):
        w = chunk.reshape(shape) * std
        if kind == "fc":
            params["fc"] = {"w": w}
        else:
            params[kind].append({"w": w})
    return params


def make_frames(cell: Cell, seed: int, dev):
    """The mix's frame bank and the calibration frames (`traffic.calibration`)."""
    import torch

    cfg = cell.config
    bank = traffic.make_bank(load_module("sources", cfg["frames"]), cfg, cell.traffic, seed, dev)
    calib = torch.from_numpy(traffic.calibration(bank, cfg)).to(dev)
    return bank, calib


def set_up(cell: Cell, seed: int, dev, tracer=None):
    """Weights, calibration frames, the frame bank and the warmed-up system."""
    cfg = cell.config
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        parts[name], t = time.perf_counter() - t, time.perf_counter()

    params = make_params(cfg, seed, dev)
    lap("weights_s")
    bank, calib = make_frames(cell, seed, dev)
    lap("frames_s")
    system = load_module("systems", cfg["system"]).build(cell, params, calib, bank, dev, tracer)
    lap("quantize_s")
    system.warm_up(seed)
    lap("warm_up_s")
    return params, calib, bank, system, parts


# -- one run ----------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: Optional[float] = None) -> Tuple[Dict, List[str]]:
    """Run ``cell`` once.  Returns the result object (the contract's last
    line) and the lines that state each compared number beside its limit."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    loop = load_module("loops", mix["loop"])
    kind = load_module("systems", cfg["system"])

    tracer = None
    if trace:
        from repro_torch.obs import Tracer

        tracer = Tracer(capacity=TRACER_CAPACITY)
    t_entry = time.perf_counter()
    params, calib, bank, system, parts = set_up(cell, seed, dev, tracer)
    parts = {"start_s": t_entry - t_start, **parts}
    plan = loop.prepare(mix, seconds, bank, seed)
    if tracer is not None:
        _warm_profiler(dev)
        tracer.clear()
    gc.collect()
    gc.freeze()  # what set-up made is not rescanned by the window's collections
    system.watch(seed)
    w = Window(system, tracer=tracer, seconds=seconds, k1_patterns=cfg["kernels"]["k1"])
    w.open()
    setup_s = w.t0 - t_start
    loop.drive(w, plan, mix, seconds)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    profile = None
    if w.prof is not None:
        profile = w.profile()
        _export_trace(w.prof, f"cellbench_{cell.name}_{seed}.json")
    t_profiled = time.perf_counter()
    spans: Dict[str, List[Tuple[float, float]]] = {}
    if tracer is not None:
        hi = w.t0 + w.window_s
        for s, e, name in w.host_spans():
            if w.t0 <= s and e <= hi:
                spans.setdefault(name, []).append((s, e - s))
    record = w.record(cell, setup_s, spans, profile)
    metrics = read_metrics(record, cell.metrics(trace))

    # the check: after the window, with the program's state freed
    answers = system.answers(record.clips)
    missing = sum(r.result is None for r in record.clips)
    late, w_close, by_second = w.late, w.t_close, w.frames_by_second
    del system, w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, compared = kind.compare(cell, params, calib, answers, seed, dev)
    numbers["missing"] = float(missing)
    check_s = time.perf_counter() - t_profiled
    checks = check.judge(numbers, cfg["limits"])
    correct = check.passed(checks)
    failed = missing + numbers["wrong"]

    result: Dict = {
        "correct": bool(correct),
        "attempted": len(record.clips),
        "failed": int(failed),
        "metrics": metrics,
        "device": _device(dev, memory_peak),
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": devtrace.top(profile.by_name),
                               "idle_gaps": devtrace.top(profile.idle_by_label)}
    result["info"] = {
        "window_s": record.window_s, "frames": record.frames, "ticks": record.ticks,
        "stepping_ticks": record.step_ticks, "answered": len(answers), **compared,
        "generator_late_ms_max": max(late, default=0.0) * 1e3,
        "drain_and_profile_s": t_profiled - w_close, "check_s": check_s,
        "setup_parts": parts, "frames_by_second": by_second,
    }
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines


def _device(dev, memory_peak: int) -> Dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": memory_peak}
