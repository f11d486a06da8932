"""One run of one cell: set-up, warm-up, the measured window, the check.

The system under test is the port's serving stack as ``launch/serve.py``
wires it: ``ContinuousBatcher`` (no feeder; an ``ActivityGate`` where the mix
has one; ``NULL_TRACER`` untraced, a ``repro_torch.obs.Tracer`` traced) over
the ``SessionPool`` that ``DeployedProgram.serve(pool, backend="fused")``
builds, whose step is captured once as a CUDA graph and replayed every tick.
The program is the registry's net, checked against the configuration's
sizes, quantized by the program from the benchmark's float weights and
calibration frames.

Set-up (``setup_s``, from process start to the window's first tick) makes
the weights on the device from the seed in one call, draws the frame bank,
quantizes, builds the pool and batcher, and runs a warm-up of ``pool + 4``
clips of the mix through the same path until it drains: the first tick
builds K1 and captures the step, and admission, eviction, departures and
the gate's park and wake each run once.  The window then runs the mix's loop
(``loops/<loop>.py``) for ``seconds``; it ends in a synchronise.  Clips due
in the window that are still in flight are served to the end afterwards (at
most a minute), so each has its answer and its latency counts the wait.

For the check the window also counts, from the keys of each tick's output,
the frames every clip stepped, and for one clip in ``PROBE_EVERY`` (chosen
from the seed and the clip's id) keeps the logits of two of its frames — one
within its first ``tcn_steps``, whose window holds zero history, and one
anywhere in the clip — copied on the device into a buffer made in set-up.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from cellbench import check, devtrace, traffic
from cellbench.reference import cutie
from cellbench.spec import Cell, load_module

TRACER_CAPACITY = 1 << 22
DRAIN_S = 60.0
PROFILE_S = 0.5     # the profiled sub-window: the window's last half second
PROBE_EVERY = 4     # one clip in four keeps the logits of two of its frames
PROBE_ROWS = 1 << 15


@dataclasses.dataclass
class ClipRecord:
    clip: traffic.Clip
    due: float                   # host clock: when the clip was due
    submitted: float             # host clock: when the harness submitted it
    done: Optional[float] = None  # host clock: when its logits were on the host
    result: object = None         # the program's StreamResult
    steps: int = 0                # frames it stepped, counted from the ticks' outputs
    probes: List[Tuple[int, np.ndarray]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: Cell
    setup_s: float
    window_s: float
    frames: int                  # frames stepped in the window
    ticks: int
    step_ticks: int
    clips: List[ClipRecord]      # every clip due in the window
    tick_walls: List[float]      # host clock at each tick's start, window and drain
    tick_base: int               # the batcher's index of tick_walls[0]
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


class Probes:
    """The logits of chosen frames, kept on the way for the check.

    A clip is probed when the hash of the seed and its id is a multiple of
    ``PROBE_EVERY``; it then keeps its step ``early`` (below ``tcn_steps``)
    and its step ``anywhere``.  Each is copied, on the device and in the
    tick's stream order, into a row of a buffer made before the window."""

    def __init__(self, seed: int, steps: int, n_classes: int, device, rows: int = PROBE_ROWS):
        import torch

        self.seed, self.steps = seed, steps
        self.buf = torch.empty((rows, n_classes), device=device)
        self.used = 0
        self.want: Dict[str, Dict[int, int]] = {}   # in flight: id -> {step: row}
        self.kept: Dict[str, List[Tuple[int, int]]] = {}

    def choose(self, clip: traffic.Clip) -> None:
        h = traffic.derive(self.seed, "probe/" + clip.stream_id)
        if h % PROBE_EVERY or self.used + 2 > len(self.buf):
            return
        at = {(h >> 8) % min(self.steps, clip.length), (h >> 32) % clip.length}
        self.want[clip.stream_id] = {s: self.used + i for i, s in enumerate(sorted(at))}
        self.kept[clip.stream_id] = []
        self.used += len(at)

    def see(self, out: Dict, steps: Counter) -> None:
        """After a tick: copy the rows of the probed steps it produced."""
        done = []
        for sid, want in self.want.items():
            logits = out.get(sid)
            if logits is None:
                continue
            step = steps[sid] - 1
            row = want.pop(step, None)
            if row is not None:
                self.buf[row].copy_(logits)
                self.kept[sid].append((step, row))
                if not want:
                    done.append(sid)
        for sid in done:
            del self.want[sid]

    def read(self, records: Dict[str, "ClipRecord"]) -> None:
        """After the window: hand each record its probes' logits."""
        host = self.buf[:self.used].cpu().numpy()
        for sid, kept in self.kept.items():
            records[sid].probes = [(step, host[row]) for step, row in kept]


class Window:
    """The measured stretch of a run: ticks, submissions, departures."""

    def __init__(self, batcher, bank: traffic.Bank, *, tracer=None,
                 seconds: float = 0.0, k1_patterns=(), probes: Optional[Probes] = None):
        self.batcher, self.bank = batcher, bank
        self.tracer = tracer
        self.probes = probes
        self.steps: Counter = Counter()
        self.records: Dict[str, ClipRecord] = {}
        self.order: List[ClipRecord] = []
        self.tick_walls: List[float] = []
        self.tick_base = batcher.tick_index
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
        _sync()
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
        return self.batcher.pending

    # -- traffic -----------------------------------------------------------

    def submit(self, clip: traffic.Clip, due: Optional[float] = None) -> ClipRecord:
        """Hand the clip to the batcher; ``due`` (host clock) defaults to now."""
        from repro_torch.serving import StreamRequest

        now = time.perf_counter()
        rec = ClipRecord(clip, now if due is None else due, now)
        if due is not None:
            self.late.append(now - due)
        self.records[clip.stream_id] = rec
        self.order.append(rec)
        if self.probes is not None:
            self.probes.choose(clip)
        request = StreamRequest(clip.stream_id, self.bank.clip(clip))
        if self.tracer is None:
            self.batcher.submit(request)
        else:  # the harness's own span around its call into the scheduler
            with self.tracer.span("submit", track=self.batcher.track):
                self.batcher.submit(request)
        return rec

    def tick(self) -> List[ClipRecord]:
        """One batcher tick; returns the clips that departed in it."""
        b = self.batcher
        if self.prof_at is not None and self.prof is None and self.t_close is None \
                and self.elapsed() >= self.prof_at:
            self._profile_start()
        self.tick_walls.append(time.perf_counter())
        out = b.tick()
        done = time.perf_counter()
        self.steps.update(out.keys())
        if self.probes is not None and self.probes.want:
            self.probes.see(out, self.steps)
        if self.t_close is None:
            n = len(out)
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
        if b.results:
            for r in b.results:
                rec = self.records[r.stream_id]
                rec.done, rec.result = done, r
                rec.steps = self.steps.pop(r.stream_id, 0)
                if self.probes is not None:
                    self.probes.want.pop(r.stream_id, None)
                departed.append(rec)
            b.results.clear()  # a long-running server drains what it has read
        return departed

    def close(self) -> None:
        """End the window: synchronise, stop the clock (and the profiler,
        whose stop costs time that the window does not see)."""
        _sync()
        self.t_close = time.perf_counter()
        self.window_s = self.t_close - self.t0
        if self.prof is not None:
            self.prof_bounds = (self._prof_t0, self.t_close)
            self.prof.stop()

    def drain(self, limit: float = DRAIN_S) -> None:
        """Serve what is in flight to its end (at most ``limit`` seconds)."""
        start = time.perf_counter()
        while self.batcher.pending and time.perf_counter() - start < limit:
            self.tick()
        _sync()

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
        _sync()
        self.prof = profile(activities=[act])
        self.prof.start()
        if on_card:
            self.prof_mark_ns = time.perf_counter_ns()
            marker.fill_(1.0)
        else:
            with record_function(devtrace.MARK):
                self.prof_mark_ns = time.perf_counter_ns()
        _sync()
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
                         ticks=self.ticks, step_ticks=self.step_ticks, clips=list(self.order),
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
        _sync()
    prof.events()


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- the system under test ---------------------------------------------------------

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


def check_graph(graph, cfg: Dict) -> None:
    """The program's graph has exactly the configuration's sizes."""
    want = {"input_hw": tuple(cfg["input_hw"]), "input_ch": cfg["input_ch"],
            "n_classes": cfg["n_classes"], "tcn_steps": cfg["tcn_steps"],
            "act_threshold": cfg["act_threshold"], "weight_nu": cfg["weight_nu"],
            "qat_per_channel": False}
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


def build_system(cfg: Dict, mix: Dict, params: Dict, calib, tracer=None):
    """The program's batcher: the registry net quantized from ``params`` and
    ``calib``, served from a captured pool on the ``fused`` backend."""
    from repro_torch.api.program import CutieProgram
    from repro_torch.api.registry import get_graph
    from repro_torch.serving import ActivityGate, ContinuousBatcher

    graph = get_graph(cfg["registry"])
    check_graph(graph, cfg)
    deployed = CutieProgram(graph).quantize(params, calib=calib)
    pool = deployed.serve(int(mix["pool"]), backend="fused")
    gate = ActivityGate(**mix["gate"]) if mix.get("gate") else None
    return ContinuousBatcher(pool, gate=gate, tracer=tracer)


def warm_up(batcher, bank: traffic.Bank, mix: Dict, seed: int) -> None:
    """``pool + 4`` clips of the mix, submitted at once, served to the end."""
    w = Window(batcher, bank)
    for clip in traffic.clips(mix, int(mix["pool"]) + 4, bank, seed, "warmup", prefix="w"):
        w.submit(clip)
    w.t0 = time.perf_counter()
    w.drain()


# -- one run ----------------------------------------------------------------------

def make_frames(cell: Cell, seed: int, dev):
    """The mix's frame bank and the calibration clips: the first
    ``calib_clips`` sequences' first ``tcn_steps`` frames, every one on."""
    import torch

    cfg = cell.config
    bank = traffic.make_bank(load_module("sources", cfg["frames"]), cfg, cell.traffic, seed, dev)
    n_cal = int(cfg["calib_clips"])
    calib = torch.from_numpy(bank.content[:n_cal, :cfg["tcn_steps"]].copy()).to(dev)
    return bank, calib


def set_up(cell: Cell, seed: int, dev, tracer=None):
    """Weights, calibration frames, the frame bank and the warmed-up batcher."""
    cfg, mix = cell.config, cell.traffic
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        _sync()
        parts[name], t = time.perf_counter() - t, time.perf_counter()

    params = make_params(cfg, seed, dev)
    lap("weights_s")
    bank, calib = make_frames(cell, seed, dev)
    lap("frames_s")
    batcher = build_system(cfg, mix, params, calib, tracer)
    lap("quantize_s")
    warm_up(batcher, bank, mix, seed)
    lap("warm_up_s")
    return params, calib, bank, batcher, parts


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: Optional[float] = None) -> Tuple[Dict, List[str]]:
    """Run ``cell`` once.  Returns the result object (the contract's last
    line) and the lines that state each compared number beside its limit."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    loop = load_module("loops", mix["loop"])

    tracer = None
    if trace:
        from repro_torch.obs import Tracer

        tracer = Tracer(capacity=TRACER_CAPACITY)
    t_entry = time.perf_counter()
    params, calib, bank, batcher, parts = set_up(cell, seed, dev, tracer)
    parts = {"start_s": t_entry - t_start, **parts}
    plan = loop.prepare(mix, seconds, bank, seed)
    if tracer is not None:
        _warm_profiler(dev)
        tracer.clear()
    gc.collect()
    gc.freeze()  # what set-up made is not rescanned by the window's collections
    probes = Probes(seed, cfg["tcn_steps"], cfg["n_classes"], dev)
    w = Window(batcher, bank, tracer=tracer, seconds=seconds,
               k1_patterns=cfg["kernels"]["k1"], probes=probes)
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
    probes.read(w.records)
    gate = mix.get("gate")
    answers = [check.Answer(bank.clip(r.clip), r.result.logits, r.steps, r.probes)
               for r in record.clips if r.result is not None]
    missing = sum(r.result is None for r in record.clips)
    late, w_close, by_second = w.late, w.t_close, w.frames_by_second
    del batcher, w, probes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counted = check.count(answers, gate)
    picked = check.sample([len(a.frames) for a in answers], [bool(a.probes) for a in answers],
                          seed)
    tables = cutie.derive(cfg, params, calib)
    numbers = check.compare(cfg, gate, tables, [answers[i] for i in picked], dev)
    numbers["frames_mismatch"] = float(counted["mismatch"])
    numbers["wrong"] = len(counted["wrong"] | {picked[i] for i in numbers["wrong"]})
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
        "stepping_ticks": record.step_ticks, "answered": len(answers), "compared": len(picked),
        "probes_compared": numbers["probes"],
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
