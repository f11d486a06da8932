"""The ``stream_pool`` system: the port's serving stack as ``launch/serve.py`` wires it.

``ContinuousBatcher`` (no feeder; an ``ActivityGate`` where the mix has one;
``NULL_TRACER`` untraced, a ``repro_torch.obs.Tracer`` traced) over the
``SessionPool`` that ``DeployedProgram.serve(pool, backend="fused")`` builds,
whose step is captured once as a CUDA graph and replayed every tick.  The
program is the registry's net, checked against the configuration's sizes,
quantized by the program from the benchmark's float weights and calibration
frames.  Its warm-up serves ``pool + 4`` clips of the mix, submitted at once,
to the end: the first tick builds K1 and captures the step, and admission,
eviction, departures and the gate's park and wake each run once.

For the check the window counts, from the keys of each tick's output, the
frames every clip stepped, and for one clip in ``PROBE_EVERY`` (chosen from
the seed and the clip's id) keeps the logits of two of its frames — one
within its first ``tcn_steps``, whose window holds zero history, and one
anywhere in the clip — copied on the device into a buffer made in set-up.

The comparison (`compare`): every answered clip's count of stepped frames
against the reference's (every frame without a gate, the gate's plan with
one); and for a sample of the answered clips, drawn from the seed among the
probed ones and holding the longest clip, the program's logits against the
plain reference's (``reference/cutie.py``), which derives the deploy
tables anew, replays the gate's plan where the cell has a gate, and runs the
frames of each compared step's window (the newest ``tcn_steps`` stepped
frames up to it, zero history before) through the frontend and the TCN head,
in blocks.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cellbench import bench, check, traffic
from cellbench.reference import cutie

PROBE_EVERY = 4     # one clip in four keeps the logits of two of its frames
PROBE_ROWS = 1 << 15
BLOCK = 256  # frames (or windows) per reference call


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

    def read(self) -> Dict[str, List[Tuple[int, np.ndarray]]]:
        """After the window: each probed clip's ``[(step, logits)]`` on the host."""
        host = self.buf[:self.used].cpu().numpy()
        return {sid: [(step, host[row]) for step, row in kept] for sid, kept in self.kept.items()}


class StreamPool:
    """The batcher as the harness's `bench.Window` drives it."""

    def __init__(self, cell, params: Dict, calib, bank: traffic.Bank, device, tracer=None):
        from repro_torch.api.program import CutieProgram
        from repro_torch.api.registry import get_graph
        from repro_torch.serving import ActivityGate, ContinuousBatcher

        cfg, mix = cell.config, cell.traffic
        graph = get_graph(cfg["registry"])
        check.check_graph(graph, cfg)
        deployed = CutieProgram(graph).quantize(params, calib=calib)
        pool = deployed.serve(int(mix["pool"]), backend="fused")
        gate = ActivityGate(**mix["gate"]) if mix.get("gate") else None
        self.batcher = ContinuousBatcher(pool, gate=gate, tracer=tracer)
        self.cfg, self.mix, self.bank, self.device, self.tracer = cfg, mix, bank, device, tracer
        self.batch = int(mix["pool"])
        self.probes: Optional[Probes] = None
        self.steps: Counter = Counter()       # in flight: id -> frames stepped
        self.stepped: Dict[str, int] = {}     # departed since `watch`: id -> frames stepped

    @property
    def pending(self) -> bool:
        return self.batcher.pending

    @property
    def tick_index(self) -> int:
        return self.batcher.tick_index

    def _request(self, clip: traffic.Clip):
        from repro_torch.serving import StreamRequest

        return StreamRequest(clip.stream_id, self.bank.clip(clip))

    def warm_up(self, seed: int) -> None:
        """``pool + 4`` clips of the mix, submitted at once, served to the end."""
        w = bench.Window(self)
        for clip in traffic.clips(self.mix, self.batch + 4, self.bank, seed, "warmup",
                                  prefix="w"):
            w.submit(clip)
        w.open()
        w.drain()

    def watch(self, seed: int) -> None:
        """From here on keep what the check reads: the probes' buffer is made now."""
        self.probes = Probes(seed, self.cfg["tcn_steps"], self.cfg["n_classes"], self.device)
        self.stepped = {}

    def submit(self, clip: traffic.Clip) -> None:
        if self.probes is not None:
            self.probes.choose(clip)
        request = self._request(clip)
        if self.tracer is None:
            self.batcher.submit(request)
        else:  # the harness's own span around its call into the scheduler
            with self.tracer.span("submit", track=self.batcher.track):
                self.batcher.submit(request)

    def tick(self) -> Tuple[float, int, List[Tuple[str, object]]]:
        """One batcher tick: (host clock when its outputs were on hand,
        frames stepped, the departed clips' ``(id, StreamResult)``)."""
        b = self.batcher
        out = b.tick()
        done = time.perf_counter()
        self.steps.update(out.keys())
        if self.probes is not None and self.probes.want:
            self.probes.see(out, self.steps)
        departed = []
        if b.results:
            for r in b.results:
                self.stepped[r.stream_id] = self.steps.pop(r.stream_id, 0)
                if self.probes is not None:
                    self.probes.want.pop(r.stream_id, None)
                departed.append((r.stream_id, r))
            b.results.clear()  # a long-running server drains what it has read
        return done, len(out), departed

    def answers(self, records: Sequence[bench.ClipRecord]) -> List[check.Answer]:
        """The answered clips of the window, in submission order, with their probes."""
        probed = self.probes.read() if self.probes is not None else {}
        out = []
        for r in records:
            if r.result is not None:
                sid = r.clip.stream_id
                out.append(check.Answer(self.bank.clip(r.clip), r.result.logits,
                                        self.stepped.get(sid, 0), probed.get(sid, [])))
        return out


build = StreamPool


# -- the comparison ------------------------------------------------------------------

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


def windows(a: check.Answer, kept: List[int],
            steps: int) -> List[Tuple[Optional[np.ndarray], np.ndarray]]:
    """The answer's compared steps — its last and its probes — as
    ``(program's logits, the window of frames the reference serves)``."""
    out = []
    for s, logits in [(len(kept) - 1, a.logits)] + list(a.probes):
        if 0 <= s < len(kept):
            out.append((logits, a.frames[kept[max(0, s + 1 - steps):s + 1]]))
    return out


def compare_logits(cfg: Dict, gate: Optional[Dict], tables: Dict,
                   answers: Sequence[check.Answer], device, precision: str = "fp32") -> Dict:
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
        g = check.logit_gap(got, w)
        if g > cfg["limits"]["logit_gap"]:
            wrong.add(j)
        gap = max(gap, g)
    return {"logit_gap": gap, "wrong": wrong, "probes": len(pairs) - lasts}


def compare(cell, params: Dict, calib, answers: Sequence[check.Answer], seed: int,
            device) -> Tuple[Dict, Dict]:
    """``(numbers, info)``: ``logit_gap`` over a sample of the answers,
    ``frames_mismatch`` over all of them, ``wrong`` the answers that fail
    either; ``info`` the sample's size and its probed steps."""
    cfg, gate = cell.config, cell.traffic.get("gate")
    counted = check.count(answers, [len(stepped(a.frames, gate)) for a in answers])
    picked = check.sample([len(a.frames) for a in answers], [bool(a.probes) for a in answers],
                          seed)
    tables = cutie.derive(cfg, params, calib)
    numbers = compare_logits(cfg, gate, tables, [answers[i] for i in picked], device)
    numbers["frames_mismatch"] = float(counted["mismatch"])
    numbers["wrong"] = len(counted["wrong"] | {picked[i] for i in numbers["wrong"]})
    info = {"compared": len(picked), "probes_compared": numbers.pop("probes")}
    return numbers, info


def control(cell, params: Dict, calib, bank: traffic.Bank, seed: int, device,
            n: int = 256) -> Dict:
    """The control's numbers: ``n`` clips of the cell's mix served by the
    reference in bfloat16 in the program's place — at their last frame and
    at two probed frames, as a run compares them — read by the run's own
    comparison against the float32 reference."""
    cfg, mix = cell.config, cell.traffic
    tables = cutie.derive(cfg, params, calib)
    gate = mix.get("gate")
    answers, frames, owners = [], [], []
    for c in traffic.clips(mix, n, bank, seed, "control"):
        f = bank.clip(c)
        a = check.Answer(f, None, 0)
        kept = stepped(f, gate)
        a.steps = len(kept)
        # the steps a run compares: the last, an early one and one further in
        a.probes = [(s, None) for s in sorted({min(3, len(kept) - 1), len(kept) // 2})
                    ] if kept else []
        for k, (_, w) in enumerate(windows(a, kept, cfg["tcn_steps"])):
            frames.append(w)
            owners.append((a, k))
        answers.append(a)
    served = reference_logits(cfg, tables, frames, device, precision="bf16")
    for (a, k), logits in zip(owners, served):
        if k == 0:
            a.logits = logits
        else:
            a.probes[k - 1] = (a.probes[k - 1][0], logits)
    numbers = compare_logits(cfg, gate, tables, answers, device)
    numbers["frames_mismatch"] = float(
        check.count(answers, [len(stepped(a.frames, gate)) for a in answers])["mismatch"])
    numbers["missing"] = 0.0
    return numbers
