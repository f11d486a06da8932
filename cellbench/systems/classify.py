"""The ``classify`` system: a spatial CUTIE net served as a batch classifier,
as ``launch/serve.py --classify`` wires it.

``DeployedProgram.classify(batch, backend="fused")`` (``NULL_TRACER``
untraced, a ``repro_torch.obs.Tracer`` traced) over the registry's net,
checked against the configuration's sizes and quantized by the program from
the benchmark's float weights and calibration frames.  A clip of the mix is
a request for the logits of each of its frames (images); a tick takes the
queue's next ``batch`` images in submission order into one captured step,
and a request departs with its ``[frames, n_classes]`` logits once every
one of its images has them.  Its warm-up serves clips of the mix holding at
least one batch of images, submitted at once, to the end: the first tick
builds K1 and captures the step, the one shape every tick runs.

For the check the harness counts, from each tick's count of stepped images
alone, the images every request stepped: the count is laid over the queue
in submission order (what the classifier's FIFO does), and what lies past
the last queued image goes to the last request.  A padded row counted as
stepped, or an image stepped twice or never, shows as a request whose count
differs from its length.

The comparison (`compare`): every answered request's count of stepped
images and of answered rows against its length; and for a sample of the
answered requests, drawn from the seed and holding the longest one, every
image's logits against the plain reference's spatial classifier
(``reference/cutie.py``), which derives the deploy tables anew and serves
the images in blocks of ``BLOCK``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Sequence, Tuple

import numpy as np

from cellbench import bench, check, traffic
from cellbench.reference import cutie

BLOCK = 256  # images per reference call


class Classifier:
    """The classifier as the harness's `bench.Window` drives it."""

    def __init__(self, cell, params: Dict, calib, bank: traffic.Bank, device, tracer=None):
        from repro_torch.api.program import CutieProgram
        from repro_torch.api.registry import get_graph

        cfg = cell.config
        graph = get_graph(cfg["registry"])
        check.check_graph(graph, cfg)
        deployed = CutieProgram(graph).quantize(params, calib=calib)
        self.server = deployed.classify(int(cell.traffic["batch"]), backend="fused",
                                        tracer=tracer)
        self.mix, self.bank, self.tracer = cell.traffic, bank, tracer
        self.batch = self.server.batch
        self.order: Deque[List] = deque()   # queued: [id, length, images counted]
        self.stepped: Dict[str, int] = {}   # departed since `watch`: id -> images counted

    @property
    def pending(self) -> bool:
        return self.server.pending

    @property
    def tick_index(self) -> int:
        return self.server.tick_index

    def warm_up(self, seed: int) -> None:
        """Clips of the mix holding at least one batch, submitted at once,
        served to the end."""
        w = bench.Window(self)
        held = 0
        for clip in traffic.clips(self.mix, self.batch, self.bank, seed, "warmup", prefix="w"):
            w.submit(clip)
            held += clip.length
            if held >= self.batch:
                break
        w.open()
        w.drain()

    def watch(self, seed: int) -> None:
        self.stepped = {}

    def submit(self, clip: traffic.Clip) -> None:
        self.order.append([clip.stream_id, clip.length, 0])
        images = self.bank.clip(clip)
        if self.tracer is None:
            self.server.submit(clip.stream_id, images)
        else:  # the harness's own span around its call into the server
            with self.tracer.span("submit", track=self.server.track):
                self.server.submit(clip.stream_id, images)

    def tick(self) -> Tuple[float, int, List[Tuple[str, np.ndarray]]]:
        """One server tick: (host clock when its logits were on the host,
        images stepped, the departed requests' ``(id, logits)``)."""
        n, departed = self.server.tick()
        done = time.perf_counter()
        self._count(n)
        for sid, _ in departed:
            i = next(i for i, e in enumerate(self.order) if e[0] == sid)
            self.stepped[sid] = self.order[i][2]
            del self.order[i]
        return done, n, departed

    def _count(self, n: int) -> None:
        """Lay ``n`` stepped images over the queue in submission order."""
        for entry in self.order:
            if n == 0:
                return
            k = min(entry[1] - entry[2], n)
            entry[2] += k
            n -= k
        if n and self.order:
            self.order[-1][2] += n

    def answers(self, records: Sequence[bench.ClipRecord]) -> List[check.Answer]:
        """The answered requests of the window, in submission order."""
        return [check.Answer(self.bank.clip(r.clip), r.result, self.stepped.get(r.clip.stream_id, 0))
                for r in records if r.result is not None]


build = Classifier


# -- the comparison ------------------------------------------------------------------

def reference_logits(cfg: Dict, tables: Dict, images: np.ndarray, device,
                     precision: str = "fp32") -> np.ndarray:
    """The reference's logits of ``images`` ``[N, H, W, C]``, in blocks."""
    import torch

    out = [cutie.spatial(cfg, tables, torch.from_numpy(images[i:i + BLOCK]).to(device),
                         precision).cpu().numpy()
           for i in range(0, len(images), BLOCK)]
    return np.concatenate(out) if out else np.zeros((0, cfg["n_classes"]), np.float32)


def compare_logits(cfg: Dict, tables: Dict, answers: Sequence[check.Answer], device,
                   precision: str = "fp32") -> Tuple[float, set]:
    """``(logit_gap, wrong)`` of every image of ``answers`` against the
    reference served at ``precision``: the widest per-image gap, as a share
    of the image's largest reference logit, and the indices of the answers
    with an image past the configuration's limit, or without one row of
    logits per image (which ``frames_mismatch`` counts)."""
    have = [j for j, a in enumerate(answers)
            if a.logits is not None and len(a.logits) == len(a.frames)]
    wrong = set(range(len(answers))) - set(have)
    if not have:
        return 0.0, wrong
    images = np.concatenate([answers[j].frames for j in have])
    got = np.concatenate([answers[j].logits for j in have]).astype(np.float64)
    want = reference_logits(cfg, tables, images, device, precision).astype(np.float64)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-12)
    gaps = np.abs(got - want).max(axis=1) / scale
    ends = np.cumsum([len(answers[j].frames) for j in have])
    for j, g in zip(have, np.maximum.reduceat(gaps, np.concatenate([[0], ends[:-1]]))):
        if g > cfg["limits"]["logit_gap"]:
            wrong.add(j)
    return float(gaps.max()), wrong


def compare(cell, params: Dict, calib, answers: Sequence[check.Answer], seed: int,
            device) -> Tuple[Dict, Dict]:
    """``(numbers, info)``: ``logit_gap`` over every image of a sample of
    the answers, ``frames_mismatch`` over all of them (stepped images or
    answered rows other than the request's length), ``wrong`` the answers
    that fail either; ``info`` the sample's requests and images."""
    cfg = cell.config
    lengths = [len(a.frames) for a in answers]
    counted = check.count(answers, lengths)
    rows = {j for j, a in enumerate(answers)
            if a.logits is not None and len(a.logits) != len(a.frames)}
    picked = check.sample(lengths, [False] * len(answers), seed)
    tables = cutie.derive(cfg, params, calib)
    gap, wrong = compare_logits(cfg, tables, [answers[i] for i in picked], device)
    mismatched = counted["wrong"] | rows
    numbers = {"logit_gap": gap, "frames_mismatch": float(len(mismatched)),
               "wrong": len(mismatched | {picked[i] for i in wrong})}
    return numbers, {"compared": len(picked), "images_compared": sum(lengths[i] for i in picked)}


def control(cell, params: Dict, calib, bank: traffic.Bank, seed: int, device,
            n: int = 256) -> Dict:
    """The control's numbers: ``n`` requests of the cell's mix served by the
    reference in bfloat16 in the program's place, read by the run's own
    comparison against the float32 reference."""
    cfg = cell.config
    tables = cutie.derive(cfg, params, calib)
    frames = [bank.clip(c) for c in traffic.clips(cell.traffic, n, bank, seed, "control")]
    served = reference_logits(cfg, tables, np.concatenate(frames), device, precision="bf16")
    ends = np.cumsum([len(f) for f in frames])
    answers = [check.Answer(f, logits, len(f))
               for f, logits in zip(frames, np.split(served, ends[:-1]))]
    numbers, _ = compare(cell, params, calib, answers, seed, device)
    numbers["missing"] = 0.0
    return numbers
