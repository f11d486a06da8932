"""A spatial CUTIE net served as a batch classifier: a system that a test adds
to a copy of the harness by new files alone (`systems/fixture_batch.py`).

A clip is a request for the logits of each of its frames (images).  A tick
takes the queue's next ``batch`` images, in submission order, into a batch
made in set-up (zeros where fewer wait), runs ``DeployedProgram.forward(x,
backend="fused")`` and copies the logits to the host; a clip departs with its
``[frames, n_classes]`` logits once every one of its images has them.  The
check serves each image of a sample of the answered clips with the plain
reference's spatial classifier.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cellbench import bench, check, traffic
from cellbench.reference import cutie


class BatchClassifier:
    def __init__(self, cell, params: Dict, calib, bank: traffic.Bank, device, tracer=None):
        import torch
        from repro_torch.api.program import CutieProgram
        from repro_torch.api.registry import get_graph

        cfg = cell.config
        graph = get_graph(cfg["registry"])
        check.check_graph(graph, cfg)
        self.deployed = CutieProgram(graph).quantize(params, calib=calib)
        self.bank = bank
        self.batch = int(cell.traffic["batch"])
        self.x = torch.zeros((self.batch, *cfg["input_hw"], cfg["input_ch"]), device=device)
        self.queue: deque = deque()   # [clip id, frames, images taken]
        self.rows: Dict[str, List[np.ndarray]] = {}
        self.tick_index = 0

    @property
    def pending(self) -> bool:
        return bool(self.queue)

    def warm_up(self, seed: int) -> None:
        """The one shape a tick runs."""
        self.deployed.forward(self.x, backend="fused")
        bench.sync()

    def watch(self, seed: int) -> None:
        pass

    def submit(self, clip: traffic.Clip) -> None:
        self.queue.append([clip.stream_id, self.bank.clip(clip), 0])
        self.rows[clip.stream_id] = []

    def tick(self) -> Tuple[float, int, List[Tuple[str, np.ndarray]]]:
        import torch

        self.tick_index += 1
        taken, n = [], 0
        for entry in self.queue:
            if n == self.batch:
                break
            sid, frames, at = entry
            k = min(len(frames) - at, self.batch - n)
            self.x[n:n + k].copy_(torch.from_numpy(frames[at:at + k]))
            entry[2] += k
            taken.append((sid, n, k))
            n += k
        self.x[n:].zero_()
        logits = self.deployed.forward(self.x, backend="fused").cpu().numpy()
        done = time.perf_counter()
        for sid, row, k in taken:
            self.rows[sid].extend(logits[row:row + k])
        departed = []
        while self.queue and self.queue[0][2] == len(self.queue[0][1]):
            sid = self.queue.popleft()[0]
            departed.append((sid, np.stack(self.rows.pop(sid))))
        return done, n, departed

    def answers(self, records: Sequence[bench.ClipRecord]) -> List[check.Answer]:
        return [check.Answer(self.bank.clip(r.clip), r.result, len(r.result))
                for r in records if r.result is not None]


build = BatchClassifier


def compare(cell, params: Dict, calib, answers: Sequence[check.Answer], seed: int,
            device) -> Tuple[Dict, Dict]:
    """Every image of a sample of the answers against the reference."""
    import torch

    cfg = cell.config
    counted = check.count(answers, [len(a.frames) for a in answers])
    picked = check.sample([len(a.frames) for a in answers], [False] * len(answers), seed)
    tables = cutie.derive(cfg, params, calib)
    gap, wrong = 0.0, set()
    for i in picked:
        a = answers[i]
        want = cutie.spatial(cfg, tables, torch.from_numpy(a.frames).to(device)).cpu().numpy()
        g = max(check.logit_gap(got, w) for got, w in zip(a.logits, want))
        if g > cfg["limits"]["logit_gap"]:
            wrong.add(i)
        gap = max(gap, g)
    numbers = {"logit_gap": gap, "frames_mismatch": float(counted["mismatch"]),
               "wrong": len(counted["wrong"] | wrong)}
    return numbers, {"compared": len(picked)}


def control(cell, params: Dict, calib, bank: traffic.Bank, seed: int, device,
            n: int = 256) -> Dict:
    """``n`` clips served by the reference in bfloat16 in the program's place."""
    import torch

    tables = cutie.derive(cell.config, params, calib)
    answers = []
    for c in traffic.clips(cell.traffic, n, bank, seed, "control"):
        f = bank.clip(c)
        logits = cutie.spatial(cell.config, tables, torch.from_numpy(f).to(device), "bf16")
        answers.append(check.Answer(f, logits.cpu().numpy(), len(f)))
    numbers, _ = compare(cell, params, calib, answers, seed, device)
    numbers["missing"] = 0.0
    return numbers
