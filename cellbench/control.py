#!/usr/bin/env python3
"""The control of ``correct``: the plain reference served in bfloat16, put in
the program's place, read by the same comparison as a run.

    python3 cellbench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

For each seed it makes what a run makes (weights, calibration frames, the
frame bank), and the configuration's system (``systems/<system>.py``, its
``control``) serves 256 of the cell's clips — for ``stream_pool`` at their
last frame and at two probed frames, as a run compares them — with the
reference in the precision below the configuration's float32
(``reference/cutie.py``, ``precision="bf16"``: the scale multiply, the
threshold, the pooled mean and the classifier's scale), and prints the
numbers a run compares against the float32 reference, beside the
configuration's limits.  The control has to come out not correct on every
seed.  No window is needed: the comparison reads answers, and the control's
answers do not depend on timing.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device, n: int = 256):
    """The control's numbers for ``cell`` at ``seed`` (no program involved)."""
    import torch

    from cellbench import bench, check
    from cellbench.spec import load_module

    cfg = cell.config
    dev = torch.device(device)
    params = bench.make_params(cfg, seed, dev)
    bank, calib = bench.make_frames(cell, seed, dev)
    numbers = load_module("systems", cfg["system"]).control(
        cell, params, calib, bank, seed, dev, n)
    return check.judge(numbers, cfg["limits"])


def main(argv=None) -> int:
    from cellbench import guard

    guard.prepare_environment(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT / "src"))
    from cellbench import check
    from cellbench.spec import Spec

    cell = Spec.load(ROOT).cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_correct": check.passed(checks), "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the harness as the package `cellbench`, nothing shadowed
    sys.exit(main())
