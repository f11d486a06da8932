#!/usr/bin/env python3
"""Find an open-loop cell's knee: one process, one set-up, a window per rate.

    python3 cellbench/sweep.py --workload <open cell> --rates 100,200,300 [--seconds 8] [--seed 1]

For each offered rate (clips per second) it runs the cell's loop at that rate
through the harness's own window and prints one JSON line: clips due and
answered, the cell's end-to-end metrics read by their own readers
(``metrics/<name>.py``, as a run reads them), and the backlog (clips due and
not yet answered) at each second of the window.  The knee is the highest rate whose backlog
does not grow over the window; a cell runs at about 4/5 of it.  The rate a
cell uses is written into its mix file by hand: runs never search for one.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from cellbench import guard  # noqa: E402


def backlog(records, t: float) -> int:
    return sum(r.due <= t and (r.done is None or r.done > t) for r in records)


def main(argv=None) -> int:
    guard.prepare_environment(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from cellbench.bench import Window, read_metrics, set_up
    from cellbench.spec import Spec, load_module

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 3
    cell = Spec.load(ROOT).cell(args.workload)
    loop = load_module("loops", cell.traffic["loop"])
    dev = torch.device("cuda")
    _, _, bank, system, _ = set_up(cell, args.seed, dev)
    setup_s = time.perf_counter() - T_START
    print(json.dumps({"workload": cell.name, "setup_s": setup_s,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, rate_per_s=rate)
        plan = loop.prepare(mix, args.seconds, bank, args.seed)
        w = Window(system)
        gc.collect()
        gc.freeze()
        w.open()
        loop.drive(w, plan, mix, args.seconds)
        record = w.record(cell, setup_s)
        print(json.dumps({
            "rate_per_s": rate, "due": len(record.clips),
            "answered": sum(r.done is not None for r in record.clips),
            "metrics": read_metrics(record, cell.end_to_end),
            "backlog_by_second": [backlog(record.clips, w.t0 + k + 1)
                                  for k in range(int(args.seconds))],
            "backlog_close": backlog(record.clips, w.t_close),
            "stepping_ticks": w.step_ticks, "ticks": w.ticks,
            "late_ms_max": max(w.late, default=0.0) * 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
