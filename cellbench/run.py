#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; ``checks`` last, each compared number beside its
limit, as the last lines of standard error too.  Exits non-zero, printing no
result, without a CUDA card, outside a checkout of the repository (the port
under ``src/``), or when a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # the harness as the package `cellbench`, nothing shadowed

from cellbench import guard  # noqa: E402


def main(argv=None) -> int:
    guard.prepare_environment(ROOT)  # before torch is imported
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cellbench.spec import Spec

    try:
        cell = Spec.load(ROOT).cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cellbench: {e}", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"cellbench: no port under {src}: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(1, str(src))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cellbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import repro_torch

    if Path(repro_torch.__file__).resolve().parent != src / "repro_torch":
        print(f"cellbench: repro_torch comes from {repro_torch.__file__}, not {src}",
              file=sys.stderr)
        return 2

    from cellbench.bench import run_cell

    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_start=T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"cellbench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
