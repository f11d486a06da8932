"""CLI for saved traces: ``python -m repro_torch.obs {summarize,export,diff}``.
Counterpart of ``python -m repro.obs``; the documents of both packages are
interchangeable.

``summarize`` is the CI ``obs-smoke`` gate: it prints the structural
digest of a trace (event counts, lanes, tick-phase table, nesting check)
and exits non-zero when the trace is empty or any span overlaps its
enclosing span improperly — either means the instrumentation lost a
boundary and the trace cannot be trusted.

``export`` re-emits a trace (optionally appending sim layer-timeline
tracks for named registry nets); ``diff`` compares two traces
structurally — two runs of the same deterministic scenario must have the
same shape even though wall times differ.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import export as obs_export


def _print_phase_table(breakdown: dict, out=sys.stdout) -> None:
    if not breakdown:
        print("  (no tick spans)", file=out)
        return
    phases = (*obs_export.TICK_PHASES, "other")
    header = f"  {'lane':<24} {'ticks':>5} " + " ".join(
        f"{p:>10}" for p in phases)
    print(header, file=out)
    for lane, row in breakdown.items():
        cells = " ".join(
            f"{row['phases'][p]['fraction'] * 100:>9.1f}%" for p in phases)
        print(f"  {lane:<24} {row['ticks']:>5} {cells}", file=out)


def cmd_summarize(args: argparse.Namespace) -> int:
    doc = obs_export.load(args.trace)
    s = obs_export.trace_summary(doc)
    print(f"{args.trace}: {s['events']} events "
          f"({s['by_phase'].get('X', 0)} spans, "
          f"{s['by_phase'].get('i', 0)} instants, "
          f"{s['by_phase'].get('C', 0)} counter samples), "
          f"{s['dropped_events']} dropped")
    print(f"lanes: {', '.join(s['lanes']) or '(none)'}")
    if s["spans"]:
        print("spans: " + ", ".join(f"{k}x{v}" for k, v in s["spans"].items()))
    if s["instants"]:
        print("instants: " +
              ", ".join(f"{k}x{v}" for k, v in s["instants"].items()))
    print("tick phase breakdown (fraction of tick time):")
    _print_phase_table(s["phase_breakdown"])
    if args.json:
        print(json.dumps(s, indent=2))
    if not s["ok"]:
        if s["events"] == 0:
            print("FAIL: empty trace", file=sys.stderr)
        for p in s["nesting_problems"]:
            print(f"FAIL: unbalanced span: {p}", file=sys.stderr)
        return 1
    print("ok: spans balanced, trace non-empty")
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    doc = obs_export.load(args.trace)
    if args.net:
        import torch

        from repro_torch.api import get_net

        for i, name in enumerate(args.net):
            prog = get_net(name)
            program = prog.quantize(prog.init(torch.Generator().manual_seed(0),
                                              device=args.device))
            doc["traceEvents"].extend(obs_export.layer_timeline(
                program, name=name, pid=obs_export.SIM_PID + 50 + i))
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(f"wrote {args.out} ({len(doc['traceEvents'])} events)")
    return 0


def cmd_diff(args: argparse.Namespace) -> int:
    a = obs_export.load(args.trace_a)
    b = obs_export.load(args.trace_b)
    d = obs_export.trace_diff(a, b)
    print(json.dumps(d, indent=2))
    if d["identical_shape"]:
        print("identical shape")
        return 0
    return 1 if args.strict else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize, export, or diff saved serving/train traces.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize",
                       help="structural digest; non-zero exit on empty "
                            "trace or unbalanced spans (the CI gate)")
    p.add_argument("trace", help="Chrome trace JSON from --trace PATH")
    p.add_argument("--json", action="store_true",
                   help="also print the full digest as JSON")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("export",
                       help="re-emit a trace, optionally appending sim "
                            "layer timelines for registry nets")
    p.add_argument("trace")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--net", action="append", default=[],
                   help="registry net whose sim layer timeline to append "
                        "(repeatable)")
    p.add_argument("--device", default="cuda",
                   help="where --net programs are quantized: cuda (default; an "
                        "error without a CUDA device) or cpu")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("diff", help="structural comparison of two traces")
    p.add_argument("trace_a")
    p.add_argument("trace_b")
    p.add_argument("--strict", action="store_true",
                   help="non-zero exit when shapes differ")
    p.set_defaults(fn=cmd_diff)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
