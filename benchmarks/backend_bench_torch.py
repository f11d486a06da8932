"""Backend benchmark of the PyTorch/CUDA port: fused/kernel/ref/bitsim across
registry nets, on the card by default.

Counterpart of ``benchmarks/backend_bench.py`` with its cells, flags and
JSON row schema, plus a ``captured`` column.  For every (net, workload,
batch, backend) cell it

  * times the whole-network forward (median of ``--repeats`` host-clock
    samples, each ending in a synchronise, after a warm-up call): where the
    reference jits the forward, here it is a `repro_torch.capture.CapturedStep`
    — on the card the first call runs eagerly and captures a CUDA graph,
    later calls copy the input in and replay it; on the CPU it runs
    eagerly (``captured`` says which),
  * checks the logits against the ``ref`` oracle (``ref``'s eager warm-up
    output): both the warm-up's output and the last timed call's — on the
    card a graph replay — must be **bit-equal** for every backend (the
    port's contract, stricter than the reference's allclose for its float
    Pallas backends; on ``ref`` itself it holds the replay to the eager
    forward), and the bench exits non-zero on any disagreement.

Workloads: spatial nets run one ``forward`` cell; temporal nets run both the
per-frame CNN ``spatial`` frontend (the serving hot path) and the full-clip
``forward``.  Inputs come from ``--seed`` through `numpy.random.default_rng`
(ternary images, sparse event clips), weights from a seeded
`torch.Generator`.

    python3 benchmarks/backend_bench_torch.py                  # full nets -> BENCH_backends_torch.json
    python3 benchmarks/backend_bench_torch.py --smoke          # smoke nets -> BENCH_backends_torch.smoke.json
    python3 benchmarks/backend_bench_torch.py --smoke --device cpu --out /tmp/b.json

Gate it with ``python3 scripts/check_bench_regression.py BASE FRESH``.
Exit codes: 0 ok, 1 a backend disagrees with ``ref``.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.capture import CapturedStep  # noqa: E402
from repro_torch.device import device_meta, resolve_device  # noqa: E402

FULL_NETS = ("cifar10_tnn", "dvs_cnn_tcn")
SMOKE_NETS = ("cifar10_tnn_smoke", "dvs_cnn_tcn_smoke")


def _inputs(graph, batch: int, frames: int, rng: np.random.Generator) -> np.ndarray:
    """Ternary-valued spatial batch / sparse event clip, like the real data."""
    if graph.is_temporal:
        shape = (batch, frames, *graph.input_hw, graph.input_ch)
        return (rng.random(shape) < 0.05).astype(np.float32)
    shape = (batch, *graph.input_hw, graph.input_ch)
    return np.sign(rng.standard_normal(shape)).astype(np.float32)


def _time(fn, x: torch.Tensor, repeats: int, dev: torch.device):
    """(median seconds, [warm-up output, last timed output]).  On the card
    the warm-up runs eagerly and captures, and the timed calls replay: the
    agreement check reads both, so the path that is timed is the path that
    is gated."""
    outs = [fn(x)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = fn(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), outs + [last]


def _agreement(outs, ref: np.ndarray) -> dict:
    """The worst agreement of ``outs`` with the oracle ``ref``."""
    diffs = [np.abs(o.astype(np.float64) - ref.astype(np.float64)) for o in outs]
    return {
        "max_abs_diff_vs_ref": max(float(np.max(d)) for d in diffs),
        "exact_vs_ref": all(bool((o == ref).all()) for o in outs),
        "allclose_vs_ref": all(np.allclose(o, ref, rtol=1e-4, atol=1e-4) for o in outs),
    }


def bench_cell(deployed, workload: str, x: torch.Tensor, backends, repeats: int,
               dev: torch.device):
    """One (net, workload, batch) cell: every backend vs the ref oracle."""
    fwd = deployed.spatial_forward if workload == "spatial" else deployed.forward
    steps = {b: CapturedStep(functools.partial(fwd, backend=b), dev, inputs=(0,))
             for b in backends}
    timed = {b: _time(steps[b], x, repeats, dev) for b in backends}
    ref_out = timed["ref"][1][0].cpu().numpy()  # ref's eager forward
    rows = []
    for b in backends:
        wall, outs = timed[b]
        row = {"backend": b, "wall_ms": wall * 1e3}
        row.update(_agreement([o.cpu().numpy() for o in outs], ref_out))
        row["captured"] = steps[b].captured
        rows.append(row)
    ref_ms = next(r["wall_ms"] for r in rows if r["backend"] == "ref")
    for r in rows:
        r["speedup_vs_ref"] = ref_ms / r["wall_ms"] if r["wall_ms"] else float("nan")
    return rows


def check_row(row: dict, net: str, workload: str, batch: int) -> list:
    """The gate: every backend's warm-up and timed outputs bit-equal to ref's
    eager forward."""
    if row["exact_vs_ref"]:
        return []
    return [f"{net}/{workload}/batch{batch}/{row['backend']}: logits differ from "
            f"ref's eager forward (max_abs_diff={row['max_abs_diff_vs_ref']:.3e})"]


def run(args) -> int:
    dev = resolve_device(args.device)
    nets = args.nets or (SMOKE_NETS if args.smoke else FULL_NETS)
    batches = args.batches or ([2] if args.smoke else [1, 4])
    frames = args.frames or (4 if args.smoke else 5)
    repeats = args.repeats or (2 if args.smoke else 3)
    backends = args.backends or list(api.BACKENDS)
    if "ref" not in backends:
        backends = ["ref", *backends]

    results, failures = [], []
    for net_idx, net in enumerate(nets):
        prog = api.get_net(net)
        g = prog.graph
        rng = np.random.default_rng([args.seed, net_idx])
        params = prog.init(torch.Generator().manual_seed(args.seed), device=dev)
        calib = torch.from_numpy(_inputs(g, max(batches), frames, rng)).to(dev)
        deployed = prog.quantize(params, calib=calib)
        workloads = ["spatial", "forward"] if g.is_temporal else ["forward"]
        for workload in workloads:
            for batch in batches:
                x = _inputs(g, batch, frames, rng)
                if workload == "spatial":
                    x = np.ascontiguousarray(x[:, 0])
                with torch.no_grad():
                    rows = bench_cell(deployed, workload, torch.from_numpy(x).to(dev),
                                      backends, repeats, dev)
                for row in rows:
                    failures += check_row(row, net, workload, batch)
                    results.append({"net": net, "workload": workload,
                                    "batch": batch, **row})
                    print(f"[bench] {net:>18s} {workload:>8s} b{batch} "
                          f"{row['backend']:>9s}: {row['wall_ms']:9.3f} ms  "
                          f"x{row['speedup_vs_ref']:.2f} vs ref  "
                          f"exact={row['exact_vs_ref']} captured={row['captured']}",
                          flush=True)

    payload = {
        "schema": 1,
        "meta": {
            "smoke": bool(args.smoke),
            "device": device_meta(dev),
            "torch_version": torch.__version__,
            "repeats": repeats,
            "frames": frames,
            "generated_unix": int(time.time()),
            "note": ("wall_ms: host clock around one forward call ending in a "
                     "synchronise, median over repeats after a warm-up call.  On "
                     "the card each forward is a CapturedStep (captured: true — the "
                     "warm-up runs eagerly and captures, each timed call is one "
                     "input copy and one CUDA-graph replay); on the CPU it runs "
                     "eagerly and fused/kernel take the kernels' plain versions.  "
                     "Every backend's warm-up output and its last timed output "
                     "(a replay on the card) are gated bit-equal to ref's eager "
                     "forward; max_abs_diff_vs_ref is the worse of the two."),
        },
        "results": results,
    }
    default_name = ("BENCH_backends_torch.smoke.json" if args.smoke
                    else "BENCH_backends_torch.json")
    out = Path(args.out) if args.out else REPO_ROOT / default_name
    out.write_text(json.dumps(payload, indent=2) + "\n")
    print(f"[bench] wrote {out} ({len(results)} cells)", flush=True)
    if failures:
        for f in failures:
            print(f"[bench] FAIL {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="smoke registry nets, one batch size")
    ap.add_argument("--nets", nargs="*", default=None)
    ap.add_argument("--backends", nargs="*", default=None,
                    choices=list(api.BACKENDS))
    ap.add_argument("--batches", nargs="*", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="clip length for temporal nets")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: <repo>/BENCH_backends_torch.json)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
