"""QAT training benchmark of the PyTorch/CUDA port: loss curves + the
float->ternary gap, per net, on the card by default.

Counterpart of ``benchmarks/train_bench.py`` with the same flags, gate and
JSON row schema.  For every requested registry net it runs the port's real
`repro_torch.train.train` loop (STE QAT, checkpoints, schedules) and
records

  * the full loss curve (decimated to <= ``--curve-points`` samples),
  * wall-clock per step (host clock; each step waits for its loss),
  * final QAT accuracy, deployed accuracy on ``--backend`` (default fused —
    the fused ternary conv kernel on the card) and their gap,

then gates what the train-smoke recipe promises: the loss must decrease
(first-quarter mean vs last-quarter mean) and |gap| must stay within
``--gap-bound``.  Exit codes: 0 ok, 1 gate failure.

    python3 benchmarks/train_bench_torch.py --smoke                # smoke nets
    python3 benchmarks/train_bench_torch.py --nets cifar10_tnn --steps 2000
    python3 benchmarks/train_bench_torch.py --smoke --device cpu   # plain path

The JSON payload goes to stdout, and to ``--out`` when given; no
``BENCH_*.json`` is written by default.  Every payload names the device it
ran on.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import SMOKE_GAP_BOUND, smoke_recipe  # noqa: E402
from repro_torch.train import train  # noqa: E402

SMOKE_NETS = ("cifar10_tnn_smoke", "dvs_cnn_tcn_smoke")
FULL_NETS = ("cifar10_tnn", "dvs_cnn_tcn")


def decimate(curve, n_points: int):
    """<= n_points samples of the loss curve, endpoints always kept."""
    if len(curve) <= n_points:
        return list(curve)
    idx = [round(i * (len(curve) - 1) / (n_points - 1)) for i in range(n_points)]
    return [curve[i] for i in idx]


def bench_net(net: str, args):
    """One net through the real train loop -> (gate failure lines, JSON row)."""
    # --smoke uses THE per-net recipe from launch/train.py, so this gate and
    # `python -m repro_torch.launch.train --net X --smoke` run identical
    # hyperparameters and cannot drift
    temporal = "dvs" in net
    recipe = smoke_recipe(net) if args.smoke else {}
    steps = args.steps or recipe.get("steps", 1000)
    batch = args.batch or recipe.get("batch", 8 if temporal else 32)
    lr = args.lr if args.lr is not None else recipe.get("lr", 3e-3)
    ckpt_dir = Path(args.ckpt_root) / net
    shutil.rmtree(ckpt_dir, ignore_errors=True)  # never resume a stale run
    report = train(
        net,
        steps=steps,
        batch=batch,
        lr=lr,
        seed=args.seed,
        ckpt_dir=ckpt_dir,
        ckpt_every=max(steps // 4, 1),
        nu_schedule=args.nu_schedule,
        thresholds=args.thresholds,
        backend=args.backend,
        eval_batches=args.eval_batches,
        device=args.device,
    )
    e = report.final_eval
    n = len(report.losses)
    q = max(n // 4, 1)
    return report.gate(args.gap_bound), {
        "net": net,
        "steps": n,
        "batch": batch,
        "lr": lr,
        "thresholds": args.thresholds,
        "nu_schedule": args.nu_schedule,
        "nu_final": report.nu_final,
        "backend": e.backend,
        "ms_per_step": report.ms_per_step,
        "loss_first": report.losses[0],
        "loss_last": report.losses[-1],
        "loss_first_quarter_mean": sum(report.losses[:q]) / q,
        "loss_last_quarter_mean": sum(report.losses[-q:]) / q,
        "loss_decreased": report.loss_decreased,
        "loss_curve": decimate(report.losses, args.curve_points),
        "qat_accuracy": e.qat_accuracy,
        "deployed_accuracy": e.deployed_accuracy,
        "qat_deployed_gap": e.gap,
        "restarts": report.restarts,
    }


def run(args) -> int:
    dev = resolve_device(args.device)
    nets = args.nets or (SMOKE_NETS if args.smoke else FULL_NETS)
    results, failures = [], []
    for net in nets:
        net_failures, row = bench_net(net, args)  # TrainReport.gate — the
        failures += net_failures                  # same gate the CLI runs
        results.append(row)
        print(f"[train-bench] {net:>20s}: {row['steps']} steps "
              f"@ {row['ms_per_step']:.2f} ms/step, "
              f"loss {row['loss_first']:.3f}->{row['loss_last']:.3f}, "
              f"qat {row['qat_accuracy']:.3f} deployed "
              f"{row['deployed_accuracy']:.3f} gap {row['qat_deployed_gap']:+.3f}",
              flush=True)

    payload = {
        "schema": 1,
        "meta": {
            "smoke": bool(args.smoke),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
            "torch_version": torch.__version__,
            "gap_bound": args.gap_bound,
            "generated_unix": int(time.time()),
            "note": ("Synthetic pipelines (data/pipeline.py): accuracies are "
                     "not the paper's CIFAR-10/DVS128 numbers, the gate is "
                     "loss decrease + bounded qat-vs-deployed gap."),
        },
        "results": results,
    }
    text = json.dumps(payload, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"[train-bench] wrote {args.out} ({len(results)} nets)")
    print(json.dumps(payload))
    if failures:
        for f in failures:
            print(f"[train-bench] FAIL {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="smoke nets, smoke-sized runs — the train-smoke gate")
    ap.add_argument("--nets", nargs="*", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-3 (5e-3 for temporal nets)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--thresholds", default="fixed",
                    help="fixed | anneal | learned")
    ap.add_argument("--nu-schedule", default="const")
    ap.add_argument("--backend", default="fused")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--gap-bound", type=float, default=SMOKE_GAP_BOUND)
    ap.add_argument("--curve-points", type=int, default=50)
    ap.add_argument("--ckpt-root",
                    default=str(Path(tempfile.gettempdir()) / "repro_torch_train_bench"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON payload to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (plain PyTorch path)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
