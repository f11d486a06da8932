"""QAT training launcher — toward the paper's 86% (CIFAR) / 94.5% (DVS).
Counterpart of `repro.launch.train`.

Drives `repro_torch.train.train` for any registry net, on the card by
default: deterministic pipeline
(data/pipeline.py, matched to the graph's geometry) -> STE ternary QAT with
nu/threshold schedules or learned per-layer thresholds -> atomic committed
checkpoints with restart supervision -> final quantize on the trained grid
-> eval of BOTH the QAT forward and the packed fused deployment, reporting
the float->ternary accuracy gap -> silicon cost report.

    PYTHONPATH=src python -m repro_torch.launch.train --net cifar10_tnn --smoke
    PYTHONPATH=src python -m repro_torch.launch.train --net cifar10_tnn \
        --steps 2000 --batch 64 --thresholds learned --nu-schedule anneal
    PYTHONPATH=src python -m repro_torch.launch.train --net cifar10_tnn_smoke \
        --steps 20 --device cpu                               # plain path

``--smoke`` is the train-smoke recipe: ~200 steps, asserts the loss
decreased and the QAT-vs-deployed gap stays bounded, exits 1 otherwise.
``--device`` defaults to ``cuda``; without a CUDA device that is an error,
not a move to the CPU.  ``--trace FILE.json`` writes a Chrome/Perfetto
trace (`repro_torch.obs`).  The reference's LM launcher (``train_lm``) is
not ported.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

from repro_torch.api.program import BACKENDS
from repro_torch.api.registry import list_nets
from repro_torch.ckpt.checkpoint import latest_step
from repro_torch.train import THRESHOLD_MODES, train
from repro_torch.train.loop import default_ckpt_dir

SMOKE_GAP_BOUND = 0.15  # |qat - deployed| accuracy, absolute


def smoke_recipe(net: str) -> dict:
    """THE per-net smoke hyperparameters — the reference's, shared verbatim
    with benchmarks/train_bench_torch.py so the CLI gate and the bench gate
    cannot drift.
    The DVS frontend is ~25x the cifar-smoke FLOPs per step and its
    symmetry breaks slower on the synthetic task, hence fewer steps at a
    hotter LR and a smaller batch."""
    if "dvs" in net:
        return {"steps": 100, "lr": 5e-3, "batch": 8}
    return {"steps": 200, "lr": 3e-3, "batch": 32}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="cifar10_tnn", choices=list_nets(),
                    help="registry net to train")
    ap.add_argument("--smoke", action="store_true",
                    help="the CI train-smoke recipe for this net (see "
                         "smoke_recipe): assert loss decrease and "
                         f"|qat-deployed| gap <= {SMOKE_GAP_BOUND}")
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps (default 1000, or the net's smoke "
                         "recipe with --smoke)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 32, or the net's smoke recipe with --smoke")
    ap.add_argument("--lr", type=float, default=None,
                    help="default 1e-3, or the net's smoke recipe with --smoke")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(default_ckpt_dir()),
                    help="committed checkpoints (default: under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest committed checkpoint in "
                         "--ckpt-dir instead of wiping it")
    ap.add_argument("--thresholds", default="fixed", choices=THRESHOLD_MODES,
                    help="activation thresholds: fixed | anneal (scheduled) "
                         "| learned (per-layer, trained via the STE "
                         "threshold gradient)")
    ap.add_argument("--nu-schedule", default="const",
                    help="TWN nu: const | anneal | <float> (piecewise-constant)")
    ap.add_argument("--no-per-channel", dest="per_channel", action="store_false",
                    help="train on the legacy per-layer quantization grid "
                         "instead of the per-OCU grid deployment packs")
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS),
                    help="deploy backend for the final eval (default: fused)")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--gap-bound", type=float, default=SMOKE_GAP_BOUND,
                    help="--smoke: max allowed |qat - deployed| accuracy gap")
    ap.add_argument("--trace", default=None, metavar="FILE.json",
                    help="record a repro_torch.obs trace of the run (per-segment "
                         "step/eval spans + the trained net's sim layer "
                         "timeline) as Chrome/Perfetto trace JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)

    recipe = smoke_recipe(args.net) if args.smoke else {}
    steps = args.steps if args.steps is not None else recipe.get("steps", 1000)
    lr = args.lr if args.lr is not None else recipe.get("lr", 1e-3)
    batch = args.batch if args.batch is not None else recipe.get("batch", 32)
    ckpt_dir = Path(args.ckpt_dir)
    if not args.resume and latest_step(ckpt_dir) is not None:
        # a stale checkpoint would silently resume someone else's run
        print(f"[train] wiping stale checkpoints under {ckpt_dir} "
              f"(pass --resume to continue them)")
        shutil.rmtree(ckpt_dir)

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    report = train(
        args.net, steps=steps, batch=batch, lr=lr, seed=args.seed,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        nu_schedule=args.nu_schedule, thresholds=args.thresholds,
        per_channel=args.per_channel, eval_batches=args.eval_batches,
        backend=args.backend, tracer=tracer, device=args.device,
    )
    if tracer is not None:
        from repro_torch.obs import save_chrome

        save_chrome(args.trace, tracer,
                    sim_programs={args.net: report.deployed},
                    meta={"scenario": "train", "net": args.net,
                          "device": args.device})
        print(f"[train] trace -> {args.trace} ({len(tracer)} events; "
              f"load in ui.perfetto.dev)")
    print(report.summary())
    print(report.deployed.silicon_report(v=0.5).summary())
    print(f"[train] final checkpoint: step {latest_step(ckpt_dir)} "
          f"under {ckpt_dir}")

    if args.smoke:
        failures = report.gate(args.gap_bound)  # same gate train_bench runs
        for f in failures:
            print(f"[train] FAIL {f}", file=sys.stderr)
        if failures:
            sys.exit(1)
        print(f"[train] smoke OK: loss decreased, "
              f"gap {report.final_eval.gap:+.3f} within {args.gap_bound}")
    return report


if __name__ == "__main__":
    main()
