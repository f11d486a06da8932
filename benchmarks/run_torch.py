"""Benchmark runner of the PyTorch/CUDA port: one CSV of the paper tables,
the kernel benches, short LM training runs and the roofline summary, on the
card by default.

Counterpart of ``benchmarks/run.py``; prints ``name,us_per_call,derived``
rows:
  * paper tables — derived = (model value, paper value) pairs;
  * kernel benches — the kernel bench's smoke cells, us_per_call = the
    packed kernel's time, derived = the dense and plain times, the weight
    byte reduction, bit-exactness and the float error;
  * train_smoke — a captured, donating LM train step
    (`CapturedStep(make_train_step(..., donate=True))`) on SMOKE configs,
    host time per step ending in a synchronise;
  * roofline summary — derived = dominant term + roofline fraction, from
    `roofline_torch` over the dry-run artifacts (``experiments/dryrun_torch/``
    or ``--art-dir``).

    python3 benchmarks/run_torch.py
    python3 benchmarks/run_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))
sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402

TRAIN_ARCHS = ("gemma-2b", "mamba2-370m")
TRAIN_STEPS = 3


def _row(name, us, derived):
    print(f"{name},{'' if us is None else f'{us:.2f}'},{derived}", flush=True)


def train_smoke(arch: str, dev: torch.device, steps: int = TRAIN_STEPS):
    """(us per captured step, last loss) of a SMOKE config: one warm-up call
    (eager, then the capture on the card), then ``steps`` timed steps."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(arch, smoke=True)
    pipe = LMTokenPipeline(cfg.vocab_size, 32, 4, seed=0)
    step = CapturedStep(make_train_step(cfg, AdamWConfig(warmup_steps=1), donate=True),
                        dev, inputs=(1,))
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state, m = step(state, pipe.next_batch())  # warm-up + capture
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, pipe.next_batch())
    loss = float(m["loss"])  # waits for the last step
    return (time.perf_counter() - t0) / steps * 1e6, loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--art-dir", type=Path, default=None,
                    help="dry-run artifact directory (default experiments/dryrun_torch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_start = time.time()
    print("name,us_per_call,derived")

    # ---- paper tables/figures (analytical CUTIE model) ----
    from benchmarks import paper_tables_torch as pt

    for name, model_v, paper_v in pt.table1():
        d = f"model={model_v:.4g}" + ("" if paper_v is None else f";paper={paper_v:.4g}")
        _row(f"table1/{name}", None, d)
    for net, v, uj, ips in pt.fig5(steps=5):
        _row(f"fig5/{net}@{v}V", None, f"uJ={uj:.3g};inf_per_s={ips:.5g}")
    for v, eff, tput in pt.fig6(steps=5):
        _row(f"fig6/peak@{v}V", None, f"TOp_s_W={eff:.4g};TOp_s={tput:.4g}")
    for name, val, note in pt.dvs_tcn_soa_comparison():
        _row(f"soa/{name}", None, f"value={val:.4g};note={note}")

    # ---- kernel microbenches: the kernel bench's smoke cells ----
    from benchmarks import kernel_bench_torch as kb

    with torch.no_grad():
        rows = [kb.bench_matmul(m, k, n, kb.SMOKE_REPEATS, dev) for m, k, n in kb.SMOKE_MATMULS]
        rows += [kb.bench_conv(*cell, kb.SMOKE_REPEATS, dev) for cell in kb.SMOKE_CONVS]
    for r in rows:
        _row(f"kernel/{r['name']}", r["packed_us"],
             f"dense_us={r['dense_us']:.2f};plain_us={r['plain_us']:.2f};"
             f"bytes_reduction={r['bytes_reduction']:.1f}x;bit_exact={r['bit_exact']};"
             f"err={r['max_err_float']:.2g}")

    # ---- LM train steps (SMOKE configs, captured and donating) ----
    for arch in TRAIN_ARCHS:
        us, loss = train_smoke(arch, dev)
        _row(f"train_smoke/{arch}", us, f"loss={loss:.3f}")

    # ---- roofline summary from the dry-run artifacts ----
    from benchmarks import roofline_torch as rl

    table = rl.full_table(art_dir=args.art_dir or rl.ART_DIR)
    ok = [r for r in table if r.get("status") == "ok"]
    _row("roofline/cells_ok", None, f"n={len(ok)}")
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        best = max(ok, key=lambda r: r["roofline_fraction"])
        for tag, r in (("best", best), ("worst", worst)):
            _row(f"roofline/{tag}", None,
                 f"{r['arch']}/{r['shape']}={r['roofline_fraction']*100:.1f}%;"
                 f"bound={r['dominant']}")

    _row("total_bench_seconds", None, f"{time.time()-t_start:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
