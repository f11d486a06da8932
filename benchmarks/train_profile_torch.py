#!/usr/bin/env python3
"""Where a QAT train step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 benchmarks/train_profile_torch.py [--net cifar10_tnn] [--batch 32] [--steps 20]

Builds the trainer's state for a registry net at its full width (per-OCU
QAT grid, seed-0 weights, the synthetic pipeline's first batch) and, after
a warm-up, reports over a steady window of `make_qat_step` calls on one
batch already on the card:

  * host milliseconds per step (wall clock, each step waits for its loss,
    as `train()` does) and per forward + backward alone;
  * host milliseconds to make one batch in numpy (the pipeline) and to
    copy it to the card — the rest of a `train()` step;
  * device time per step, device-busy share and device kernels per step,
    with the top kernels by time, from `torch.profiler` (CUDA activities);
    when the profiler reports no device time it says so.

It prints the card's name and power limit first and one JSON object last.
A CUDA device is required.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="cifar10_tnn")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile_torch: needs a CUDA device", file=sys.stderr)
        return 1

    from repro_torch.api import CutieProgram, get_graph
    from repro_torch.data.pipeline import pipeline_for_net
    from repro_torch.kernels.ref import deterministic_float32
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import cross_entropy, init_train_state, make_qat_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda", 0)
    graph = dataclasses.replace(get_graph(args.net), qat_per_channel=True)
    prog = CutieProgram(graph)
    state = init_train_state(prog, torch.Generator().manual_seed(args.seed), device=dev)
    pipe = pipeline_for_net(graph, args.batch, seed=args.seed)
    step = make_qat_step(prog, AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200,
                                           weight_decay=0.0))

    t0 = time.perf_counter()
    host_batches = [pipe.batch_at(i) for i in range(args.steps)]
    batch_ms = (time.perf_counter() - t0) / args.steps * 1e3
    t0 = time.perf_counter()
    for x, y in host_batches:
        torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) / args.steps * 1e3
    batch = tuple(torch.from_numpy(a).to(dev) for a in host_batches[0])

    def run_steps(n):
        s = state
        for _ in range(n):
            s, m = step(s, batch)
            float(m["loss"])  # train() waits for each loss

    leaves = [p.detach().requires_grad_() for p in tree_leaves(state["params"])]

    def fwd_bwd(n):
        with deterministic_float32():
            for _ in range(n):
                loss = cross_entropy(prog.forward_qat(tree_unflatten(state["params"], leaves),
                                                      batch[0]), batch[1])
                torch.autograd.grad(loss, leaves)
                torch.cuda.synchronize()

    run_steps(5)
    fwd_bwd(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(args.steps)
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    t0 = time.perf_counter()
    fwd_bwd(args.steps)
    fwd_bwd_ms = (time.perf_counter() - t0) / args.steps * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(args.steps)
        torch.cuda.synchronize()
    by_kernel, n_kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur_us = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dur_us
            n_kernels += 1
    device_ms = sum(by_kernel.values()) / 1e3 / args.steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    out = {
        "card": card, "net": graph.name, "batch": args.batch, "steps": args.steps,
        "host_ms_per_step": step_ms,
        "host_ms_per_forward_backward": fwd_bwd_ms,
        "host_ms_per_numpy_batch": batch_ms,
        "host_ms_per_batch_copy": copy_ms,
        "profiler_device_ms_per_step": device_ms if n_kernels else None,
        "device_busy_share": (device_ms / step_ms) if n_kernels else None,
        "device_kernels_per_step": n_kernels / args.steps if n_kernels else None,
        "top_kernels_ms_per_step": [
            {"name": name[:90], "ms": us / 1e3 / args.steps,
             "share_of_device": us / max(sum(by_kernel.values()), 1e-9)}
            for name, us in top
        ],
        "params": int(sum(p.numel() for p in tree_leaves(state["params"]))),
        "float_params_finite": bool(all(torch.isfinite(p).all() for p in
                                        tree_leaves(state["params"]))),
    }
    if not n_kernels:
        print("torch.profiler reported no device events; busy share not measured", flush=True)
    print(f"{graph.name} batch {args.batch}: {step_ms:.3f} ms/step host, forward+backward "
          f"{fwd_bwd_ms:.3f} ms, numpy batch {batch_ms:.3f} ms, copy {copy_ms:.3f} ms; device "
          f"{device_ms:.3f} ms/step over {out['device_kernels_per_step']} kernels", flush=True)
    for row in out["top_kernels_ms_per_step"]:
        print(f"  {row['ms']:.4f} ms  {row['share_of_device']:.3f}  {row['name']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if np.isfinite(step_ms) else 1


if __name__ == "__main__":
    sys.exit(main())
