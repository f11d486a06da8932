#!/usr/bin/env python3
"""Where a pool tick of the PyTorch/CUDA port spends its time, on one GPU.

    python3 benchmarks/serve_profile_torch.py [--net dvs_cnn_tcn] [--pool 8] [--ticks 40]

Serves a full `SessionPool` (every slot busy, so each tick is the same
fixed-shape step) on the ``fused`` backend and reports, for a steady window
of ticks after a warm-up:

  * host milliseconds per tick (wall clock around ticks ending in a
    synchronise) and frames/s at full occupancy;
  * device-busy share of the window and device time by kernel name, from
    `torch.profiler` (CUDA activities); when the profiler reports no device
    time the script says so and falls back to CUDA events around the
    window's launches, which gives the busy share only;
  * the number of device kernels per tick.

It prints the card's name and power limit first and one JSON object last.
A CUDA device is required.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="dvs_cnn_tcn")
    ap.add_argument("--pool", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile_torch: needs a CUDA device", file=sys.stderr)
        return 1

    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda", 0)
    prog = get_net(args.net)
    g = prog.graph
    n_frames = args.ticks + 10
    frames, _ = DVSEventPipeline(
        args.pool, steps=n_frames, hw=g.input_hw[0], seed=args.seed
    ).next_batch()
    params = prog.init(torch.Generator().manual_seed(args.seed), device=dev)
    deployed = prog.quantize(params, calib=torch.from_numpy(frames[:, :8]).to(dev))
    pool = deployed.serve(args.pool, backend="fused")
    ids = [f"s{i}" for i in range(args.pool)]
    for sid in ids:
        pool.admit(sid)

    def tick(t):
        return pool.step({sid: frames[i, t] for i, sid in enumerate(ids)})

    for t in range(10):  # warm-up
        tick(t)
    torch.cuda.synchronize()

    # host clock, one synchronise per tick (what a latency-bound caller sees)
    t0 = time.perf_counter()
    for t in range(10, 10 + args.ticks):
        tick(t)
        torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    # host clock, one synchronise at the end (what a throughput-bound caller sees)
    launches0 = ternary_conv2d_cuda.launches
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for t in range(10, 10 + args.ticks):
        tick(t)
    stop.record()
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    event_ms = start.elapsed_time(stop) / args.ticks
    k1_per_tick = (ternary_conv2d_cuda.launches - launches0) / args.ticks

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(10, 10 + args.ticks):
            tick(t)
        torch.cuda.synchronize()
    by_kernel = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur_us = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dur_us
            n_kernels += 1
    device_ms = sum(by_kernel.values()) / 1e3 / args.ticks
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]

    out = {
        "card": card, "net": g.name, "pool": args.pool, "ticks": args.ticks,
        "host_ms_per_tick_sync_each": sync_ms,
        "host_ms_per_tick_sync_once": free_ms,
        "frames_per_s_full_pool": args.pool / (free_ms / 1e3),
        "event_ms_per_tick": event_ms,
        "k1_launches_per_tick": k1_per_tick,
        "profiler_device_ms_per_tick": device_ms if n_kernels else None,
        "device_busy_share": (device_ms / free_ms) if n_kernels else None,
        "device_kernels_per_tick": n_kernels / args.ticks if n_kernels else None,
        "top_kernels_ms_per_tick": [
            {"name": name[:80], "ms": us / 1e3 / args.ticks} for name, us in top
        ],
    }
    if not n_kernels:
        print("torch.profiler reported no device events; busy share not measured",
              flush=True)
    print(f"{g.name} pool {args.pool}: {free_ms:.3f} ms/tick host (sync once), "
          f"{sync_ms:.3f} ms/tick (sync each), device {device_ms:.3f} ms/tick over "
          f"{out['device_kernels_per_tick']} kernels", flush=True)
    for row in out["top_kernels_ms_per_tick"]:
        print(f"  {row['ms']:.4f} ms  {row['name']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
