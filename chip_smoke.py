#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's main path — serving the full-width ``dvs_cnn_tcn`` net
(96 channels, 64x64x2 event frames, 24-step TCN ring) through an 8-slot
`SessionPool` under a `ContinuousBatcher` on the ``fused`` backend — and
holds every hand-written kernel of that path against its plain PyTorch
version on the card.  It imports `repro_torch` only.

Phases (any failure ends the run with a non-zero exit code and no result
line):

  1. device   a CUDA device is required; prints its name and power limit
  2. build    compiles the CUDA sources of the checkout with nvcc
  3. kernels  the fused ternary conv kernel == its plain version
              (`torch.equal`, tolerance 0: ternary/dyadic data sums exactly
              in float32) at every launch shape of the main path for pool
              size 8 and batch 1, all variants and both input types, plus
              1x1, 5x5, ragged C_out and odd H, W; then times kernel, plain
              version and an `F.conv2d` yardstick at the pool-size-8 shapes
  4. serve    init -> quantize(calib) -> 16 streams x 8 frames, staggered
              arrivals, through the pool; gates: finite logits, all streams
              completed, pooled == lone `StreamSession` bit for bit,
              fused == ref on the card, 9 kernel launches per pool tick
  5. result   the ``kernels`` JSON line, the card line, and the last line
              ``{"ok": true, "device": {...}}``

Timing: CUDA events around a run of launches that were enqueued behind a
spin kernel, after a warm-up, so the figures are device time and not the
host's enqueue rate.  The L2 cache is not flushed between launches: in a
pool tick every layer's input was written by the layer before it and is
found in L2, which is what the timed loop reproduces.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense): HBM3 bytes/s, float32 outside the
# tensor cores, int8 in the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.int8: 1979e12}

POOL = 8
N_STREAMS = 16
N_FRAMES = 8
SEED = 0
K1_REPLACES = "src/repro/kernels/ternary_conv2d.py:91"
K1_SOURCE = "src/repro_torch/csrc/ternary_conv2d.cu"

# (name, H, W, C_in, C_out, K, pool, input dtype) — the nine launches of one
# pool tick of dvs_cnn_tcn (5 conv + 4 TCN layers; TCN maps carry the extra
# causal top row), batch = pool size on the pool path, 1 in a lone session
MAIN_PATH_SHAPES = [
    ("conv0", 64, 64, 4, 64, 3, 2, torch.float32),
    ("conv1", 32, 32, 64, 64, 3, 2, torch.int8),
    ("conv2", 16, 16, 64, 96, 3, 2, torch.int8),
    ("conv3", 8, 8, 96, 96, 3, 2, torch.int8),
    ("conv4", 4, 4, 96, 96, 3, 2, torch.int8),
    ("tcn_d1", 25, 1, 96, 96, 3, 0, torch.float32),
    ("tcn_d2", 13, 2, 96, 96, 3, 0, torch.int8),
    ("tcn_d4", 7, 4, 96, 96, 3, 0, torch.int8),
    ("tcn_d8", 4, 8, 96, 96, 3, 0, torch.int8),
]
# shapes off the main path that must be right all the same
EXTRA_SHAPES = [
    ("1x1", 16, 16, 64, 64, 1, 0),        # kws_tcn pointwise
    ("5x5_stem", 32, 32, 4, 192, 5, 2),   # cifar10_tnn_wide stem
    ("ragged_cout", 6, 6, 8, 9, 3, 2),
    ("odd_hw", 7, 5, 8, 6, 3, 0),
    ("pool3", 9, 9, 12, 10, 3, 3),
]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device milliseconds per call of ``fn``.  The calls are enqueued behind
    a spin kernel long enough for the host to run ahead, so the two events
    bracket back-to-back device work and not the host's enqueue rate (a
    wrapper call costs the host more than these kernels cost the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0   # upper bound of the enqueue time
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 1.5 * 2.0e9) + 1_000_000)  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def make_case(gen, b, h, w, c_in, c_out, k, in_dtype, dev):
    """Seeded operands of one launch: trits (multiples of 1/4 for the float
    input, as the ring's pooled features are), packed trit weights, positive
    scales, thresholds that leave all three output values in use."""
    from repro_torch.core.ternary import pack_ternary

    x = torch.randint(-1, 2, (b, h, w, c_in), generator=gen)
    if in_dtype == torch.float32:
        x = x.float() * 0.25 * torch.randint(1, 5, (b, h, w, c_in), generator=gen)
    t = torch.randint(-1, 2, (k, k, c_in, c_out), generator=gen).to(torch.int8)
    scale = torch.rand(c_out, generator=gen) * 0.2 + 0.05
    thr = torch.rand(c_out, generator=gen) * 1.5 + 0.25
    return (x.to(in_dtype).to(dev), pack_ternary(t, axis=2).to(dev),
            scale.to(dev), thr.to(dev))


def check_kernel(dev) -> float:
    """Phase 3a: kernel == plain version, tolerance 0.  Returns the largest
    absolute difference seen (0.0 when every case is equal)."""
    from repro_torch.kernels.ref import ternary_conv2d_ref
    from repro_torch.kernels.ternary_conv2d import (
        ternary_conv2d_cuda,
        ternary_conv2d_native,
    )

    gen = torch.Generator().manual_seed(SEED)
    variants = [  # (fuse_ternary, pooled, out dtype)
        (False, False, torch.float32),
        (True, False, torch.int8),
        (True, True, torch.int8),
        (True, True, torch.float32),
    ]
    cases = []
    for name, h, w, c_in, c_out, k, pool, in_dtype in MAIN_PATH_SHAPES:
        for b in (POOL, 1):
            for dt in (torch.float32, torch.int8):
                cases.append((f"{name}/B{b}", b, h, w, c_in, c_out, k, pool, dt))
    for name, h, w, c_in, c_out, k, pool in EXTRA_SHAPES:
        for dt in (torch.float32, torch.int8):
            cases.append((name, 2, h, w, c_in, c_out, k, pool, dt))
    worst = 0.0
    n = 0
    for name, b, h, w, c_in, c_out, k, pool, dt in cases:
        x, wp, scale, thr = make_case(gen, b, h, w, c_in, c_out, k, dt, dev)
        for tern, pooled, out_dtype in variants:
            if pooled and not pool:
                continue
            kw = dict(fuse_ternary=tern, fuse_pool=pool if pooled else 0,
                      out_dtype=out_dtype)
            got = ternary_conv2d_cuda(x, wp, scale, thr, **kw)
            torch.cuda.synchronize()
            want = ternary_conv2d_native(x, wp, scale, thr, **kw)
            oracle = ternary_conv2d_ref(x, wp, scale, threshold=thr, **kw)
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            n += 1
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"kernel != plain version at {name} {dt} variant "
                     f"{(tern, pooled, out_dtype)}: max|diff|={err}")
            if not torch.equal(got, oracle):
                fail(f"kernel != ref oracle at {name} {dt} variant "
                     f"{(tern, pooled, out_dtype)}")
    print(f"[chip_smoke] kernels: ternary_conv2d == plain version == ref oracle "
          f"on {n} cases (tolerance 0), max_abs_err {worst}", flush=True)
    return worst


def time_kernel(dev):
    """Phase 3b: one pool tick's nine launches at B = POOL on the fused
    int8 variant — kernel, plain version, `F.conv2d` yardstick, and the
    bound worked out from the shapes.  Returns (totals, per-shape rows)."""
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ternary_conv2d import (
        ternary_conv2d_cuda,
        ternary_conv2d_native,
    )

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for name, h, w, c_in, c_out, k, pool, dt in MAIN_PATH_SHAPES:
        x, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, dt, dev)
        kw = dict(fuse_ternary=True, fuse_pool=pool, out_dtype=torch.int8)
        ms = time_ms(lambda: ternary_conv2d_cuda(x, wp, scale, thr, **kw))
        plain_ms = time_ms(lambda: ternary_conv2d_native(x, wp, scale, thr, **kw), iters=10)
        # yardstick only: one cuDNN convolution on pre-decoded float weights
        # (no scale, threshold or pool); the port never calls it
        x_nchw = x.float().permute(0, 3, 1, 2).contiguous()
        w_oihw = unpack_ternary(wp, axis=2).float().permute(3, 2, 0, 1).contiguous()
        library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=k // 2))
        p = pool if pool > 1 else 1
        out_elems = POOL * (h // p) * (w // p) * c_out
        nbytes = (x.numel() * x.element_size() + wp.numel() + 4 * scale.numel()
                  + 4 * thr.numel() + out_elems)  # int8 out: one byte each
        ops = 2 * POOL * h * w * k * k * c_in * c_out
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S[dt] * 1e3
        rows.append({
            "shape": name, "x": [POOL, h, w, c_in], "x_dtype": str(dt).split(".")[-1],
            "c_out": c_out, "pool": pool, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes, "operations": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "_bytes_ms": bytes_ms, "_ops_ms": ops_ms,
        })
        print(f"[chip_smoke]   {name:7s} x{[POOL, h, w, c_in]} {rows[-1]['x_dtype']:7s} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  F.conv2d {library_ms:.4f} ms  "
              f"bound {rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})", flush=True)
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["bound_by"] = ("bytes" if sum(r["_bytes_ms"] for r in rows)
                         >= sum(r["_ops_ms"] for r in rows) else "operations")
    for r in rows:
        del r["_bytes_ms"], r["_ops_ms"]
    return total, rows


def serve_main_path(dev):
    """Phase 4: the main path at full width.  Returns (launches counted on
    the main path, serving stats for the report)."""
    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import ContinuousBatcher, StreamRequest

    prog = get_net("dvs_cnn_tcn")
    g = prog.graph
    if (g.feature_channels, g.input_hw, g.tcn_steps) != (96, (64, 64), 24):
        fail(f"dvs_cnn_tcn is not at full width: {g}")
    params = prog.init(torch.Generator().manual_seed(SEED), device=dev)
    frames, labels = DVSEventPipeline(
        N_STREAMS, steps=N_FRAMES, hw=g.input_hw[0], seed=SEED
    ).next_batch()
    deployed = prog.quantize(params, calib=torch.from_numpy(frames).to(dev))

    def run_pool(n_streams):
        pool = deployed.serve(POOL, backend="fused")
        batcher = ContinuousBatcher(pool)
        for i in range(n_streams):
            batcher.submit(StreamRequest(
                stream_id=f"sensor-{i}", frames=frames[i], label=int(labels[i]),
                arrival=i,
            ))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = batcher.run()
        torch.cuda.synchronize()
        return batcher, results, time.perf_counter() - t0

    run_pool(2)  # warm-up: first-launch costs stay out of the timed run
    ternary_conv2d_cuda.launches = 0
    batcher, results, wall = run_pool(N_STREAMS)
    launches = ternary_conv2d_cuda.launches

    stats = batcher.stats()
    busy_ticks = len(batcher.latency_trace)
    if len(results) != N_STREAMS:
        fail(f"{len(results)}/{N_STREAMS} streams completed")
    if stats["frames_processed"] != N_STREAMS * N_FRAMES:
        fail(f"{stats['frames_processed']} frames processed, expected "
             f"{N_STREAMS * N_FRAMES}")
    for r in results:
        if r.logits.shape != (g.n_classes,) or not np.isfinite(r.logits).all():
            fail(f"{r.stream_id}: logits not finite or misshaped {r.logits.shape}")
    if launches != 9 * busy_ticks:
        fail(f"{launches} kernel launches over {busy_ticks} pool ticks; the "
             "fused path makes 9 per tick (5 conv + 4 TCN layers)")

    # pooled == lone StreamSession, bit for bit
    by_id = {r.stream_id: r for r in results}
    for i in (0, 5, N_STREAMS - 1):
        session = deployed.stream(batch=1, backend="fused")
        clip = torch.from_numpy(frames[i:i + 1]).to(dev)
        for t in range(N_FRAMES):
            lone = session.step(clip[:, t])
        if not np.array_equal(by_id[f"sensor-{i}"].logits, lone.cpu().numpy()[0]):
            fail(f"sensor-{i}: pooled logits != lone StreamSession logits")
    # fused == ref on the card, whole clips through the batch forward
    clips = torch.from_numpy(frames[:2]).to(dev)
    fused = deployed.forward(clips, backend="fused")
    ref = deployed.forward(clips, backend="ref")
    if not torch.equal(fused, ref):
        fail(f"fused != ref on the card: max|diff|={(fused - ref).abs().max().item()}")
    if not np.array_equal(by_id["sensor-0"].logits, fused.cpu().numpy()[0]):
        fail("streamed logits != batch forward logits for sensor-0")

    serving = {
        "net": g.name, "pool": POOL, "streams": N_STREAMS, "frames_per_stream": N_FRAMES,
        "ticks": stats["ticks"], "busy_ticks": busy_ticks,
        "frames_processed": stats["frames_processed"],
        "mean_occupancy": stats["mean_occupancy"],
        "wall_s": wall, "frames_per_s": stats["frames_processed"] / wall,
        "ms_per_tick": wall / busy_ticks * 1e3,
    }
    print(f"[chip_smoke] serve: {g.name} fused, {N_STREAMS} streams x {N_FRAMES} frames, "
          f"{POOL}-slot pool: {serving['frames_processed']} frames in {busy_ticks} ticks, "
          f"{wall:.3f} s -> {serving['frames_per_s']:.1f} frames/s, "
          f"{serving['ms_per_tick']:.3f} ms/tick, occupancy "
          f"{serving['mean_occupancy']:.2f}; {launches} kernel launches "
          f"(9 per tick); pooled == lone session; fused == ref", flush=True)
    return launches, serving


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # phase 2: build every kernel source of the checkout, all started together
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        for lib in ex.map(build.build, sources):
            print(f"[chip_smoke] built {lib.name}", flush=True)
    print(f"[chip_smoke] build: {len(sources)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s ({Path(build.find_nvcc()).name})", flush=True)

    # phase 3: kernel against its plain version, then times
    max_abs_err = check_kernel(dev)
    total, per_shape = time_kernel(dev)

    # phase 4: the main path
    launches, serving = serve_main_path(dev)

    # phase 5: results
    kernels = {"kernels": [{
        "name": "ternary_conv2d", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, "max_abs_err": max_abs_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": total["bound_by"], "library_ms": total["library_ms"],
        "times_cover": "the 9 launches of one pool tick at pool size 8 (sum)",
        "shapes": per_shape,
    }]}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
