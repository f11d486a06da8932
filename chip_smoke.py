#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's three paths on the card, each through the entry points a
user calls, and holds every hand-written kernel against its plain PyTorch
version.  It imports `repro_torch` only.

  * the serving path — the full-width ``dvs_cnn_tcn`` net (96 channels,
    64x64x2 event frames, 24-step TCN ring) through an 8-slot `SessionPool`
    under a `ContinuousBatcher` on the ``fused`` backend (kernel K1);
  * the quickstart path — `python -m repro_torch.quickstart`: the
    full-width ``cifar10_tnn`` on every deploy backend, the packed-ternary
    matmul (kernel K2) and the silicon model;
  * the deployment path — two full-width programs (``dvs_cnn_tcn`` and
    ``kws_tcn``) shipped as ``.cutie`` bytes, loaded on the card with no
    graph, and served together through one `FleetRouter` on ``fused``
    (kernel K1 through the plan executor), ungated and activity-gated,
    then through the launcher's ``--dvs --program`` and ``--fleet --gate``;
  * the training path — `repro_torch.train.train` (STE QAT, AdamW,
    checkpoints) at full width on ``cifar10_tnn`` and ``dvs_cnn_tcn``,
    ending in the deployed eval on ``fused`` (kernel K1), a resume on the
    card, and the training launcher with its trace.

Phases (any failure ends the run with a non-zero exit code and no result
line):

  1. device     a CUDA device is required; prints its name and power limit
  2. build      compiles every CUDA source of the checkout with nvcc, all
                started together
  3. kernels    K1, the fused ternary conv == its plain version (`torch.equal`,
                tolerance 0: ternary/dyadic data sums exactly in float32) at
                every launch shape of the serving path for pool size 8 and
                batch 1, all variants and both input types, plus 1x1, 5x5,
                ragged C_out and odd H, W; and within rtol=atol=1e-4 on
                Gaussian float32 x (all three bf16 terms in use) at conv0,
                tcn_d1 and the 5x5 stem; K2, the packed-ternary matmul ==
                its plain version == `ternary_matmul_ref` (`torch.equal`) on
                dyadic x at the eight shapes of the reference's tests, the
                quickstart and the kernel bench, plus a K that needs padding,
                in float32 and bf16, and within rtol=atol=1e-4 (float32) /
                2e-2 (bf16) on Gaussian x (summation order), including
                K-split boundaries inside a chunk and ragged last splits;
                both kernels launched 8 times on the same Gaussian inputs
                give the same bits (no atomics, fixed reduction order).
                Then times each kernel, its plain version and a library
                yardstick
  4. serve      init -> quantize(calib) -> 16 streams x 8 frames, staggered
                arrivals, through the pool; gates: finite logits, all streams
                completed, pooled == lone `StreamSession` bit for bit,
                fused == ref on the card, 9 K1 launches per pool tick
  5. quickstart `repro_torch.quickstart` on the card (exit 0, >= 1 K2 launch);
                fused == kernel == ref == bitsim on two full-width
                ``dvs_cnn_tcn`` clips and a bitsim stream == its batch
                forward; every ``BENCH_silicon.json`` row (the reference's
                silicon model output) reproduced exactly by the port
  6. fleet      build + quantize ``dvs_cnn_tcn`` and ``kws_tcn`` (seed 0,
                calibrated on their own frames), assemble each to ``.cutie``
                bytes and ``loads`` them on the card; gates: ``to_bytes()``
                and dis -> asm give the same bytes, fused == ref == bitsim on
                the loaded program == the `DeployedProgram` on an 8-frame
                clip.  Ungated fleet (ladder cap 8, feeder thread; 16 sensors
                per net in two waves): every stream completes, logits finite
                and == a lone `StreamSession` on the loaded program, a grow
                and a shrink in each bucket, each rung's pool constructed
                once (count and object identity), 9 / 7 K1 launches per
                bucket tick, the same run with ``ingest="sync"`` bit-identical.
                Gated fleet (``ActivityGate(16, 4, 2)``, 8 sensors per net at
                duty 0.4): processed frames == ``ActivityGate.plan``, each
                stream == a lone session fed exactly those frames, a positive
                silicon-model energy saving.  Then `repro_torch.launch.serve`
                ``--dvs --program`` and ``--fleet --gate`` exit 0.  Prints
                the ``fleet`` JSON line
  7. train      the launcher's smoke recipe on full-width ``cifar10_tnn``
                (96 channels, 32x32x3, 8 conv + FC; 200 steps, batch 32,
                lr 3e-3, seed-0 synthetic data, eval on ``fused``): every
                loss finite, the smoke gate (loss decreased, |QAT -
                deployed| <= 0.15), the trained program's fused == ref on
                an eval batch, 8 K1 launches per eval batch.  Full-width
                ``dvs_cnn_tcn`` (96 channels, 64x64x2, 5 conv + 4 TCN; 10
                steps, batch 8, lr 5e-3): finite losses, finite non-zero
                gradients on every layer at step 1, 9 K1 launches per
                deployed eval forward.  On ``cifar10_tnn_smoke``: 8 steps
                straight == 4 + restore + 4 (losses and params
                `torch.equal`).  ``python -m repro_torch.launch.train --net
                cifar10_tnn_smoke --smoke --trace`` and ``python -m
                repro_torch.obs summarize`` exit 0 and the trace nests.
                Times a full-width QAT forward + backward under the
                deterministic cuDNN settings the trainer uses and under
                cuDNN's autotuned ones, in turns.  Prints the ``train``
                JSON line
  8. result     the ``kernels`` JSON line (each kernel's time beside its
                bound, plain version and library yardstick, all from this
                run), the card line, and the last line
                ``{"ok": true, "device": {...}}``

Bounds: the larger of the bytes over HBM's rate and the operations over
the tensor cores' rate for the route the kernels take — int8 mmas for int8
x, bf16 mmas otherwise, three per product for float32 x (hi + mid + lo)
unless every value of x is bf16-exact, where one does.

Each path is driven with the launch counts set to 0 just before it and read
just after (the fleet per bucket tick, the trainer per `train` call);
launches made to compare a kernel with its plain version fall outside
those windows.

Timing: CUDA events around a run of launches that were enqueued behind a
spin kernel, after a warm-up, so the figures are device time and not the
host's enqueue rate.  The L2 cache is not flushed between launches: in a
pool tick every layer's input was written by the layer before it and is
found in L2, which is what the timed loop reproduces.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense): HBM3 bytes/s, and the tensor
# cores' int8 and bf16 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.int8: 1979e12, torch.bfloat16: 989e12}

POOL = 8
REPEAT_LAUNCHES = 8  # launches on the same inputs that must give the same bits
# K1 shapes whose float32 route is held on Gaussian x, where every bf16 term counts
K1_GAUSSIAN = ("conv0", "tcn_d1", "5x5_stem")
N_STREAMS = 16
N_FRAMES = 8
SEED = 0
K1_REPLACES = "src/repro/kernels/ternary_conv2d.py:91"
K1_SOURCE = "src/repro_torch/csrc/ternary_conv2d.cu"
K2_REPLACES = "src/repro/kernels/ternary_matmul.py:62"
K2_SOURCE = "src/repro_torch/csrc/ternary_matmul.cu"
REPO = Path(__file__).resolve().parent

# the deployment path: (net, K1 launches per tick, channels, input, ring)
FLEET_NETS = (("dvs_cnn_tcn", 9, 96, (64, 64), 2, 24),
              ("kws_tcn", 7, 96, (32, 32), 1, 16))
FLEET_CAP = 8
FLEET_SENSORS = 16       # per net: sensors 0-11 in the first wave, 12-15 later
FLEET_WAVE2_TICK = 30    # after the first wave has drained (about tick 20)
GATED_SENSORS = 8        # per net
GATED_DUTY = 0.4

# the training path: (net, K1 launches per deployed eval forward, channels,
# input, input channels, conv layers, tcn layers)
TRAIN_SPATIAL = ("cifar10_tnn", 8, 96, (32, 32), 3, 8, 0)
TRAIN_TEMPORAL = ("dvs_cnn_tcn", 9, 96, (64, 64), 2, 5, 4)
TRAIN_TEMPORAL_RECIPE = {"steps": 10, "batch": 8, "lr": 5e-3}
TRAIN_EVAL_BATCHES = 4
DETERMINISM_STEPS = 20   # QAT steps timed per cuDNN setting, in turns

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

# (M, K, N) of K2: the reference's kernel tests, the quickstart (64x2048x512)
# and the kernel bench (512x2048x512), a K the wrapper pads (98 -> 100), and
# K-splits whose boundary falls inside a 64-deep chunk with a ragged last
# split (2052 = 7 x 272 + 148; 260 = 5 x 48 + 20)
MATMUL_SHAPES = [
    (128, 512, 128), (256, 1024, 384), (8, 512, 128), (100, 100, 70),
    (1, 2048, 512), (384, 4, 128), (64, 2048, 512), (512, 2048, 512),
    (7, 98, 33), (64, 2052, 512), (3, 260, 40),
]
MATMUL_TIMED = [(64, 2048, 512), (512, 2048, 512)]  # quickstart first


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


def ops_ms(ops: int, x: torch.Tensor) -> float:
    """Milliseconds for ``ops`` operations (a multiply-add is two) with x as
    one operand at the tensor cores' peak, on the route the kernels take:
    float32 x costs three bf16 mmas per product (hi + mid + lo), or one when
    every value of x is bf16-exact."""
    if x.dtype == torch.int8:
        return ops / PEAK_OPS_PER_S[torch.int8] * 1e3
    terms = 3 if x.dtype == torch.float32 and not torch.equal(x, x.bfloat16().float()) else 1
    return terms * ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3


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


def check_kernel(dev):
    """Phase 3a: kernel == plain version, tolerance 0, and within 1e-4 on
    Gaussian float32 x.  Returns the largest absolute difference seen on
    each (0.0 when every exact case is equal)."""
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
    # the float32 route on data that is not bf16-exact: the summation order
    # differs, so the tolerance the reference's conv tests use on Gaussian x
    geometry = {s[0]: s[1:7] for s in MAIN_PATH_SHAPES + EXTRA_SHAPES}
    worst_gauss = 0.0
    for name in K1_GAUSSIAN:
        h, w, c_in, c_out, k, pool = geometry[name]
        _, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, torch.float32, dev)
        x = torch.randn((POOL, h, w, c_in), generator=gen).to(dev)
        for fuse_pool in sorted({0, pool}):
            kw = dict(fuse_pool=fuse_pool, out_dtype=torch.float32)
            got = ternary_conv2d_cuda(x, wp, scale, thr, **kw)
            torch.cuda.synchronize()
            want = ternary_conv2d_native(x, wp, scale, thr, **kw)
            err = (got - want).abs().max().item()
            worst_gauss = max(worst_gauss, err)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                fail(f"kernel off the plain version beyond 1e-4 at {name} pool "
                     f"{fuse_pool} on Gaussian float32 x: max|diff|={err}")
    print(f"[chip_smoke] kernels: ternary_conv2d == plain version == ref oracle "
          f"on {n} cases (tolerance 0), max_abs_err {worst}; within 1e-4 on Gaussian "
          f"float32 x at {', '.join(K1_GAUSSIAN)}, max_abs_err {worst_gauss}", flush=True)
    return worst, worst_gauss


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
        op_ms = ops_ms(ops, x)
        rows.append({
            "shape": name, "x": [POOL, h, w, c_in], "x_dtype": str(dt).split(".")[-1],
            "c_out": c_out, "pool": pool, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ms_over_library": ms / library_ms,
            "bytes": nbytes, "operations": ops, "bound_ms": max(bytes_ms, op_ms),
            "bound_by": "bytes" if bytes_ms >= op_ms else "operations",
            "_bytes_ms": bytes_ms, "_ops_ms": op_ms,
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


def matmul_case(gen, m, k, n, dtype, dev, gaussian=False):
    """Seeded K2 operands: x dyadic (trits times 1/4..1, exact in bf16) or
    Gaussian, packed trit weights [ceil(K/4), N] along K, positive scales."""
    from repro_torch.core.ternary import pack_ternary

    if gaussian:
        x = torch.randn((m, k), generator=gen)
    else:
        x = (torch.randint(-1, 2, (m, k), generator=gen).float() * 0.25
             * torch.randint(1, 5, (m, k), generator=gen))
    k4 = -(-k // 4)
    t = torch.randint(-1, 2, (4 * k4, n), generator=gen).to(torch.int8)
    scale = torch.rand(n, generator=gen) * 0.2 + 0.05
    return x.to(dtype).to(dev), pack_ternary(t, axis=0).to(dev), scale.to(dev)


def check_matmul(dev):
    """Phase 3c: K2 == plain version == oracle (`torch.equal`) on dyadic x;
    within the JAX tests' tolerances on Gaussian x.  Returns the largest
    |kernel - plain version| per dtype over all cases."""
    from repro_torch.kernels.ops import ternary_matmul
    from repro_torch.kernels.ref import ternary_matmul_ref
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_cuda,
        ternary_matmul_native,
    )

    gen = torch.Generator().manual_seed(SEED + 2)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for m, k, n in MATMUL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for gaussian in (False, True):
                x, wp, scale = matmul_case(gen, m, k, n, dt, dev, gaussian)
                before = ternary_matmul_cuda.launches
                got = ternary_matmul(x, wp, scale)
                torch.cuda.synchronize()
                if ternary_matmul_cuda.launches != before + 1:
                    fail(f"ternary_matmul on the card did not launch K2 at {(m, k, n)}")
                xp = F.pad(x, (0, 4 * wp.shape[0] - k))
                want = ternary_matmul_native(xp, wp, scale)
                oracle = ternary_matmul_ref(xp, wp, scale)
                err = (got.float() - want.float()).abs().max().item()
                worst[dt] = max(worst[dt], err)
                n_cases += 1
                where = f"{(m, k, n)} {dt} {'gaussian' if gaussian else 'dyadic'}"
                if got.shape != (m, n) or got.dtype != dt:
                    fail(f"K2 output {tuple(got.shape)} {got.dtype} at {where}")
                if not gaussian:
                    if not torch.equal(got, want):
                        fail(f"K2 != plain version at {where}: max|diff|={err}")
                    if not torch.equal(got, oracle):
                        fail(f"K2 != ternary_matmul_ref at {where}")
                elif not torch.allclose(got.float(), want.float(), rtol=tol[dt], atol=tol[dt]):
                    fail(f"K2 off the plain version beyond {tol[dt]} at {where}: max|diff|={err}")
    print(f"[chip_smoke] kernels: ternary_matmul == plain version == ref oracle on "
          f"{n_cases // 2} dyadic cases (tolerance 0), and within 1e-4 (float32) / "
          f"2e-2 (bf16) on {n_cases // 2} Gaussian cases; max|kernel - plain| "
          f"float32 {worst[torch.float32]}, bf16 {worst[torch.bfloat16]}", flush=True)
    return worst[torch.float32], worst[torch.bfloat16]


def time_matmul(dev):
    """Phase 3d: K2 at the quickstart and kernel-bench shapes — kernel, plain
    version, a `torch.matmul` yardstick on pre-decoded float weights (no
    scale; the port never calls it) and the bound from the shapes."""
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ref import exact_float32
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_cuda,
        ternary_matmul_native,
    )

    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in MATMUL_TIMED:
            x, wp, scale = matmul_case(gen, m, k, n, dt, dev, gaussian=True)
            ms = time_ms(lambda: ternary_matmul_cuda(x, wp, scale))
            plain_ms = time_ms(lambda: ternary_matmul_native(x, wp, scale), iters=20)
            w_dec = unpack_ternary(wp, axis=0).to(dt)
            with exact_float32():
                library_ms = time_ms(lambda: torch.matmul(x, w_dec))
            nbytes = x.numel() * x.element_size() + wp.numel() + 4 * n + m * n * x.element_size()
            ops = 2 * m * k * n
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            op_ms = ops_ms(ops, x)
            rows.append({
                "shape": [m, k, n], "x_dtype": str(dt).split(".")[-1], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "ms_over_library": ms / library_ms, "bytes": nbytes,
                "operations": ops, "bound_ms": max(bytes_ms, op_ms),
                "bound_by": "bytes" if bytes_ms >= op_ms else "operations",
            })
            print(f"[chip_smoke]   matmul {m}x{k}x{n} {rows[-1]['x_dtype']:8s} kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  torch.matmul {library_ms:.4f} ms  bound "
                  f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})", flush=True)
    return rows


def check_determinism(dev):
    """Phase 3e: each kernel launched REPEAT_LAUNCHES times on the same
    Gaussian inputs gives the same bits every time — the sums run in a fixed
    order, with no atomics.  K1 at the pool-8 shapes of both input types
    (int8 x beyond the trits), K2 at the split and unsplit shapes in both
    types.  Returns the number of cases."""
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

    def same_bits(launch) -> bool:
        outs = [launch() for _ in range(REPEAT_LAUNCHES)]
        torch.cuda.synchronize()
        return all(torch.equal(outs[0], o) for o in outs[1:])

    gen = torch.Generator().manual_seed(SEED + 4)
    n = 0
    for name, h, w, c_in, c_out, k, pool, dt in MAIN_PATH_SHAPES:
        _, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, dt, dev)
        x = torch.randn((POOL, h, w, c_in), generator=gen).to(dev)
        if dt == torch.int8:
            x = torch.randint(-100, 101, (POOL, h, w, c_in), generator=gen).to(torch.int8).to(dev)
        kw = dict(fuse_pool=pool, out_dtype=torch.float32)
        if not same_bits(lambda: ternary_conv2d_cuda(x, wp, scale, thr, **kw)):
            fail(f"K1 not deterministic at {name} {dt}: {REPEAT_LAUNCHES} launches differ")
        n += 1
    for m, k, nn in MATMUL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, wp, scale = matmul_case(gen, m, 4 * -(-k // 4), nn, dt, dev, gaussian=True)
            if not same_bits(lambda: ternary_matmul_cuda(x, wp, scale)):
                fail(f"K2 not deterministic at {(m, k, nn)} {dt}: "
                     f"{REPEAT_LAUNCHES} launches differ")
            n += 1
    print(f"[chip_smoke] kernels: {REPEAT_LAUNCHES} launches bit-identical on each of {n} "
          f"Gaussian cases (K1 and K2)", flush=True)
    return n


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


def quickstart_path(dev):
    """Phase 5: the quickstart path on the card, with the launch counts set
    to 0 just before it and read just after.  Returns the counts."""
    from repro_torch import quickstart
    from repro_torch.api import BACKENDS, get_graph, get_net, silicon_report
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
    from repro_torch.sim import reconcile

    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    rc = quickstart.main(["--device", "cuda", "--seed", str(SEED)])
    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    if rc != 0:
        fail(f"repro_torch.quickstart exited {rc} on the card")
    if launches["ternary_matmul"] < 1 or launches["ternary_conv2d"] < 1:
        fail(f"the quickstart did not go through both kernels: {launches}")

    # two full-width dvs_cnn_tcn clips on every deploy backend
    prog = get_net("dvs_cnn_tcn")
    frames, _ = DVSEventPipeline(2, steps=N_FRAMES, hw=prog.graph.input_hw[0],
                                 seed=SEED).next_batch()
    clips = torch.from_numpy(frames).to(dev)
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(SEED), device=dev),
                             calib=clips)
    logits = {b: deployed.forward(clips, backend=b) for b in BACKENDS}
    for b, y in logits.items():
        if not torch.equal(y, logits["ref"]):
            fail(f"dvs_cnn_tcn: {b} != ref on the card: "
                 f"max|diff|={(y - logits['ref']).abs().max().item()}")
    session = deployed.stream(batch=1, backend="bitsim")
    for t in range(N_FRAMES):
        streamed = session.step(clips[:1, t])
    if not torch.equal(streamed, logits["bitsim"][:1]):
        fail("dvs_cnn_tcn: bitsim stream != bitsim batch forward")

    # the silicon model: every committed row of the reference's sweep
    rows = json.loads((REPO / "BENCH_silicon.json").read_text())["results"]
    for r in rows:
        g = get_graph(r["net"])
        rep = silicon_report(g, v=r["v"], source=r["source"])
        rec = reconcile(g)
        got = {
            "cycles": rep.ideal.cycles, "ideal_energy_uj": rep.ideal.energy_j * 1e6,
            "ideal_inf_per_s": rep.ideal.inf_per_s, "energy_uj": rep.energy_uj,
            "inf_per_s": rep.inf_per_s, "calibrated": rep.calibrated is not None,
            "analytic_schedulable": rec["analytic_schedulable"],
            "divergence_at_0v5": rec["divergence"], "stall_cycles": rec["stall_cycles"],
        }
        diff = {key: (r[key], val) for key, val in got.items() if r[key] != val}
        if diff:
            fail(f"silicon model != reference at {r['net']} {r['v']} V {r['source']}: {diff}")
    cifar = silicon_report(get_graph("cifar10_tnn"), v=0.5)
    print(f"[chip_smoke] quickstart: OK on the card; {launches} launches; "
          f"dvs_cnn_tcn fused == kernel == ref == bitsim on 2 clips x {N_FRAMES} frames, "
          f"bitsim stream == batch; {len(rows)} BENCH_silicon.json rows reproduced exactly "
          f"(CIFAR {cifar.energy_uj:.2f} uJ, {cifar.inf_per_s:.0f} inf/s)", flush=True)
    return launches


def _fleet_clips(g, n, duty, seed):
    """Seeded clips of ``n`` sensors x N_FRAMES frames from the net's own
    pipeline (DVS events for 2 channels, KWS spectrograms for 1)."""
    from repro_torch.data.pipeline import DVSEventPipeline, KWSSpectrogramPipeline

    cls = DVSEventPipeline if g.input_ch == 2 else KWSSpectrogramPipeline
    return cls(n, steps=N_FRAMES, hw=g.input_hw[0], n_classes=g.n_classes,
               seed=seed, duty_cycle=duty).next_batch()


def _lone_logits(program, clip, frame_idx, dev):
    """Final logits of a lone batch-1 `StreamSession` on ``program`` fed
    exactly ``frame_idx``'s frames (None when that is no frame)."""
    session = program.stream(batch=1, backend="fused")
    out = None
    for t in frame_idx:
        out = session.step(torch.from_numpy(clip[t][None]).to(dev))
    return None if out is None else out.cpu().numpy()[0]


def _run_fleet(programs, requests, ingest, gate=None):
    """One `FleetRouter` run on ``fused`` with ``programs`` registered.
    Counts K1 launches per bucket tick and the pool objects each rung
    shows.  Returns (router, results, wall seconds, per-bucket launches,
    per-bucket {rung: set of pool ids})."""
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import FleetRouter

    router = FleetRouter(backend="fused", max_pool_size=FLEET_CAP, ingest=ingest,
                         gate=gate)
    for name, program in programs.items():
        router.register(name, program)
    launches = {name: 0 for name in programs}
    pools_seen = {name: {} for name in programs}
    for name, bucket in router.buckets.items():
        def counted(tick=bucket.tick, name=name, bucket=bucket):
            before = ternary_conv2d_cuda.launches
            out = tick()
            launches[name] += ternary_conv2d_cuda.launches - before
            pools_seen[name].setdefault(bucket.size, set()).add(id(bucket.batcher.pool))
            return out
        bucket.tick = counted
    router.submit_many(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router.close()
    return router, results, wall, launches, pools_seen


def fleet_path(dev):
    """Phase 6: the deployment path at full width — ship two ``.cutie``
    programs, load them on the card, serve them through one gated and one
    ungated `FleetRouter`, then through the launcher.  Returns the ``fleet``
    report."""
    from repro_torch import artifact
    from repro_torch.api import get_net
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import ActivityGate, StreamRequest, energy_summary

    t_phase = time.perf_counter()
    loaded, clips, labels = {}, {}, {}
    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    for idx, (name, per_tick, ch, hw, in_ch, steps) in enumerate(FLEET_NETS):
        prog = get_net(name)
        g = prog.graph
        if (g.feature_channels, tuple(g.input_hw), g.input_ch, g.tcn_steps) != (ch, hw, in_ch, steps):
            fail(f"{name} is not at full width: {g}")
        clips[name], labels[name] = _fleet_clips(g, FLEET_SENSORS, 1.0, SEED + idx)
        deployed = prog.quantize(
            prog.init(torch.Generator().manual_seed(SEED), device=dev),
            calib=torch.from_numpy(clips[name]).to(dev))
        data = artifact.assemble(deployed)
        program = loaded[name] = artifact.loads(data, device=dev)
        if program.to_bytes() != data:
            fail(f"{name}: LoadedProgram.to_bytes() != the assembled bytes")
        if artifact.reassemble(artifact.disassemble(data)) != data:
            fail(f"{name}: disassemble -> reassemble is not byte-identical")
        (build_dir / f"chip_smoke_{name}.cutie").write_bytes(data)
        clip = torch.from_numpy(clips[name][:1]).to(dev)
        got = {b: program.forward(clip, backend=b) for b in ("fused", "ref", "bitsim")}
        want = deployed.forward(clip, backend="fused")
        for b, y in got.items():
            if not torch.equal(y, want):
                fail(f"{name}: loaded {b} != DeployedProgram fused on an {N_FRAMES}-frame "
                     f"clip: max|diff|={(y - want).abs().max().item()}")
        print(f"[chip_smoke] fleet: {name} -> {len(data)} .cutie bytes, loaded on the "
              f"card; to_bytes and dis/asm identical; fused == ref == bitsim == "
              f"deployed", flush=True)

    # the ungated fleet: two waves per net, the first overshooting the cap
    requests = []
    for idx, (name, *_rest) in enumerate(FLEET_NETS):
        for s in range(FLEET_SENSORS):
            arrival = idx + s // 4 if s < 12 else FLEET_WAVE2_TICK
            requests.append(StreamRequest(
                stream_id=f"{name}/sensor-{s}", frames=clips[name][s],
                label=int(labels[name][s]), arrival=arrival, net=name))
    ternary_conv2d_cuda.launches = 0
    router, results, wall, launches, pools_seen = _run_fleet(loaded, requests, "thread")
    total_launches = ternary_conv2d_cuda.launches
    stats = router.stats()
    n_streams = FLEET_SENSORS * len(FLEET_NETS)
    if len(results) != n_streams:
        fail(f"fleet: {len(results)}/{n_streams} streams completed")
    by_id = {r.stream_id: r for r in results}
    for r in results:
        if r.logits is None or not np.isfinite(r.logits).all():
            fail(f"fleet: {r.stream_id} logits missing or not finite")
        name, s = r.net, int(r.stream_id.rsplit("-", 1)[1])
        lone = _lone_logits(loaded[name], clips[name][s], range(N_FRAMES), dev)
        if not np.array_equal(r.logits, lone):
            fail(f"fleet: {r.stream_id} pooled logits != lone StreamSession")
    per_bucket = {}
    for name, per_tick, *_rest in FLEET_NETS:
        s = stats["nets"][name]
        reasons = [e["reason"] for e in s["scale_events"]]
        busy = len(router.buckets[name].batcher.latency_trace)
        if "grow" not in reasons or "shrink" not in reasons:
            fail(f"fleet: {name} scale events {reasons} lack a grow and a shrink")
        if any(n != 1 for n in s["pools_built"].values()):
            fail(f"fleet: {name} pools built {s['pools_built']} (1 per rung)")
        if any(len(ids) != 1 for ids in pools_seen[name].values()):
            fail(f"fleet: {name} ran more than one pool object on a rung")
        if set(pools_seen[name]) != set(s["pools_built"]):
            fail(f"fleet: {name} rungs seen {sorted(pools_seen[name])} != built")
        if any(tc > 1 for tc in s["pools_traced"].values()):
            fail(f"fleet: {name} step programs {s['pools_traced']} (<= 1 per pool)")
        if not s["ingest_threaded"]:
            fail(f"fleet: {name} feeder did not run on its thread")
        if launches[name] != per_tick * busy:
            fail(f"fleet: {name} made {launches[name]} K1 launches over {busy} "
                 f"busy ticks; expected {per_tick} per tick")
        per_bucket[name] = {
            "busy_ticks": busy, "k1_launches": launches[name],
            "k1_launches_per_tick": launches[name] / busy,
            "scale_events": [f"{e['from_size']}->{e['to_size']}@{e['tick']}"
                             for e in s["scale_events"]],
            "pools_built": s["pools_built"], "pools_traced": s["pools_traced"],
            "ms_per_tick_by_rung": {
                str(size): {"ticks": v["ticks"], "p50": v["p50_ms"], "p99": v["p99_ms"]}
                for size, v in s["latency_by_pool_size"].items()},
        }
    if total_launches != sum(launches.values()):
        fail(f"fleet: {total_launches} K1 launches in the run, "
             f"{sum(launches.values())} inside bucket ticks")
    frames = stats["aggregate"]["frames_processed"]
    _, sync_results, sync_wall, _, _ = _run_fleet(loaded, requests, "sync")
    for r in sync_results:
        if not np.array_equal(r.logits, by_id[r.stream_id].logits):
            fail(f"fleet: {r.stream_id} ingest=sync != ingest=thread")
    print(f"[chip_smoke] fleet: {n_streams} streams x {N_FRAMES} frames over "
          f"{stats['aggregate']['ticks']} ticks, {wall:.3f} s -> {frames / wall:.1f} "
          f"frames/s (ingest=sync: {frames / sync_wall:.1f}); == lone sessions; sync == thread; "
          + "; ".join(f"{n}: {b['scale_events']}, K1 {b['k1_launches_per_tick']:.0f}/tick"
                      for n, b in per_bucket.items()), flush=True)

    # the gated fleet: bursty traces, ActivityGate(16, 4, 2)
    gate = ActivityGate(16, 4, 2)
    g_clips, g_requests = {}, []
    for idx, (name, *_rest) in enumerate(FLEET_NETS):
        g_clips[name], g_labels = _fleet_clips(loaded[name].graph, GATED_SENSORS,
                                               GATED_DUTY, SEED + 10 + idx)
        for s in range(GATED_SENSORS):
            g_requests.append(StreamRequest(
                stream_id=f"{name}/gated-{s}", frames=g_clips[name][s],
                label=int(g_labels[s]), arrival=idx + s * len(FLEET_NETS), net=name))
    ternary_conv2d_cuda.launches = 0
    g_router, g_results, g_wall, g_launches, _ = _run_fleet(loaded, g_requests, "thread", gate)
    g_stats = g_router.stats()
    if len(g_results) != GATED_SENSORS * len(FLEET_NETS):
        fail(f"gated fleet: {len(g_results)} streams completed")
    for r in g_results:
        name, s = r.net, int(r.stream_id.rsplit("-", 1)[1])
        clip = g_clips[name][s]
        plan = gate.plan([ActivityGate.activity(f) for f in clip])
        processed = [t for t, p in enumerate(plan) if p]
        if r.frames_processed != len(processed):
            fail(f"gated fleet: {r.stream_id} processed {r.frames_processed} frames, "
                 f"plan says {len(processed)}")
        lone = _lone_logits(loaded[name], clip, processed, dev)
        if (lone is None) != (r.logits is None) or (
                lone is not None and not np.array_equal(r.logits, lone)):
            fail(f"gated fleet: {r.stream_id} != a lone session fed the plan's frames")
    energy = {}
    for name, per_tick, *_rest in FLEET_NETS:
        sg = g_stats["nets"][name]["gating"]
        busy = len(g_router.buckets[name].batcher.latency_trace)
        if g_launches[name] != per_tick * busy:
            fail(f"gated fleet: {name} made {g_launches[name]} K1 launches over "
                 f"{busy} busy ticks")
        e = energy_summary(
            loaded[name], frames_processed=sg["frames_processed"],
            frames_total=sg["frames_processed"] + sg["frames_skipped"],
            completed=sum(1 for r in g_results if r.net == name and r.logits is not None))
        if not e["energy_uj_saved"] > 0.0:
            fail(f"gated fleet: {name} saves no energy ({e['energy_uj_saved']} uJ)")
        energy[name] = {
            "frames_processed": sg["frames_processed"],
            "frames_skipped": sg["frames_skipped"], "parks": sg["parks"],
            "wakes": sg["wakes"], "busy_ticks": busy,
            "k1_launches_per_tick": g_launches[name] / busy,
            "silicon_model_uj_saved": e["energy_uj_saved"],
            "silicon_model_uj_per_classification": e["energy_uj_per_classification"],
            "silicon_model_uj_per_classification_ungated":
                e["energy_uj_per_classification_ungated"],
        }
    g_frames = g_stats["aggregate"]["frames_processed"]
    print(f"[chip_smoke] gated fleet: {g_frames} frames processed, "
          f"{g_stats['gating']['frames_skipped']} skipped, {g_wall:.3f} s; processed == "
          f"plan, == lone sessions; silicon-model uJ saved "
          + ", ".join(f"{n} {e['silicon_model_uj_saved']:.3f}" for n, e in energy.items()),
          flush=True)

    # the launcher, as a user runs it
    dvs_file = build_dir / f"chip_smoke_{FLEET_NETS[0][0]}.cutie"
    for argv in (["--dvs", "--program", str(dvs_file), "--pool", str(FLEET_CAP)],
                 ["--fleet", "--fleet-nets", ",".join(n for n, *_ in FLEET_NETS),
                  "--pool", str(FLEET_CAP), "--gate"]):
        rc = launch_serve.main(argv + ["--device", "cuda", "--seed", str(SEED)])
        if rc != 0:
            fail(f"repro_torch.launch.serve {' '.join(argv)} exited {rc}")
    print("[chip_smoke] fleet: launcher --dvs --program and --fleet --gate exit 0",
          flush=True)
    return {
        "nets": [n for n, *_ in FLEET_NETS], "ladder_cap": FLEET_CAP,
        "ungated": {
            "streams": n_streams, "frames": frames, "ticks": stats["aggregate"]["ticks"],
            "wall_s": wall, "frames_per_s": frames / wall,
            "sync_ingest_wall_s": sync_wall, "sync_ingest_frames_per_s": frames / sync_wall,
            "k1_launches": total_launches, "buckets": per_bucket,
        },
        "gated": {
            "streams": len(g_results), "frames_processed": g_frames,
            "frames_skipped": g_stats["gating"]["frames_skipped"],
            "ticks": g_stats["aggregate"]["ticks"], "wall_s": g_wall,
            "frames_per_s": g_frames / g_wall, "buckets": energy,
        },
        "phase_s": time.perf_counter() - t_phase,
    }


def _check_width(graph, spec):
    name, _per_eval, ch, hw, in_ch, n_conv, n_tcn = spec
    kinds = [l.kind for l in graph.layers]
    got = (graph.feature_channels if graph.is_temporal else
           max(l.c_out for l in graph.layers if l.kind == "conv2d"),
           tuple(graph.input_hw), graph.input_ch, kinds.count("conv2d"), kinds.count("tcn"))
    if got != (ch, hw, in_ch, n_conv, n_tcn):
        fail(f"{name} is not at full width: {got}")


def _fwd_bwd_ms(prog, params, batch, deterministic: bool) -> float:
    """Host ms per QAT forward + backward (each ends in a synchronise) with
    cuDNN deterministic and not autotuned (the trainer's setting, see
    `kernels.ref.deterministic_float32`) or autotuned and free to pick any
    algorithm; TF32 off in both."""
    from repro_torch.train import cross_entropy
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    x, y = (torch.from_numpy(a).to(leaves[0].device) for a in batch)
    flags = (dict(benchmark=False, deterministic=True) if deterministic
             else dict(benchmark=True, deterministic=False))

    def once():
        loss = cross_entropy(prog.forward_qat(tree_unflatten(params, leaves), x), y)
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, **flags):
        for _ in range(3):
            once()
        t0 = time.perf_counter()
        for _ in range(DETERMINISM_STEPS):
            once()
        return (time.perf_counter() - t0) / DETERMINISM_STEPS * 1e3


def train_path(dev):
    """Phase 7: the training path at full width, then a resume on the card
    and the launcher with its trace.  Returns (the ``train`` report, K1
    launches of the full-width spatial run)."""
    import dataclasses

    from repro_torch.api import CutieProgram, get_graph
    from repro_torch.data.pipeline import pipeline_for_net
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.launch.train import SMOKE_GAP_BOUND, smoke_recipe
    from repro_torch.obs import load, validate_nesting
    from repro_torch.train import cross_entropy, init_train_state, train
    from repro_torch.train.evaluate import eval_batches
    from repro_torch.tree import tree_leaves, tree_unflatten

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    quiet = lambda *_: None  # noqa: E731
    out = {"nets": {}}

    def run(spec, **kw):
        name, per_eval = spec[0], spec[1]
        _check_width(get_graph(name), spec)
        ternary_conv2d_cuda.launches = 0
        rep = train(name, seed=SEED, ckpt_dir=root / name, backend="fused",
                    device="cuda", log=quiet, **kw)
        launches = ternary_conv2d_cuda.launches
        if not rep.losses or not all(np.isfinite(rep.losses)):
            fail(f"train {name}: a loss is not finite: {rep.losses[:5]} ...")
        n_eval = kw.get("eval_batches", 4)
        # constant schedules: no segment eval, so every launch is the final
        # eval's deployed forward
        if rep.evals or launches != per_eval * n_eval:
            fail(f"train {name}: {launches} K1 launches over {n_eval} eval batches; "
                 f"the deployed forward makes {per_eval} per batch")
        n = len(rep.losses)
        q = max(n // 4, 1)
        e = rep.final_eval
        out["nets"][name] = {
            "steps": n, "batch": kw["batch"], "lr": kw["lr"],
            "ms_per_step": rep.ms_per_step, "wall_s": rep.wall_s,
            "loss_first_quarter_mean": sum(rep.losses[:q]) / q,
            "loss_last_quarter_mean": sum(rep.losses[-q:]) / q,
            "loss_decreased": rep.loss_decreased, "qat_accuracy": e.qat_accuracy,
            "deployed_accuracy": e.deployed_accuracy, "gap": e.gap,
            "eval_examples": e.n_examples, "k1_launches": launches,
            "k1_launches_per_eval_batch": launches / n_eval, "restarts": rep.restarts,
        }
        print(f"[chip_smoke] train: {name} {n} steps x batch {kw['batch']}, "
              f"{rep.ms_per_step:.2f} ms/step, loss {out['nets'][name]['loss_first_quarter_mean']:.4f}"
              f" -> {out['nets'][name]['loss_last_quarter_mean']:.4f}, {e.summary()}, "
              f"{launches} K1 launches", flush=True)
        return rep, launches

    # full-width spatial: the launcher's smoke recipe, gated as the launcher gates it
    recipe = smoke_recipe(TRAIN_SPATIAL[0])
    rep, k1_spatial = run(TRAIN_SPATIAL, eval_batches=TRAIN_EVAL_BATCHES, **recipe)
    failures = rep.gate(SMOKE_GAP_BOUND)
    if failures:
        fail(f"train {TRAIN_SPATIAL[0]}: smoke gate: {'; '.join(failures)}")
    pipe = pipeline_for_net(get_graph(TRAIN_SPATIAL[0]), recipe["batch"], seed=SEED)
    x_eval = torch.from_numpy(eval_batches(pipe, 1)[0][0]).to(dev)
    fused = rep.deployed.forward(x_eval, backend="fused")
    ref = rep.deployed.forward(x_eval, backend="ref")
    if not torch.equal(fused, ref):
        fail(f"train {TRAIN_SPATIAL[0]}: trained fused != ref: "
             f"max|diff|={(fused - ref).abs().max().item()}")

    # full-width temporal: every layer takes a finite, non-zero gradient at step 1
    name = TRAIN_TEMPORAL[0]
    graph = dataclasses.replace(get_graph(name), qat_per_channel=True)
    prog = CutieProgram(graph)
    state = init_train_state(prog, torch.Generator().manual_seed(SEED), device=dev)
    xb, yb = pipeline_for_net(graph, TRAIN_TEMPORAL_RECIPE["batch"], seed=SEED).batch_at(0)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(state["params"])]
    loss = cross_entropy(prog.forward_qat(tree_unflatten(state["params"], leaves),
                                          torch.from_numpy(xb).to(dev)),
                         torch.from_numpy(yb).to(dev))
    grads = torch.autograd.grad(loss, leaves)
    for i, g in enumerate(grads):
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            fail(f"train {name}: gradient leaf {i} {tuple(g.shape)} not finite or all zero")
    run(TRAIN_TEMPORAL, eval_batches=1, **TRAIN_TEMPORAL_RECIPE)
    out["nets"][name]["grad_leaves_nonzero_at_step_1"] = len(grads)

    # resume on the card: 8 straight == 4 + restore + 4, bit for bit
    kw = dict(steps=8, batch=8, lr=1e-3, seed=3, ckpt_every=4, eval_batches=1,
              device="cuda", log=quiet)
    full = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_a", **kw)
    half = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_b", **{**kw, "steps": 4})
    resumed = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_b", **kw)
    if half.losses != full.losses[:4] or resumed.losses != full.losses[4:]:
        fail(f"resume on the card: losses differ {full.losses} vs "
             f"{half.losses} + {resumed.losses}")
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        if not torch.equal(a, b):
            fail("resume on the card: params after 4 + restore + 4 != 8 straight")
    print("[chip_smoke] train: resume on the card bit-identical (8 steps == 4 + restore + 4)",
          flush=True)

    # the cost of the deterministic cuDNN settings, in turns
    sprog = CutieProgram(dataclasses.replace(get_graph(TRAIN_SPATIAL[0]), qat_per_channel=True))
    sstate = init_train_state(sprog, torch.Generator().manual_seed(SEED), device=dev)
    sbatch = pipeline_for_net(sprog.graph, recipe["batch"], seed=SEED).batch_at(0)
    det, fast = [], []
    for deterministic in (True, False, False, True):
        (det if deterministic else fast).append(
            _fwd_bwd_ms(sprog, sstate["params"], sbatch, deterministic))
    out["fwd_bwd_ms_deterministic"] = det
    out["fwd_bwd_ms_autotuned"] = fast
    print(f"[chip_smoke] train: {TRAIN_SPATIAL[0]} QAT forward+backward {det} ms with "
          f"deterministic cuDNN, {fast} ms autotuned (host clock, {DETERMINISM_STEPS} "
          f"each, in turns)", flush=True)

    # the launcher as a user runs it, then the trace CLI
    trace = root / "train_trace.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for argv in (["-m", "repro_torch.launch.train", "--net", "cifar10_tnn_smoke", "--smoke",
                  "--trace", str(trace), "--ckpt-dir", str(root / "launcher"),
                  "--device", "cuda"],
                 ["-m", "repro_torch.obs", "summarize", str(trace)]):
        res = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"python {' '.join(argv)} exited {res.returncode}:\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        print(f"[chip_smoke] train: python {' '.join(argv[:2])} ... exit 0: "
              f"{res.stdout.strip().splitlines()[-1]}", flush=True)
    problems = validate_nesting(load(str(trace)))
    if problems:
        fail(f"train trace does not nest: {problems[:3]}")
    out["k1_launches"] = sum(n["k1_launches"] for n in out["nets"].values())
    out["restarts"] = sum(n["restarts"] for n in out["nets"].values())
    out["resume_bit_identical"] = True
    out["launcher_trace_nests"] = True
    out["phase_s"] = time.perf_counter() - t_phase
    return out, k1_spatial


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

    # phase 3: each kernel against its plain version, then times
    exact_err, gauss_err = check_kernel(dev)
    total, per_shape = time_kernel(dev)
    mm_err_f32, mm_err_bf16 = check_matmul(dev)
    mm_rows = time_matmul(dev)
    check_determinism(dev)

    # phase 4: the serving path
    launches, serving = serve_main_path(dev)

    # phase 5: the quickstart path
    qs_launches = quickstart_path(dev)

    # phase 6: the deployment path
    fleet = fleet_path(dev)

    # phase 7: the training path
    train_report, k1_train = train_path(dev)

    # phase 8: results
    mm = mm_rows[0]  # the quickstart's launch: 64x2048x512 float32
    kernels = {"kernels": [{
        "name": "ternary_conv2d", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(exact_err, gauss_err), "max_abs_err_exact_data": exact_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": total["bound_by"], "library_ms": total["library_ms"],
        "ms_over_library": total["ms"] / total["library_ms"],
        "launches_cover": "the serving path (16 streams x 8 frames, pool 8)",
        "launches_quickstart": qs_launches["ternary_conv2d"],
        "launches_fleet": fleet["ungated"]["k1_launches"],
        "launches_train": k1_train,
        "launches_train_cover": "the final deployed eval of the full-width cifar10_tnn run",
        "times_cover": "the 9 launches of one pool tick at pool size 8 (sum)",
        "shapes": per_shape,
    }, {
        "name": "ternary_matmul", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": qs_launches["ternary_matmul"],
        "max_abs_err": mm_err_f32, "max_abs_err_bf16": mm_err_bf16,
        "ms": mm["ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
        "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
        "ms_over_library": mm["ms"] / mm["library_ms"],
        "launches_cover": "the quickstart path",
        "times_cover": "one launch at the quickstart shape 64x2048x512, float32",
        "shapes": mm_rows,
    }]}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"train": train_report}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
