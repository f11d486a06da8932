#!/usr/bin/env python3
"""Where one launch of each hand-written kernel spends its time, on one GPU.

    python3 benchmarks/kernel_ablate_torch.py

Builds each kernel source several times, with one phase compiled out at a
time through the source's ablation macros, and times every variant on the
launch shapes of the port's paths:

  * K1, `csrc/ternary_conv2d.cu` (``TCONV_ABLATE_*``): operand staging
    (the `cp.async` copies of the patch and the packed weights), fragment
    decode (packed byte -> trits in registers), the mma walk, the epilogue
    (partial-tile sum, scale, ternarize, pool, store) of its mma.sync route
    (route 0; the wgmma route has no ablation macros) — on a pool tick's
    launch shapes at pool size 8, fused int8 variant;
  * K2, `csrc/ternary_matmul.cu` (``TMM_ABLATE_*``): staging, fragment
    decode, the mma walk, the cross-split reduction through distributed
    shared memory — at the quickstart and kernel-bench shapes, float32 and
    bf16 x.

An ablated build computes wrong results by design: only its time is read.
"none" is the whole kernel; "all" compiles every phase out and leaves the
launch, the index arithmetic and the barriers.

Timing is device time: CUDA events around 100 launches enqueued behind a
spin kernel.  Prints the card's name and power limit first, one line per
shape, and one JSON object last.  A CUDA device and nvcc are required.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

PHASES = ("STAGE", "DECODE", "MMA", "EPILOGUE")
# variant name -> phases compiled out
VARIANTS = {"none": (), **{f"no_{p.lower()}": (p,) for p in PHASES}, "all": PHASES}
# (name, H, W, C_in, C_out, pool, input dtype) at B = 8, 3x3
CONV_SHAPES = [
    ("conv0", 64, 64, 4, 64, 2, torch.float32),
    ("conv1", 32, 32, 64, 64, 2, torch.int8),
    ("conv3", 8, 8, 96, 96, 2, torch.int8),
    ("conv4", 4, 4, 96, 96, 2, torch.int8),
    ("tcn_d1", 25, 1, 96, 96, 0, torch.float32),
    ("tcn_d8", 4, 8, 96, 96, 0, torch.int8),
]
MATMUL_SHAPES = [(64, 2048, 512), (512, 2048, 512)]
BATCH = 8


def device_us(launch, iters: int = 100) -> float:
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # the host enqueues the launches meanwhile
    start.record()
    for _ in range(iters):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters * 1e3


def build_variants(build, source: str, prefix: str):
    """One library per variant, all nvcc runs started together."""
    out_dir = build.build_dir() / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, phases = item
        lib = out_dir / f"{Path(source).stem}_{name}.so"
        flags = tuple(f"-D{prefix}_ABLATE_{p}" for p in phases)
        proc = subprocess.run(build.compile_command(source, lib, flags),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} {name}:\n{proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as ex:
        return dict(ex.map(one, VARIANTS.items()))


def ablate_conv(libs, stream) -> list:
    from repro_torch.core.ternary import pack_ternary
    from repro_torch.kernels.ternary_conv2d import _bind, _mma_plan

    fns = {name: _bind(ctypes.CDLL(str(lib))) for name, lib in libs.items()}
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, h, w, c_in, c_out, pool, dt in CONV_SHAPES:
        x = torch.randint(-1, 2, (BATCH, h, w, c_in), generator=gen).to(dt).cuda()
        t = torch.randint(-1, 2, (3, 3, c_in, c_out), generator=gen).to(torch.int8)
        wp = pack_ternary(t, axis=2).cuda()
        scale = torch.ones(c_out, device="cuda")
        thr = torch.ones(c_out, device="cuda")
        p = max(pool, 1)
        out = torch.empty((BATCH, h // p, w // p, c_out), dtype=torch.int8, device="cuda")
        plan = _mma_plan(BATCH, h, w, c_in, c_out, 3, 3, pool, dt)  # the ablated route
        row = {"kernel": "ternary_conv2d", "shape": name, "tile": [plan.tile_h, plan.tile_w],
               "blocks": plan.blocks}
        for variant, fn in fns.items():
            def launch():
                rc = fn(x.data_ptr(), int(dt == torch.int8), wp.data_ptr(), scale.data_ptr(),
                        thr.data_ptr(), out.data_ptr(), 1, BATCH, h, w, c_in, 3, 3, c_out,
                        *plan, 1, pool, stream)
                if rc != 0:
                    raise RuntimeError(f"{variant} launch refused at {name}: code {rc}")

            row[variant + "_us"] = device_us(launch)
        rows.append(row)
        print(f"K1 {name:7s}", " | ".join(f"{v[:-3]} {row[v]:.2f} us" for v in row
                                          if v.endswith("_us")), flush=True)
    return rows


def ablate_matmul(libs, stream) -> list:
    from repro_torch.core.ternary import pack_ternary
    from repro_torch.kernels.ternary_matmul import _bind, matmul_plan

    fns = {name: _bind(ctypes.CDLL(str(lib))) for name, lib in libs.items()}
    gen = torch.Generator().manual_seed(1)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in MATMUL_SHAPES:
            x = torch.randn((m, k), generator=gen).to(dt).cuda()
            t = torch.randint(-1, 2, (k, n), generator=gen).to(torch.int8)
            wp = pack_ternary(t, axis=0).cuda()
            scale = torch.ones(n, device="cuda")
            out = torch.empty((m, n), dtype=dt, device="cuda")
            plan = matmul_plan(m, k, n, dt)
            row = {"kernel": "ternary_matmul", "shape": [m, k, n],
                   "x_dtype": str(dt).split(".")[-1], "splits": plan.splits,
                   "blocks": plan.blocks(m, n)}
            for variant, fn in fns.items():
                def launch():
                    rc = fn(x.data_ptr(), int(dt == torch.bfloat16), wp.data_ptr(),
                            scale.data_ptr(), out.data_ptr(), m, k, n, plan.block_m,
                            plan.block_n, plan.k_split, plan.splits, stream)
                    if rc != 0:
                        raise RuntimeError(f"{variant} launch refused at {(m, k, n)}: code {rc}")

                row[variant + "_us"] = device_us(launch)
            rows.append(row)
            print(f"K2 {m}x{k}x{n} {row['x_dtype']:8s}",
                  " | ".join(f"{v[:-3]} {row[v]:.2f} us" for v in row if v.endswith("_us")),
                  flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablate_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    with ThreadPoolExecutor(max_workers=2) as ex:
        conv_libs = ex.submit(build_variants, build, "ternary_conv2d.cu", "TCONV")
        mm_libs = ex.submit(build_variants, build, "ternary_matmul.cu", "TMM")
        conv_libs, mm_libs = conv_libs.result(), mm_libs.result()
    stream = torch.cuda.current_stream().cuda_stream
    rows = ablate_conv(conv_libs, stream) + ablate_matmul(mm_libs, stream)
    print(json.dumps({"card": card, "batch": BATCH, "variants": {k: list(v) for k, v in
                                                                  VARIANTS.items()},
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
