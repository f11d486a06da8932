#!/usr/bin/env python3
"""Where one launch of the fused ternary conv kernel spends its time, on one GPU.

    python3 benchmarks/kernel_ablate_torch.py

Builds `src/repro_torch/csrc/ternary_conv2d.cu` six times, with the phases of
its main loop compiled out through the source's ``TCONV_ABLATE_*`` macros
(weight decode, input-patch staging, FMA walk), and times each variant on
launch shapes of the serving path at pool size 8 (fused int8 variant).  An
ablated build computes wrong results by design — only its time is read.

Timing is device time: CUDA events around 100 launches enqueued behind a
spin kernel.  Prints the card's name and power limit first, one
line per shape, and one JSON object last.  A CUDA device and nvcc are
required.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

VARIANTS = {
    "full": (),
    "no_fma": ("-DTCONV_ABLATE_FMA",),
    "no_stage": ("-DTCONV_ABLATE_STAGE",),
    "no_decode": ("-DTCONV_ABLATE_DECODE",),
    "fma_only": ("-DTCONV_ABLATE_STAGE", "-DTCONV_ABLATE_DECODE"),
    "empty_loop": ("-DTCONV_ABLATE_STAGE", "-DTCONV_ABLATE_DECODE", "-DTCONV_ABLATE_FMA"),
}
# (name, H, W, C_in, C_out, pool, input dtype) at B = 8, 3x3
SHAPES = [
    ("conv0", 64, 64, 4, 64, 2, torch.float32),
    ("conv1", 32, 32, 64, 64, 2, torch.int8),
    ("conv3", 8, 8, 96, 96, 2, torch.int8),
    ("tcn_d1", 25, 1, 96, 96, 0, torch.float32),
    ("tcn_d8", 4, 8, 96, 96, 0, torch.int8),
]
BATCH = 8


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablate_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.ternary import pack_ternary
    from repro_torch.kernels import build
    from repro_torch.kernels.ternary_conv2d import SOURCE, _bind, tile_shape

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    out_dir = build.build_dir() / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"{name}.so"
        proc = subprocess.run(build.compile_command(SOURCE, lib, flags),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        fns[name] = _bind(ctypes.CDLL(str(lib)))

    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, h, w, c_in, c_out, pool, dt in SHAPES:
        x = torch.randint(-1, 2, (BATCH, h, w, c_in), generator=gen).to(dt).cuda()
        t = torch.randint(-1, 2, (3, 3, c_in, c_out), generator=gen).to(torch.int8)
        wp = pack_ternary(t, axis=2).cuda()
        scale = torch.ones(c_out, device="cuda")
        thr = torch.ones(c_out, device="cuda")
        p = max(pool, 1)
        out = torch.empty((BATCH, h // p, w // p, c_out), dtype=torch.int8, device="cuda")
        th, tw = tile_shape(h, w, pool)
        row = {"shape": name}
        for variant, fn in fns.items():
            def launch():
                rc = fn(x.data_ptr(), int(dt == torch.int8), wp.data_ptr(), scale.data_ptr(),
                        thr.data_ptr(), out.data_ptr(), 1, BATCH, h, w, c_in, 3, 3, c_out,
                        th, tw, 1, pool, stream)
                if rc != 0:
                    raise RuntimeError(f"{variant} launch refused at {name}: code {rc}")

            for _ in range(5):
                launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)  # the host enqueues 100 launches meanwhile
            start.record()
            for _ in range(100):
                launch()
            stop.record()
            torch.cuda.synchronize()
            row[variant + "_us"] = start.elapsed_time(stop) / 100 * 1e3
        rows.append(row)
        print(name, " | ".join(f"{k[:-3]} {v:.1f} us" for k, v in row.items()
                               if k != "shape"), flush=True)
    print(json.dumps({"card": card, "batch": BATCH, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
