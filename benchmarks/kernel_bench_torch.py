"""Kernel microbenchmarks of the PyTorch/CUDA port: packed kernels vs dense
unpacked, on the card by default.

Counterpart of ``benchmarks/kernel_bench.py`` with its cells, flags, gate
and JSON row schema; ``pallas_interp_us`` becomes ``plain_us``.  Per cell it
times three implementations of the same layer math:

  * **dense** — `torch.matmul` / `F.conv2d` (channels-last) on the unpacked
    float weights times the scale, plus the fused cells' threshold and
    max-pool in plain torch, TF32 off: the unpacked baseline, timed under
    two cuDNN settings — autotuned (``benchmark=True``, any algorithm) and
    deterministic (no autotuning, the QAT step's) — and ``dense_us`` is the
    faster, so the yardstick is the library at its best in true float32;
  * **packed** — `repro_torch.kernels.ternary_matmul` / `ternary_conv2d`
    on the trit-packed uint8 bytes: kernel K2 / K1 on a CUDA tensor;
  * **plain** — the kernel's plain PyTorch version (``*_native``) on the
    same device.

Timing is **interleaved**: one warm-up per implementation, then samples
taken round-robin (dense, packed, plain, dense, ...), the median reported.
On the card one sample is CUDA events around 50 back-to-back calls,
enqueued behind a spin kernel that outlasts the host's enqueue,
divided by the count: device time, not the host's enqueue rate.  On the CPU
one sample is the host clock around one call.

Each cell carries the gate the exit code follows: ``bit_exact`` is packed
== the ``kernels.ref`` oracle **bit for bit on ternary inputs** (the deploy
regime), and ``max_err_float`` the error on Gaussian float32 inputs.  The
``weight_bytes_*`` columns record the 8x table-size reduction of the packed
format.  Inputs come from ``--seed`` through `numpy.random.default_rng`.

    python3 benchmarks/kernel_bench_torch.py                 # full cells -> BENCH_kernels_torch.json
    python3 benchmarks/kernel_bench_torch.py --smoke         # tiny cells -> BENCH_kernels_torch.smoke.json
    python3 benchmarks/kernel_bench_torch.py --smoke --device cpu --out /tmp/k.json

Gate it with ``python3 scripts/check_bench_regression.py --kernels BASE FRESH``.
Exit codes: 0 ok, 1 a cell is not bit-exact.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.ternary import packed_nbytes, unpack_ternary  # noqa: E402
from repro_torch.device import device_meta, resolve_device  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    quantize_pack_conv_weights,
    quantize_pack_matmul_weights,
    ternary_conv2d,
    ternary_matmul,
)
from repro_torch.kernels.ref import (  # noqa: E402
    deterministic_float32,
    ternary_conv2d_ref,
    ternary_matmul_ref,
)
from repro_torch.kernels.ternary_conv2d import ternary_conv2d_native  # noqa: E402
from repro_torch.kernels.ternary_matmul import ternary_matmul_native  # noqa: E402

# (m, k, n) matmul / (b, hw, c_in, c_out, pool) conv cells — the reference's
FULL_MATMULS = [(512, 2048, 512)]
SMOKE_MATMULS = [(128, 512, 128)]
FULL_CONVS = [(1, 32, 96, 96, 0), (4, 32, 96, 96, 0), (1, 32, 96, 96, 2)]
SMOKE_CONVS = [(1, 16, 8, 8, 0), (2, 16, 8, 8, 2)]
REPEATS, SMOKE_REPEATS = 30, 7  # interleaved timing rounds
LAUNCHES = 50  # calls per timed sample on the card
THRESHOLD = 0.5


# the dense yardstick's cuDNN settings, each timed
DENSE_SETTINGS = ("autotuned", "deterministic")


@contextlib.contextmanager
def autotuned_float32():
    """The dense yardstick's settings: cuDNN on, autotuning
    (``benchmark=True``) over every algorithm, deterministic or not; TF32
    off for convolutions and matmuls.  Restores the previous settings."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sampler(fn, dev: torch.device):
    """A function returning one timing sample of ``fn`` in seconds per call."""
    if dev.type != "cuda":
        def host_sample() -> float:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return host_sample
    # the host's enqueue time of LAUNCHES calls bounds the spin needed to
    # keep the card from starting before the last call is enqueued
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        fn()
    spin_cycles = int((time.perf_counter() - t0) * 1.5 * 2.0e9) + 1_000_000  # <= 2 GHz
    _sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def device_sample() -> float:
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / LAUNCHES * 1e-3

    return device_sample


def _interleaved_time(fns: dict, repeats: int, dev: torch.device) -> dict:
    """Median seconds per call of each implementation, samples taken
    round-robin across them after one warm-up call each."""
    for fn in fns.values():
        fn()
    _sync(dev)
    samplers = {name: _sampler(fn, dev) for name, fn in fns.items()}
    samples = {name: [] for name in fns}
    for _ in range(repeats):
        for name, sample in samplers.items():
            samples[name].append(sample())
    return {name: statistics.median(s) for name, s in samples.items()}


def _traffic(shape, axis: int) -> dict:
    dense = int(np.prod(shape)) * 2  # bf16 dense table
    packed = packed_nbytes(shape, axis=axis)
    return {
        "weight_bytes_dense_bf16": dense,
        "weight_bytes_packed": packed,
        "bytes_reduction": dense / packed,
    }


def _dense_under(dense, setting: str):
    """``dense`` run under one of `DENSE_SETTINGS`."""
    ctx = autotuned_float32 if setting == "autotuned" else deterministic_float32

    def run():
        with ctx():
            return dense()
    return run


def _row(name, kind, times, bit_exact, max_err_float, traffic) -> dict:
    dense = min(times[f"dense_{s}"] for s in DENSE_SETTINGS)
    return {
        "name": name,
        "kind": kind,
        "dense_us": dense * 1e6,
        **{f"dense_{s}_us": times[f"dense_{s}"] * 1e6 for s in DENSE_SETTINGS},
        "packed_us": times["packed"] * 1e6,
        "plain_us": times["plain"] * 1e6,
        "speedup_packed_vs_unpacked": dense / times["packed"],
        "bit_exact": bit_exact,
        "max_err_float": max_err_float,
        **traffic,
    }


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def bench_matmul(m: int, k: int, n: int, repeats: int, dev: torch.device,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng([seed, m, k, n])
    x = _tensor(rng.standard_normal((m, k)), dev)
    w = _tensor(rng.standard_normal((k, n)), dev)
    xt = _tensor(np.sign(rng.standard_normal((m, k))), dev)
    wp, sc = quantize_pack_matmul_weights(w)
    wf = unpack_ternary(wp, axis=0)[:k].to(torch.float32) * sc  # dense unpacked

    def dense():
        return x @ wf

    times = _interleaved_time({
        **{f"dense_{s}": _dense_under(dense, s) for s in DENSE_SETTINGS},
        "packed": lambda: ternary_matmul(x, wp, sc),
        "plain": lambda: ternary_matmul_native(x, wp, sc),
    }, repeats, dev)

    # the deploy regime: ternary inputs must be bit-equal to the ref oracle
    bit_exact = bool(torch.equal(ternary_matmul(xt, wp, sc), ternary_matmul_ref(xt, wp, sc)))
    err = float((ternary_matmul(x, wp, sc) - ternary_matmul_ref(x, wp, sc)).abs().max())
    return _row(f"ternary_matmul_{m}x{k}x{n}", "matmul",
                times, bit_exact, err, _traffic((k, n), axis=0))


def bench_conv(b: int, hw: int, cin: int, cout: int, pool: int, repeats: int,
               dev: torch.device, seed: int = 0) -> dict:
    rng = np.random.default_rng([seed, b, hw, cin, cout, pool])
    x = _tensor(rng.standard_normal((b, hw, hw, cin)), dev)
    w = _tensor(rng.standard_normal((3, 3, cin, cout)), dev)
    xt = _tensor(np.sign(rng.standard_normal((b, hw, hw, cin))), dev)
    wp, sc = quantize_pack_conv_weights(w)
    # OIHW weights in channels-last memory: with x's NHWC memory read as
    # NCHW, the dense yardstick pays no layout permutes
    wf = (unpack_ternary(wp, axis=2)[:, :, :cin].to(torch.float32)
          .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))
    scale = sc.reshape(1, -1, 1, 1)
    thr = torch.full((cout,), THRESHOLD, dtype=torch.float32, device=dev)
    fused = pool > 0  # fused cells time the whole CUTIE layer epilogue

    def dense():
        y = F.conv2d(x.permute(0, 3, 1, 2), wf, padding=1) * scale
        if fused:
            t = torch.where(y.abs() > THRESHOLD, torch.sign(y), torch.zeros_like(y))
            y = F.max_pool2d(t, pool).to(torch.int8)
        return y.permute(0, 2, 3, 1)

    kw = dict(fuse_ternary=True, fuse_pool=pool, out_dtype=torch.int8) if fused else {}
    times = _interleaved_time({
        **{f"dense_{s}": _dense_under(dense, s) for s in DENSE_SETTINGS},
        "packed": lambda: ternary_conv2d(x, wp, sc, **kw),
        "plain": lambda: ternary_conv2d_native(x, wp, sc, thr, **kw),
    }, repeats, dev)

    bit_exact = bool(torch.equal(ternary_conv2d(xt, wp, sc, **kw),
                                 ternary_conv2d_ref(xt, wp, sc, **kw)))
    if fused:
        err = 0.0 if bit_exact else float("inf")  # int8 outputs: exactness only
    else:
        err = float((ternary_conv2d(x, wp, sc) - ternary_conv2d_ref(x, wp, sc)).abs().max())
    tag = f"ternary_conv2d_{b}x{hw}x{hw}x{cin}->{cout}" + (f"_fused_pool{pool}" if fused else "")
    return _row(tag, "conv2d_fused" if fused else "conv2d",
                times, bit_exact, err, _traffic((3, 3, cin, cout), axis=2))


def run(args) -> int:
    dev = resolve_device(args.device)
    matmuls = SMOKE_MATMULS if args.smoke else FULL_MATMULS
    convs = SMOKE_CONVS if args.smoke else FULL_CONVS
    repeats = args.repeats or (SMOKE_REPEATS if args.smoke else REPEATS)

    results = []
    with torch.no_grad():
        for m, k, n in matmuls:
            results.append(bench_matmul(m, k, n, repeats, dev, args.seed))
        for b, hw, cin, cout, pool in convs:
            results.append(bench_conv(b, hw, cin, cout, pool, repeats, dev, args.seed))

    failures = []
    for r in results:
        print(f"[kbench] {r['name']:>42s}: dense {r['dense_us']:9.2f} us "
              f"(autotuned {r['dense_autotuned_us']:.2f}, deterministic "
              f"{r['dense_deterministic_us']:.2f})  "
              f"packed {r['packed_us']:9.2f} us  plain {r['plain_us']:9.2f} us  "
              f"x{r['speedup_packed_vs_unpacked']:.2f}  bit_exact={r['bit_exact']}",
              flush=True)
        if not r["bit_exact"]:
            failures.append(f"{r['name']}: packed output differs from ref on "
                            "ternary inputs (bit-exactness contract broken)")

    timing = (f"CUDA events around {LAUNCHES} calls behind a spin kernel, per call"
              if dev.type == "cuda" else "host clock around one call")
    payload = {
        "schema": 1,
        "meta": {
            "smoke": bool(args.smoke),
            "device": device_meta(dev),
            "torch_version": torch.__version__,
            "repeats": repeats,
            "generated_unix": int(time.time()),
            "note": ("dense = torch.matmul / F.conv2d (channels-last, TF32 off) on "
                     "unpacked float weights, the faster of two cuDNN settings "
                     "timed in turns: dense_autotuned_us (benchmark=True, "
                     "deterministic=False) and dense_deterministic_us "
                     "(benchmark=False, deterministic=True); packed = repro_torch.kernels "
                     "ternary_matmul / ternary_conv2d (kernels K2 / K1 on a CUDA "
                     "tensor, the plain version on a CPU one); plain = the kernel's "
                     "plain PyTorch version on the same device.  Interleaved-median "
                     f"timing; one sample = {timing}."),
        },
        "results": results,
    }
    default_name = "BENCH_kernels_torch.smoke.json" if args.smoke else "BENCH_kernels_torch.json"
    out = Path(args.out) if args.out else REPO_ROOT / default_name
    out.write_text(json.dumps(payload, indent=2) + "\n")
    print(f"[kbench] wrote {out} ({len(results)} cells)", flush=True)
    if failures:
        for f in failures:
            print(f"[kbench] FAIL {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny kernel cells, fewer repeats")
    ap.add_argument("--repeats", type=int, default=None,
                    help="interleaved timing rounds (default 30, smoke 7)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: <repo>/BENCH_kernels_torch.json)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
