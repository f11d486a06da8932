"""End-to-end serving demo on the PyTorch port: the paper's autonomous
DVS gesture pipeline.  Counterpart of `examples/serve_dvs_stream.py`.

Event frames stream through the ternary 2-D CNN into the 24-step TCN ring
memory (the 576-byte silicon SCM); the dilated TCN head classifies after
every frame via the §4 mapped 2-D convolutions — one inference per frame,
past frames never recomputed.  The whole flow is the `repro_torch.api`
program pipeline: registry -> CutieProgram -> quantize -> StreamSession.
On the card the session's step is captured once as a CUDA graph at the
first frame and replayed for every later one.

    PYTHONPATH=src python examples/serve_dvs_stream_torch.py [--batch 4] \
        [--frames 10] [--net dvs_cnn_tcn] [--no-jit] [--device cpu]

``--device`` defaults to ``cuda``; without a CUDA device that is an error.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import BACKENDS, get_net  # noqa: E402
from repro_torch.data.pipeline import DVSEventPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS))
    ap.add_argument("--net", default="dvs_cnn_tcn")
    ap.add_argument("--no-jit", action="store_true",
                    help="run every step eagerly (no CUDA-graph capture)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    prog = get_net(args.net)
    g = prog.graph
    print(f"[dvs] init ternary CNN-TCN {g.name} ({g.feature_channels} ch, "
          f"{g.tcn_steps}-step TCN memory) on {device}")
    params = prog.init(torch.Generator().manual_seed(args.seed), device=device)

    pipe = DVSEventPipeline(args.batch, steps=args.frames, hw=g.input_hw[0], seed=args.seed)
    frames_np, _ = pipe.next_batch()
    frames = torch.from_numpy(frames_np).to(device)
    print(f"[dvs] {args.batch} sensors x {args.frames} frames, event density "
          f"{float(frames.mean()):.3f}")

    deployed = prog.quantize(params, calib=frames)
    session = deployed.stream(batch=args.batch, backend=args.backend, jit=not args.no_jit)
    logits = session.step(frames[:, 0])  # builds the kernels; captures on the card
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for t in range(1, args.frames):
        logits = session.step(frames[:, t])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / max(args.frames - 1, 1)
    pred = logits.argmax(-1).cpu().tolist()
    print(f"[dvs] {dt * 1e3:.2f} ms/frame ({args.backend}, trace_count "
          f"{session.trace_count}); predictions {pred} (untrained weights)")
    if not bool(torch.isfinite(logits).all()) or session.steps_seen != args.frames:
        print("[dvs] FAIL: non-finite logits or a lost frame", file=sys.stderr)
        return 1

    # what the silicon would do with this workload:
    rep = deployed.silicon_report(v=0.5)
    calibrated = ("uncalibrated" if rep.calibration is None else
                  f"calibration consistent: {rep.calibration.consistent}")
    print(f"[dvs] CUTIE @0.5V: {rep.energy_uj:.2f} uJ/classification "
          f"({g.passes_per_inference} CNN passes + TCN head), "
          f"{rep.inf_per_s * g.passes_per_inference:.0f} frames/s, {calibrated}")
    print("serve_dvs_stream OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
