"""Serving launcher of the port: CUTIE multi-sensor streaming (``--dvs``).
Counterpart of the ``--dvs`` path of `repro.launch.serve`.

The paper's autonomous mode scaled out — an arrival/departure simulation of
many DVS sensor streams continuously batched onto one
`repro_torch.serving.SessionPool`.  Sensors come online staggered, stream
their event frames through the ternary CNN into slot-masked TCN ring
memory, and finished streams free their slot for the next arrival.  Reports
frames/s, pool occupancy and streaming accuracy against the pipeline's
labels; verifies the pool against independent single-stream
`StreamSession`s (bit-exact) and exits non-zero on any mismatch, on
non-finite logits, or when a stream did not complete.

    python -m repro_torch.launch.serve --dvs --pool 8 --frames 8            # on the card
    python -m repro_torch.launch.serve --dvs --net dvs_cnn_tcn_smoke \\
        --pool 2 --streams 3 --frames 4 --device cpu                          # plain path

``--device`` defaults to ``cuda``; without a CUDA device that is an error,
not a move to the CPU.  The default backend is "fused": conv + threshold
(+ pool) in one kernel launch per layer, int8 trits between layers;
``--backend`` takes every deploy backend (``kernel``, ``ref``, ``bitsim``).
After the run it prints what the CUTIE silicon model says of the same
program at 0.5 V (`DeployedProgram.silicon_report`).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def serve_dvs(args) -> int:
    """Continuous-batching multi-sensor simulation over a `SessionPool`.

    ``--streams`` sensors (default 2x the pool) each produce ``--frames``
    event frames; sensor i comes online at tick i, so the pool sees
    arrivals, departures, and slot refills mid-flight."""
    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.serving import ContinuousBatcher, StreamRequest

    device = resolve_device(args.device)
    if args.frames <= 0:
        print(f"[serve-dvs] --frames {args.frames}: no frames to serve; "
              f"pool of {args.pool} stays idle")
        return 0

    n_streams = args.streams or 2 * args.pool
    prog = get_net(args.net)
    g = prog.graph
    params = prog.init(torch.Generator().manual_seed(args.seed), device=device)
    pipe = DVSEventPipeline(
        n_streams, steps=args.frames, hw=g.input_hw[0], seed=args.seed
    )
    frames, labels = pipe.next_batch()
    deployed = prog.quantize(params, calib=torch.from_numpy(frames).to(device))

    pool = deployed.serve(args.pool, backend=args.backend)
    batcher = ContinuousBatcher(pool)
    for i in range(n_streams):
        batcher.submit(StreamRequest(
            stream_id=f"sensor-{i}", frames=frames[i],
            label=int(labels[i]), arrival=i,
        ))

    t0 = time.time()
    results = batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    stats = batcher.stats()

    finite = all(np.isfinite(r.logits).all() for r in results)
    acc = stats["accuracy"]
    fps = stats["frames_processed"] / wall if wall > 0 else float("nan")
    print(f"[serve-dvs] {g.name} ({args.backend}, {device}): {n_streams} sensors x "
          f"{args.frames} frames through a {args.pool}-slot pool")
    print(f"[serve-dvs] {stats['frames_processed']} frames in "
          f"{stats['ticks']} ticks, {wall:.2f} s -> {fps:.0f} frames/s, "
          f"mean occupancy {stats['mean_occupancy']:.2f}")
    chance = f"untrained weights — chance is {1.0 / g.n_classes:.2f}"
    print(f"[serve-dvs] streaming accuracy {acc:.2f} "
          f"({chance if acc < 0.9 else 'vs ground-truth labels'}); "
          f"logits finite: {finite}")

    # the serving contract: each pooled stream == a lone StreamSession
    mismatches = _verify_pool_vs_sessions(
        deployed, results, frames, args.backend,
        check=min(args.check_streams, n_streams),
    )
    # the silicon model's view of the same program (repro_torch.sim)
    rep = deployed.silicon_report(v=0.5)
    sensor_fps = rep.inf_per_s * g.passes_per_inference
    print(f"[serve-dvs] CUTIE @0.5V would run each sensor at "
          f"{sensor_fps:.0f} frames/s, {rep.energy_uj:.2f} uJ/classification "
          f"({args.pool} sensors -> {args.pool * sensor_fps:.0f} frames/s "
          f"aggregate)")
    if not finite:
        print("[serve-dvs] FAIL: non-finite logits", file=sys.stderr)
        return 1
    if mismatches:
        for m in mismatches:
            print(f"[serve-dvs] FAIL: {m}", file=sys.stderr)
        return 1
    if len(results) != n_streams:
        print(f"[serve-dvs] FAIL: {len(results)}/{n_streams} streams completed",
              file=sys.stderr)
        return 1
    return 0


def _verify_pool_vs_sessions(deployed, results, frames, backend, check: int):
    """Replay the first ``check`` streams through independent batch-1
    `StreamSession`s; pooled final logits must match bit-for-bit."""
    mismatches = []
    by_id = {r.stream_id: r for r in results}
    for i in range(check):
        sid = f"sensor-{i}"
        if sid not in by_id:
            mismatches.append(f"{sid}: no result")
            continue
        session = deployed.stream(batch=1, backend=backend)
        clip = torch.from_numpy(np.ascontiguousarray(frames[i:i + 1])).to(deployed.device)
        for t in range(clip.shape[1]):
            ref_logits = session.step(clip[:, t])
        got = by_id[sid].logits
        want = ref_logits.detach().cpu().numpy()[0]
        if not (got == want).all():
            mismatches.append(
                f"{sid}: pool logits != single-session logits "
                f"(max|diff|={np.abs(got - want).max():.3e})"
            )
    print(f"[serve-dvs] pool vs single-session: {check} streams replayed, "
          f"{len(mismatches)} mismatches")
    return mismatches


def main(argv=None) -> int:
    from repro_torch.api import BACKENDS

    ap = argparse.ArgumentParser(
        description="repro_torch serving launcher (DVS multi-sensor pool)")
    ap.add_argument("--dvs", action="store_true",
                    help="serve DVS sensor streams through a SessionPool "
                         "(the only path of the port so far)")
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS))
    ap.add_argument("--frames", type=int, default=8,
                    help="event frames per sensor stream")
    ap.add_argument("--net", default="dvs_cnn_tcn",
                    help="registry net to serve (e.g. dvs_cnn_tcn_smoke)")
    ap.add_argument("--pool", type=int, default=4,
                    help="SessionPool slots (fixed batch width)")
    ap.add_argument("--streams", type=int, default=0,
                    help="total sensor streams to serve (0 = 2x pool)")
    ap.add_argument("--check-streams", type=int, default=2,
                    help="streams replayed through single sessions for the "
                         "bit-exactness gate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)
    if not args.dvs:
        ap.error("only the --dvs path is ported; pass --dvs")
    return serve_dvs(args)


if __name__ == "__main__":
    sys.exit(main())
