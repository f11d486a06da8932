"""Multi-sensor continuous batching on the PyTorch port: many DVS streams,
one fixed-shape step.  Counterpart of `examples/serve_sensor_pool.py`.

The paper's silicon serves ONE always-on sensor at 8000 inf/s; this demo
serves a whole fleet on the software stack.  Sensors come online staggered,
stream through a fixed-shape `SessionPool` (slot-masked TCN ring state,
per-slot cursors, all in static tensors), and finished streams hand their
slot to the next arrival without a new step: on the card the pool captures
its step once as a CUDA graph and replays it every tick, so its
`trace_count` stays 1.  Mid-run, one stream is evicted, carried around as a
`StreamState`, and resumed in a standalone `StreamSession` with identical
logits.

    PYTHONPATH=src python examples/serve_sensor_pool_torch.py [--pool 4] \
        [--frames 6] [--net dvs_cnn_tcn_smoke] [--no-jit] [--device cpu]

``--device`` defaults to ``cuda``; without a CUDA device that is an error.
Exit 1 when the pool's `trace_count` is not 1 or the resumed session
differs.
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
from repro_torch.serving import ContinuousBatcher, StreamRequest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=4)
    ap.add_argument("--streams", type=int, default=0, help="0 = 2x pool")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS))
    ap.add_argument("--net", default="dvs_cnn_tcn_smoke")
    ap.add_argument("--no-jit", action="store_true",
                    help="run every tick eagerly (no CUDA-graph capture)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    jit = not args.no_jit
    n_streams = args.streams or 2 * args.pool
    prog = get_net(args.net)
    g = prog.graph
    params = prog.init(torch.Generator().manual_seed(args.seed), device=device)
    pipe = DVSEventPipeline(n_streams, steps=args.frames, hw=g.input_hw[0], seed=args.seed)
    frames, labels = pipe.next_batch()
    deployed = prog.quantize(params, calib=torch.from_numpy(frames).to(device))

    print(f"[pool] {n_streams} sensors x {args.frames} frames -> "
          f"{args.pool}-slot pool ({args.backend}, {device}, jit={jit})")
    pool = deployed.serve(args.pool, backend=args.backend, jit=jit)
    batcher = ContinuousBatcher(pool)
    for i in range(n_streams):
        batcher.submit(StreamRequest(f"sensor-{i}", frames[i],
                                     label=int(labels[i]), arrival=i))

    t0 = time.perf_counter()
    results = batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    stats = batcher.stats()
    print(f"[pool] {stats['frames_processed']} frames in {stats['ticks']} ticks "
          f"({wall:.2f} s), mean occupancy {stats['mean_occupancy']:.2f}")
    print(f"[pool] trace_count {pool.trace_count} (step "
          f"{'captures' if jit and device.type == 'cuda' else 'builds'}; "
          f"continuous batching: always 1)")
    print(f"[pool] per-stream preds: "
          f"{[r.pred for r in sorted(results, key=lambda r: r.stream_id)]} "
          f"(untrained weights)")
    if pool.trace_count != 1:
        print(f"[pool] FAIL: trace_count {pool.trace_count} != 1", file=sys.stderr)
        return 1

    # a session is just a state — hop pool -> standalone and keep going
    pool2 = deployed.serve(2, backend=args.backend, jit=jit)
    pool2.admit("roamer")
    for t in range(2):
        pool2.step({"roamer": frames[0, t]})
    state = pool2.evict("roamer")
    clip = torch.from_numpy(frames[0:1]).to(device)
    session = deployed.stream(batch=None, backend=args.backend, jit=jit)
    session.load_state(state)
    resumed = session.step(clip[:, 2])
    oracle = deployed.stream(batch=1, backend=args.backend, jit=jit)
    for t in range(3):
        want = oracle.step(clip[:, t])
    if not torch.equal(resumed, want):
        print("[pool] FAIL: resumed session != uninterrupted session", file=sys.stderr)
        return 1
    print("[pool] evict -> StreamState -> standalone session resume: bit-exact")
    print("serve_sensor_pool OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
