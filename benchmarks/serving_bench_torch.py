"""Serving benchmark of the PyTorch/CUDA port: pool sizes x backends for the
multi-sensor pool, on the card by default.

Counterpart of ``benchmarks/serving_bench.py`` with its four cells, flags,
gates and JSON schema (4).  For every (net, pool_size, backend) cell it

  * drives a full arrival/departure simulation (2x pool_size sensor
    streams, staggered arrivals) through `ContinuousBatcher` and measures
    frames/s and mean pool occupancy.  Each tick is timed on the host clock
    up to a `torch.cuda.synchronize()`, so a tick's latency is the card's
    work and not its enqueue; warm-up and the pool step's capture (the
    counterpart of the reference's compile) are excluded by a warm-up tick,
  * measures the sequential baseline — the same streams served one at a
    time by one captured batch-1 `StreamSession`, each step ending in a
    synchronise — and reports the pool's speedup over it,
  * checks **every** stream's pooled logits against that lone session, bit
    for bit (the reference checks stream 0), and the step's capture count
    (``trace_count == 1``); p50/p99 are over the non-idle ticks,
  * runs the multi-tenant fleet cell (>= 3 distinct nets on one
    `FleetRouter`, measured on a pre-warmed second round; every measured
    stream checked against a lone session, ``zero_retrace`` per rung),
  * runs the activity-gated cell (schema 3): the pool under an
    `ActivityGate` on a bursty duty-cycle trace, each stream's logits
    checked bit-exact against a lone session fed exactly the frames
    `ActivityGate.plan` selects, the skipped frames priced in uJ by
    `repro_torch.serving.energy_summary`,
  * runs the observability cell (schema 4): the largest pool scenario
    re-driven under a `repro_torch.obs.Tracer`, each tick's time split into
    the batcher's phases, and the traced run's logits byte-identical to an
    untraced run's.

Inputs come from ``--seed`` through `numpy.random.default_rng`, weights from
a seeded `torch.Generator`.

    python3 benchmarks/serving_bench_torch.py                 # full net -> BENCH_serving_torch.json
    python3 benchmarks/serving_bench_torch.py --smoke         # smoke net -> BENCH_serving_torch.smoke.json
    python3 benchmarks/serving_bench_torch.py --smoke --device cpu --pools 2 --frames 3 --out /tmp/s.json

Gate it with ``python3 scripts/check_bench_regression.py --serving BASE FRESH``.
Exit codes: 0 ok, 1 a correctness gate failed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.data.pipeline import DVSEventPipeline, KWSSpectrogramPipeline  # noqa: E402
from repro_torch.device import device_meta, resolve_device  # noqa: E402
from repro_torch.obs import Tracer, phase_breakdown, to_chrome  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ActivityGate,
    ContinuousBatcher,
    FleetRouter,
    StreamRequest,
    energy_summary,
)

FULL_NET = "dvs_cnn_tcn"
SMOKE_NET = "dvs_cnn_tcn_smoke"
# the multi-tenant cell: >= 3 distinct temporal registry nets per fleet
FLEET_NETS_FULL = ("dvs_cnn_tcn", "dvs_cnn_tcn_micro", "dvs_cnn_tcn_nano")
FLEET_NETS_SMOKE = ("dvs_cnn_tcn_smoke", "dvs_cnn_tcn_micro", "dvs_cnn_tcn_nano")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event_clips(graph, n_streams: int, frames: int, rng: np.random.Generator) -> np.ndarray:
    shape = (n_streams, frames, *graph.input_hw, graph.input_ch)
    return (rng.random(shape) < 0.05).astype(np.float32)


def _deploy(name: str, seed: int, dev: torch.device, calib=None):
    prog = api.get_net(name)
    params = prog.init(torch.Generator().manual_seed(seed), device=dev)
    return prog.quantize(params, calib=None if calib is None else
                         torch.from_numpy(calib).to(dev))


def _warm_pool(deployed, pool_size: int, backend: str, dev: torch.device, **kwargs):
    """A pool whose fixed-shape step has run (and, on the card, been
    captured) once on a throwaway stream."""
    g = deployed.graph
    pool = deployed.serve(pool_size, backend=backend, **kwargs)
    pool.admit("__warm__")
    pool.step({"__warm__": np.zeros((*g.input_hw, g.input_ch), np.float32)})
    pool.evict("__warm__")
    _sync(dev)
    return pool


def _percentiles(samples) -> dict:
    lat = np.asarray(samples, np.float64)
    return {
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3) if lat.size else float("nan"),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1e3) if lat.size else float("nan"),
    }


def _drive(batcher: ContinuousBatcher, dev: torch.device):
    """Tick until every stream departed: (wall seconds, per-tick seconds of
    the ticks that stepped), each tick ending in a synchronise."""
    ticks = []
    t_start = time.perf_counter()
    while batcher.pending:
        t0 = time.perf_counter()
        stepped = batcher.tick()
        _sync(dev)
        if stepped:
            ticks.append(time.perf_counter() - t0)
    return time.perf_counter() - t_start, ticks


def _lone_logits(session, clip: np.ndarray, frame_idx, dev: torch.device) -> np.ndarray:
    """Final logits of one stream fed through a reset lone session."""
    session.reset()
    logits = None
    for t in frame_idx:
        logits = session.step(torch.from_numpy(clip[t][None]).to(dev))
    return logits.cpu().numpy()[0]


def _run_pool(deployed, clips, pool_size: int, backend: str, dev: torch.device):
    """(wall seconds, stats dict, final logits by stream index)."""
    pool = _warm_pool(deployed, pool_size, backend, dev)
    batcher = ContinuousBatcher(pool)
    for i in range(clips.shape[0]):
        batcher.submit(StreamRequest(stream_id=f"s{i}", frames=clips[i], arrival=i))
    wall, ticks = _drive(batcher, dev)
    stats = batcher.stats()
    stats.update(_percentiles(ticks))  # synchronised ticks, not enqueue time
    stats["trace_count"] = pool.trace_count
    finals = {int(r.stream_id[1:]): r.logits for r in batcher.results}
    return wall, stats, finals


def _run_sequential(deployed, clips, backend: str, dev: torch.device):
    """The no-batching baseline: one batch-1 session, streams end to end."""
    session = deployed.stream(batch=1, backend=backend)
    session.step(torch.zeros((1, *clips.shape[2:]), device=dev))  # capture
    _sync(dev)
    finals = {}
    t0 = time.perf_counter()
    for i in range(clips.shape[0]):
        session.reset()
        for t in range(clips.shape[1]):
            logits = session.step(torch.from_numpy(clips[i, t][None]).to(dev))
            _sync(dev)
        finals[i] = logits.cpu().numpy()[0]
    return time.perf_counter() - t0, finals


def bench_cell(deployed, clips, pool_size: int, backend: str, dev: torch.device):
    pool_wall, stats, pool_finals = _run_pool(deployed, clips, pool_size, backend, dev)
    seq_wall, seq_finals = _run_sequential(deployed, clips, backend, dev)
    n_frames = clips.shape[0] * clips.shape[1]
    exact = set(pool_finals) == set(seq_finals) and all(
        bool((pool_finals[i] == seq_finals[i]).all()) for i in seq_finals)
    return {
        "pool_size": pool_size,
        "backend": backend,
        "streams": int(clips.shape[0]),
        "frames_per_stream": int(clips.shape[1]),
        "pool_wall_s": pool_wall,
        "pool_frames_per_s": n_frames / pool_wall,
        "sequential_wall_s": seq_wall,
        "sequential_frames_per_s": n_frames / seq_wall,
        "speedup_vs_sequential": seq_wall / pool_wall,
        "mean_occupancy": stats["mean_occupancy"],
        "ticks": stats["ticks"],
        "trace_count": stats["trace_count"],
        "exact_vs_single_session": exact,
        "latency_ms_p50": stats["latency_ms_p50"],
        "latency_ms_p99": stats["latency_ms_p99"],
    }


def bench_fleet(net_names, backend: str, pool_cap: int, streams: int, frames: int,
                dev: torch.device, seed: int = 0):
    """The multi-tenant cell: >= 3 distinct nets on one `FleetRouter`,
    staggered arrivals interleaved across buckets, ladder autoscaling.

    Two rounds through the SAME router: round 1 warms (and captures) every
    ladder rung the scenario visits, then each bucket's latency trace is
    cleared and round 2 is measured — the percentiles price steady-state
    serving while the capture audit spans both rounds.  The per-net
    percentiles are the buckets' own per-tick host latencies (enqueue plus
    the tick's waits); ``measured_wall_s`` ends in a synchronise.
    """
    router = FleetRouter(backend=backend, max_pool_size=pool_cap)
    deps, clips = {}, {}
    for idx, name in enumerate(net_names):
        deps[name] = _deploy(name, seed + idx, dev)
        router.register(name, deps[name])

    def submit_round(tag: str, base_tick: int, round_idx: int):
        for idx, name in enumerate(net_names):
            cs = _event_clips(deps[name].graph, streams, frames,
                              np.random.default_rng([seed, 100 + idx, round_idx]))
            for s in range(streams):
                sid = f"{tag}/{name}/{s}"
                clips[sid] = cs[s]
                router.submit(StreamRequest(
                    stream_id=sid, frames=clips[sid],
                    arrival=base_tick + idx + s * len(net_names), net=name,
                ))

    submit_round("warm", router.tick_index, 0)
    router.run()
    for bucket in router.buckets.values():
        bucket.batcher.latency_trace.clear()
    submit_round("meas", router.tick_index, 1)
    _sync(dev)
    t0 = time.perf_counter()
    results = router.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    stats = router.stats()
    router.close()

    # bit-exactness: every measured stream replayed through a lone batch-1
    # session of its net (the contract the single-pool cells gate)
    sessions = {name: deps[name].stream(batch=1, backend=backend) for name in net_names}
    measured = [r for r in results if r.stream_id.startswith("meas/")]
    exact = len(measured) == streams * len(net_names) and all(
        bool((_lone_logits(sessions[r.net], clips[r.stream_id],
                           range(frames), dev) == r.logits).all())
        for r in measured)

    zero_retrace = all(
        tc <= 1 for s in stats["nets"].values() for tc in s["pools_traced"].values())
    per_net = {
        name: {
            "latency_ms_p50": s["latency_ms_p50"],
            "latency_ms_p99": s["latency_ms_p99"],
            "latency_by_pool_size": s["latency_by_pool_size"],
            "mean_occupancy": s["mean_occupancy"],
            "completed": s["completed"],
            "pools_traced": s["pools_traced"],
            "scale_events": len(s["scale_events"]),
        }
        for name, s in stats["nets"].items()
    }
    return {
        "nets": list(net_names),
        "backend": backend,
        "pool_cap": pool_cap,
        "streams_per_net": streams,
        "frames_per_stream": frames,
        "measured_wall_s": wall,
        "completed": len(measured),
        "per_net": per_net,
        "latency_ms_p50": stats["aggregate"]["latency_ms_p50"],
        "latency_ms_p99": stats["aggregate"]["latency_ms_p99"],
        "exact_vs_single_session": exact,
        "zero_retrace": zero_retrace,
    }


def bench_gated(deployed, backend: str, pool_size: int, streams: int, frames: int,
                duty: float, dev: torch.device, seed: int = 5):
    """The schema-3 activity-gated cell: bursty duty-cycle traces through a
    gated `ContinuousBatcher`, each stream verified against a lone session
    fed exactly the `ActivityGate.plan`-selected frames, the skipped frames
    priced in uJ on the sim counters."""
    g = deployed.graph
    pipe_cls = DVSEventPipeline if g.input_ch == 2 else KWSSpectrogramPipeline
    pipe = pipe_cls(streams, steps=frames, hw=g.input_hw[0],
                    n_classes=g.n_classes, seed=seed, duty_cycle=duty)
    clips = np.asarray(pipe.next_batch()[0])
    gate = ActivityGate()

    pool = _warm_pool(deployed, pool_size, backend, dev)
    batcher = ContinuousBatcher(pool, gate=gate)
    for i in range(streams):
        batcher.submit(StreamRequest(stream_id=f"s{i}", frames=clips[i], arrival=i))
    wall, _ = _drive(batcher, dev)
    results = batcher.results
    stats = batcher.stats()

    # the differential contract, every stream: processed set == the gate
    # plan, logits == a lone session fed exactly those frames
    session = deployed.stream(batch=1, backend=backend)
    exact = len(results) == streams
    for r in results:
        clip = clips[int(r.stream_id[1:])]
        plan = gate.plan([ActivityGate.activity(f) for f in clip])
        proc = [t for t, p in enumerate(plan) if p]
        if r.frames_processed != len(proc):
            exact = False
        elif not proc:
            exact = exact and r.logits is None
        else:
            exact = exact and r.logits is not None and bool(
                (_lone_logits(session, clip, proc, dev) == r.logits).all())

    sg = stats["gating"]
    energy = energy_summary(
        deployed,
        frames_processed=sg["frames_processed"],
        frames_total=sg["frames_processed"] + sg["frames_skipped"],
        completed=sum(1 for r in results if r.logits is not None),
    )
    return {
        "pool_size": pool_size,
        "backend": backend,
        "streams": streams,
        "frames_per_stream": frames,
        "trace_duty_cycle": duty,
        "gate": {"wake_threshold": gate.wake_threshold,
                 "park_threshold": gate.park_threshold,
                 "park_after": gate.park_after},
        "wall_s": wall,
        "parks": sg["parks"],
        "wakes": sg["wakes"],
        "trace_count": pool.trace_count,
        "exact_vs_gate_plan": exact,
        **energy,
    }


def bench_phases(deployed, clips, pool_size: int, backend: str, dev: torch.device):
    """The schema-4 observability cell: the same staggered-arrival pool
    scenario driven untraced and under a `repro_torch.obs.Tracer`, the
    traced run's final logits checked byte-identical to the untraced run's,
    then the trace attributed into per-tick phase fractions."""
    def drive(tracer):
        pool = _warm_pool(deployed, pool_size, backend, dev)
        batcher = ContinuousBatcher(pool, tracer=tracer)
        for i in range(clips.shape[0]):
            batcher.submit(StreamRequest(stream_id=f"s{i}", frames=clips[i], arrival=i))
        results = batcher.run()
        _sync(dev)
        return batcher, pool, {r.stream_id: np.asarray(r.logits) for r in results}

    _, _, plain = drive(None)
    tracer = Tracer()
    batcher, pool, traced = drive(tracer)
    exact = set(plain) == set(traced) and all(
        (plain[sid] == traced[sid]).all() for sid in plain)

    lane = phase_breakdown(to_chrome(tracer)).get(batcher.track, {})
    fractions = {name: round(cell["fraction"], 4)
                 for name, cell in lane.get("phases", {}).items()}
    return {
        "pool_size": pool_size,
        "backend": backend,
        "streams": int(clips.shape[0]),
        "frames_per_stream": int(clips.shape[1]),
        "ticks": lane.get("ticks", 0),
        "tick_total_us": round(lane.get("tick_total_us", 0.0), 1),
        "trace_events": len(tracer),
        "trace_count": pool.trace_count,
        "exact_vs_untraced": exact,
        "phase_fraction": fractions,
    }


def run(args) -> int:
    dev = resolve_device(args.device)
    net = args.net or (SMOKE_NET if args.smoke else FULL_NET)
    pools = args.pools or ([2, 4] if args.smoke else [2, 4, 8])
    backends = args.backends or ["fused", "ref"]
    frames = args.frames or (4 if args.smoke else 6)

    g = api.get_net(net).graph
    calib = _event_clips(g, 2, frames, np.random.default_rng([args.seed, 1]))
    deployed = _deploy(net, args.seed, dev, calib)

    results, failures = [], []
    for pool_size in pools:
        clips = _event_clips(g, 2 * pool_size, frames,
                             np.random.default_rng([args.seed, 2 + pool_size]))
        for backend in backends:
            row = bench_cell(deployed, clips, pool_size, backend, dev)
            results.append({"net": net, **row})
            if not row["exact_vs_single_session"]:
                failures.append(f"{net}/pool{pool_size}/{backend}: pooled logits != "
                                "single-session logits")
            if row["trace_count"] != 1:
                failures.append(f"{net}/pool{pool_size}/{backend}: step captured "
                                f"{row['trace_count']}x (continuous batching broken)")
            print(f"[serving-bench] {net:>18s} pool{pool_size} {backend:>6s}: "
                  f"{row['pool_frames_per_s']:9.1f} frames/s "
                  f"(x{row['speedup_vs_sequential']:.2f} vs sequential), "
                  f"occupancy {row['mean_occupancy']:.2f}, "
                  f"p50 {row['latency_ms_p50']:.3f} ms / p99 {row['latency_ms_p99']:.3f} ms, "
                  f"exact={row['exact_vs_single_session']}", flush=True)

    fleet = None
    if not args.no_fleet:
        fleet_nets = tuple(args.fleet_nets) if args.fleet_nets else (
            FLEET_NETS_SMOKE if args.smoke else FLEET_NETS_FULL)
        fleet = bench_fleet(fleet_nets, backend=backends[0], pool_cap=max(pools),
                            streams=2 * max(pools), frames=frames, dev=dev,
                            seed=args.seed)
        if not fleet["exact_vs_single_session"]:
            failures.append("fleet: pooled logits != single-session logits")
        if not fleet["zero_retrace"]:
            failures.append("fleet: a bucket pool was built or captured twice "
                            "(ladder broken)")
        print(f"[serving-bench] {'fleet':>18s} {len(fleet_nets)} nets "
              f"{fleet['backend']:>6s}: p50 {fleet['latency_ms_p50']:.3f} ms / "
              f"p99 {fleet['latency_ms_p99']:.3f} ms per tick, {fleet['completed']} "
              f"streams, exact={fleet['exact_vs_single_session']}, "
              f"zero_retrace={fleet['zero_retrace']}", flush=True)

    gated = None
    if not args.no_gate:
        gated = bench_gated(deployed, backend=backends[0], pool_size=max(pools),
                            streams=2 * max(pools), frames=frames, duty=args.duty_cycle,
                            dev=dev, seed=args.seed + 5)
        if not gated["exact_vs_gate_plan"]:
            failures.append("gated: pooled logits != gate-plan lone session")
        if gated["trace_count"] != 1:
            failures.append(f"gated: step captured {gated['trace_count']}x")
        if gated["frames_skipped"] > 0 and not gated["energy_uj_saved"] > 0:
            failures.append(f"gated: skipped {gated['frames_skipped']} frames but saved "
                            f"{gated['energy_uj_saved']:.3f} uJ")
        if (gated["frames_skipped"] > 0 and not gated["energy_uj_per_classification"]
                < gated["energy_uj_per_classification_ungated"]):
            failures.append("gated: energy per classification not below the ungated "
                            "baseline")
        print(f"[serving-bench] {'gated':>18s} pool{gated['pool_size']} "
              f"{gated['backend']:>6s}: duty {gated['duty_cycle']:.2f}, "
              f"{gated['frames_skipped']}/{gated['frames_total']} frames skipped, "
              f"{gated['energy_uj_saved']:.2f} uJ saved, "
              f"{gated['energy_uj_per_classification']:.3f} uJ/cls (ungated "
              f"{gated['energy_uj_per_classification_ungated']:.3f}), "
              f"exact={gated['exact_vs_gate_plan']}", flush=True)

    phases = None
    if not args.no_phases:
        phases = bench_phases(
            deployed,
            _event_clips(g, 2 * max(pools), frames,
                         np.random.default_rng([args.seed, 2 + max(pools)])),
            pool_size=max(pools), backend=backends[0], dev=dev)
        if not phases["exact_vs_untraced"]:
            failures.append("phases: traced logits != untraced logits (tracing "
                            "perturbed serving)")
        if phases["trace_count"] != 1:
            failures.append(f"phases: step captured {phases['trace_count']}x under tracing")
        if not phases["phase_fraction"].get("step", 0.0) > 0.0:
            failures.append("phases: no step time attributed in the trace")
        frac = phases["phase_fraction"]
        print(f"[serving-bench] {'phases':>18s} pool{phases['pool_size']} "
              f"{phases['backend']:>6s}: {phases['ticks']} ticks, "
              f"step {frac.get('step', 0.0):.1%} / assemble {frac.get('assemble', 0.0):.1%}"
              f" / admit {frac.get('admit', 0.0):.1%} / other {frac.get('other', 0.0):.1%}, "
              f"exact_vs_untraced={phases['exact_vs_untraced']}", flush=True)

    payload = {
        "schema": 4,
        "meta": {
            "smoke": bool(args.smoke),
            "net": net,
            "device": device_meta(dev),
            "torch_version": torch.__version__,
            "frames_per_stream": frames,
            "generated_unix": int(time.time()),
            "note": (
                "Pool frames/s is host wall-clock over a staggered-arrival "
                "continuous-batching simulation; each tick (and each step of the "
                "sequential batch-1 session) ends in torch.cuda.synchronize() on "
                "the card, and latency_ms_p50/p99 are percentiles of those "
                "synchronised non-idle ticks, warm-up and capture excluded by a "
                "warm-up tick.  exact_vs_single_session (every stream) and "
                "trace_count == 1 (one capture of the pool's step; one build on "
                "the CPU) are the serving correctness contract.  The fleet cell "
                "measures round 2 through pre-warmed bucket pools; its "
                "percentiles are the buckets' own per-tick host latencies "
                "(enqueue plus the tick's waits, no synchronise).  The gated "
                "cell's energy_* fields price skipped frames on the CUTIE "
                "silicon model (deterministic, not a measurement of the card).  "
                "The phases cell splits tick wall time across admit/assemble/step "
                "spans: on the card the step span covers the host's enqueue of "
                "the frame copy and one CUDA-graph replay, not the card's time."
            ),
        },
        "results": results,
        "fleet": fleet,
        "gated": gated,
        "phases": phases,
    }
    default_name = ("BENCH_serving_torch.smoke.json" if args.smoke
                    else "BENCH_serving_torch.json")
    out = Path(args.out) if args.out else REPO_ROOT / default_name
    out.write_text(json.dumps(payload, indent=2) + "\n")
    print(f"[serving-bench] wrote {out} ({len(results)} cells)", flush=True)
    if failures:
        for f in failures:
            print(f"[serving-bench] FAIL {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="smoke registry net, small pools")
    ap.add_argument("--net", default=None)
    ap.add_argument("--pools", nargs="*", type=int, default=None)
    ap.add_argument("--backends", nargs="*", default=None,
                    choices=list(api.BACKENDS))
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per sensor stream")
    ap.add_argument("--fleet-nets", nargs="*", default=None,
                    help="nets for the multi-tenant FleetRouter cell "
                         "(default: 3 distinct temporal registry nets)")
    ap.add_argument("--no-fleet", action="store_true",
                    help="skip the fleet cell (single-pool sweep only)")
    ap.add_argument("--no-gate", action="store_true",
                    help="skip the activity-gated cell")
    ap.add_argument("--no-phases", action="store_true",
                    help="skip the traced phase-breakdown cell")
    ap.add_argument("--duty-cycle", type=float, default=0.4,
                    help="active-frame fraction of the gated cell's traces")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: <repo>/BENCH_serving_torch.json)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
