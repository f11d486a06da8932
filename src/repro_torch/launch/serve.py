"""Serving launcher of the port: LM serving (``--arch``, the default path),
CUTIE multi-sensor streaming (``--dvs``), multi-tenant fleet serving
(``--fleet``) and batch image classification (``--classify``, the port's
own).  Counterpart of `repro.launch.serve`.

LM serving (`serve_lm`): prefill a batch of random prompts, then decode
greedily with the KV/SSM cache, and print the reference's two ``[serve]``
lines (prefill and decode times, the card synchronised before each clock
read; the sampled tokens).  Exits non-zero on non-finite logits.  As the
reference jits its decode step with the cache donated, the decode step here
donates the cache and is a `repro_torch.capture.CapturedStep`: on the card
the first token runs eagerly and is captured, every later token is one
replay, each step's token column copied into the step's static input.
Prefill, one call per batch of prompts, runs eagerly.

    python -m repro_torch.launch.serve --arch gemma-2b                    # full width, on the card
    python -m repro_torch.launch.serve --arch gemma-2b --quant ternary_packed
    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu

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
    python -m repro_torch.launch.serve --dvs --program net.cutie --pool 8    # a shipped artifact
    python -m repro_torch.launch.serve --fleet --fleet-nets dvs_cnn_tcn,kws_tcn \\
        --pool 8 [--gate] [--out fleet.json]                                  # many nets

The classification scenario (`serve_classify`, ``--classify``) serves a
spatial net (``--net cifar10_tnn``, the paper's CIFAR-10 network) through a
`repro_torch.serving.BatchClassifier` of ``--batch`` images a tick: ``--requests``
seeded requests of 1 to ``2 * --batch`` 8-bit images each, quantized with
the first ``CALIB_IMAGES`` images as calibration.  It reports images/s and
the step's builds, checks every answered image bit-equal to an eager
``DeployedProgram.forward`` on ``--backend`` and exits non-zero on a
mismatch, non-finite logits or an unanswered request.

    python -m repro_torch.launch.serve --classify --net cifar10_tnn --batch 256 --requests 64
    python -m repro_torch.launch.serve --classify --net cifar10_tnn_smoke --device cpu

``--program FILE.cutie`` serves a `repro_torch.artifact` (built with
``python -m repro_torch.artifact build``) instead of quantizing ``--net``:
no graph object on that path, the pool runs what the artifact holds.

The fleet scenario (`serve_fleet_scenario`) registers ``--fleet-nets`` on
one `FleetRouter` (``--pool`` is the bucket ladder's cap) with staggered
arrivals, and exits non-zero on any pooled-vs-lone-session mismatch,
non-finite logits, incomplete streams, or a bucket pool built or stepped
into a second step program; with ``--gate`` each stream must also process
exactly the frames `ActivityGate.plan` selects and the gate must save
energy (CUTIE silicon-model uJ) whenever the trace has quiet frames.

``--trace FILE.json`` records a `repro_torch.obs` trace of any CUTIE scenario
(tick/step/feeder spans, park/wake/scale instants, one sim layer-timeline
track per served program) as Chrome/Perfetto JSON; ``--trace-clock tick``
stamps a deterministic event sequence instead of wall time; ``--metrics-out
FILE.prom`` writes the serving metrics registry as a Prometheus text
snapshot.  ``--shard`` lays each pool's slot axis across the local cards
(``sharding="auto"``: every card when there are several and they divide
the pool; on one card it resolves to one block, ``shard=False``).

LM serving builds the reference's local mesh and sharding rules
(`launch/mesh.py`, `launch/sharding.py`) and hands their shard function to
the steps: the identity on one device.  On a host with several cards
``--device cuda`` names them all: the launcher starts one rank per card
(NCCL, `launch.mesh.run_ranks`) and serves on the reference's ``(n, 1)``
(data, model) mesh, the params and the cache laid out as DTensors by the
plan, the prompts split over the cards; rank 0 prints.  Started by
``torchrun`` (or inside a rank) it uses that group's ``(world, 1)`` mesh.

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

from repro_torch.configs import ARCH_IDS
from repro_torch.device import resolve_device


def serve_lm(args) -> int:
    """Batched prefill + greedy decode of ``--arch`` with random weights
    (seed ``--seed``).  Returns 0, or 1 when any logits are not finite.
    With ``--device cuda`` and several visible cards it runs one rank per
    card (NCCL) on the reference's ``(n, 1)`` mesh; in a process group
    that is already up (torchrun, a rank) on that group's ``(world, 1)``
    mesh; otherwise on one device."""
    from repro_torch.launch.mesh import in_group, launcher_ranks, run_ranks

    device = resolve_device(args.device)
    ranks = launcher_ranks(device)
    if ranks > 1 and not in_group(device.type):
        return max(run_ranks(_serve_lm, ranks, "cuda", args=(args,)))
    return _serve_lm(args)


def _serve_lm(args) -> int:
    """`serve_lm` in one process: on one device, or as one rank of a
    group (only rank 0 prints)."""
    import torch.distributed as dist

    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import local_device, make_local_mesh, rank, world_mesh
    from repro_torch.launch.sharding import ShardingRules, distribute
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import init_params

    device = local_device(resolve_device(args.device))
    cfg = get_config(args.arch, quant=args.quant, smoke=args.smoke)
    mesh = world_mesh() if dist.is_initialized() else make_local_mesh(device)
    rules = ShardingRules(mesh)
    shard = rules.make_shard_fn()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    say = print if rank() == 0 else (lambda *a, **k: None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params = init_params(cfg, gen, dtype=torch.float32, device=device)
    if mesh.device_mesh is not None:
        params = distribute(params, rules.param_shardings(params))
    prefill = make_prefill_step(cfg, args.prompt_len + args.tokens, shard=shard,
                                cache_dtype=torch.float32, cache_init=rules.cache_init)
    decode = CapturedStep(make_decode_step(cfg, shard=shard, donate=True), device,
                          inputs=(1,))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(
            (args.batch, cfg.frontend_seq, cfg.d_model), generator=gen, device=device)
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn(
            (args.batch, cfg.enc_seq_len, cfg.d_model), generator=gen, device=device)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    sync()
    t_pf = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        logits, cache = decode(params, tok, cache)
        finite = finite & torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    seqs = torch.cat(out_tokens, dim=1).cpu().numpy()
    say(f"[serve] {cfg.name}: prefill({args.batch}x{args.prompt_len}) {t_pf*1e3:.0f} ms; "
        f"{args.tokens-1} decode steps {t_dec*1e3:.0f} ms "
        f"({t_dec/max(args.tokens-1,1)*1e3:.1f} ms/tok)")
    say(f"[serve] sample tokens: {seqs[0, :8]}")
    if not bool(finite):
        print("[serve] FAIL: non-finite logits", file=sys.stderr)
        return 1
    return 0


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
    if args.program:
        # serve a shipped .cutie artifact: no CutieGraph, no quantization;
        # the pool runs what the device would load
        from repro_torch import artifact

        deployed = artifact.load(args.program, device=device)
        g = deployed.graph  # ProgramInfo — serving metadata only
        print(f"[serve-dvs] program loaded from {args.program}: {g.name}, "
              f"{deployed.nbytes} packed weight bytes")
        pipe = DVSEventPipeline(
            n_streams, steps=args.frames, hw=g.input_hw[0], seed=args.seed
        )
        frames, labels = pipe.next_batch()
    else:
        prog = get_net(args.net)
        g = prog.graph
        params = prog.init(torch.Generator().manual_seed(args.seed), device=device)
        pipe = DVSEventPipeline(
            n_streams, steps=args.frames, hw=g.input_hw[0], seed=args.seed
        )
        frames, labels = pipe.next_batch()
        deployed = prog.quantize(params, calib=torch.from_numpy(frames).to(device))

    pool = deployed.serve(args.pool, backend=args.backend,
                          sharding="auto" if args.shard else None)
    tracer = _make_tracer(args)
    batcher = ContinuousBatcher(pool, tracer=tracer)
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
    _write_obs(args, tracer, {batcher.track: deployed}, batcher.metrics,
               tag="serve-dvs")

    finite = all(np.isfinite(r.logits).all() for r in results)
    acc = stats["accuracy"]
    fps = stats["frames_processed"] / wall if wall > 0 else float("nan")
    print(f"[serve-dvs] {g.name} ({args.backend}, {device}): {n_streams} sensors x "
          f"{args.frames} frames through a {args.pool}-slot pool "
          f"(shard={pool.sharding is not None})")
    print(f"[serve-dvs] {stats['frames_processed']} frames in "
          f"{stats['ticks']} ticks, {wall:.2f} s -> {fps:.0f} frames/s, "
          f"mean occupancy {stats['mean_occupancy']:.2f}, "
          f"step captures/builds {pool.trace_count}")
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


CALIB_IMAGES = 16  # the classification scenario's calibration images


def serve_classify(args) -> int:
    """Batch classification of seeded 8-bit images over a `BatchClassifier`.

    ``--requests`` requests of 1 to ``2 * --batch`` images each (seeded by
    ``--seed``) are submitted at once and served to the end; every answered
    image is then checked against an eager ``forward`` of the same images."""
    from repro_torch.api import get_net

    device = resolve_device(args.device)
    prog = get_net(args.net)
    g = prog.graph
    if g.is_temporal:
        print(f"[serve-classify] {g.name} has a TCN memory: serve it with --dvs",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    sizes = rng.integers(1, 2 * args.batch + 1, args.requests)
    pixels = rng.integers(0, 256, (int(sizes.sum()), *g.input_hw, g.input_ch))
    images = ((pixels - 128) / 128).astype(np.float32)  # dyadic 8-bit pixels in [-1, 1)
    params = prog.init(torch.Generator().manual_seed(args.seed), device=device)
    deployed = prog.quantize(params, calib=torch.from_numpy(images[:CALIB_IMAGES]).to(device))

    tracer = _make_tracer(args)
    clf = deployed.classify(args.batch, backend=args.backend, tracer=tracer)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for i in range(args.requests):
        clf.submit(f"request-{i}", images[starts[i]:starts[i + 1]])
    t0 = time.perf_counter()
    answers = dict(clf.run())
    wall = time.perf_counter() - t0
    _write_obs(args, tracer, {clf.track: deployed}, None, tag="serve-classify")

    print(f"[serve-classify] {g.name} ({args.backend}, {device}): {args.requests} requests, "
          f"{len(images)} images, batch {args.batch}")
    print(f"[serve-classify] {clf.images_stepped} images in {clf.tick_index} ticks, "
          f"{wall:.3f} s -> {clf.images_stepped / wall:.0f} images/s; step "
          f"captures/builds {clf.trace_count} (captured: {clf.captured})")
    failures = []
    if len(answers) != args.requests:
        failures.append(f"{args.requests - len(answers)}/{args.requests} requests unanswered")
    else:
        got = np.concatenate([answers[f"request-{i}"] for i in range(args.requests)])
        if not np.isfinite(got).all():
            failures.append("non-finite logits")
        for lo in range(0, len(images), args.batch):
            x = torch.from_numpy(images[lo:lo + args.batch]).to(device)
            want = deployed.forward(x, backend=args.backend).cpu().numpy()
            if not np.array_equal(got[lo:lo + len(want)], want):
                failures.append(f"images {lo}..{lo + len(want) - 1}: served logits != "
                                "an eager forward's")
                break
    print(f"[serve-classify] served == eager forward on every answered image: "
          f"{not failures}")
    rep = deployed.silicon_report(v=0.5)
    print(f"[serve-classify] CUTIE @0.5V would classify {rep.inf_per_s:.0f} images/s at "
          f"{rep.energy_uj:.2f} uJ/image")
    for f in failures:
        print(f"[serve-classify] FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


def serve_fleet_scenario(args) -> int:
    """Multi-tenant fleet simulation over a `repro_torch.serving.FleetRouter`.

    ``--fleet-nets`` registry TCN nets are registered as fleet tenants; each
    gets ``--streams`` sensors (default 4) whose arrivals interleave across
    nets (sensor s of net i arrives at tick i + s * n_nets), so every
    bucket sees admissions, departures, autoscaling and FIFO spill.  Exit
    non-zero on any pooled-vs-lone-session logit mismatch, non-finite
    logits, incomplete streams, or any bucket pool built twice or building
    its step program twice.  ``--out`` writes the fleet stats report as
    JSON.  ``--gate`` runs the fleet activity-gated on a bursty
    ``--duty-cycle`` trace: each gated stream must reproduce a lone session
    fed exactly the frames `ActivityGate.plan` selects, its processed count
    must match the plan, and each net must show a strictly positive energy
    saving (silicon-model uJ) whenever the trace leaves frames quiet."""
    import dataclasses
    import json

    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline, KWSSpectrogramPipeline
    from repro_torch.serving import (
        ActivityGate,
        FleetRouter,
        StreamRequest,
        energy_summary,
    )

    device = resolve_device(args.device)
    net_names = [n.strip() for n in args.fleet_nets.split(",") if n.strip()]
    if len(net_names) < 2:
        print(f"[serve-fleet] need >= 2 nets, got {net_names}", file=sys.stderr)
        return 2
    n_streams = args.streams or 4
    gate = None
    if args.gate:
        gate = ActivityGate(
            wake_threshold=args.wake_threshold,
            park_threshold=args.park_threshold,
            park_after=args.park_after,
        )
    duty = args.duty_cycle if args.duty_cycle is not None else (
        0.4 if args.gate else 1.0
    )
    tracer = _make_tracer(args)
    router = FleetRouter(
        backend=args.backend,
        max_pool_size=args.pool,
        queue_limit=args.queue_limit,
        shrink_after=args.shrink_after,
        ingest=args.ingest,
        sharding="auto" if args.shard else None,
        gate=gate,
        tracer=tracer,
    )
    deps, clips = {}, {}
    for idx, name in enumerate(net_names):
        prog = get_net(name)
        g = prog.graph
        if not g.is_temporal:
            print(f"[serve-fleet] {name} is not temporal; pick TCN nets",
                  file=sys.stderr)
            return 2
        pipe_cls = DVSEventPipeline if g.input_ch == 2 else KWSSpectrogramPipeline
        pipe = pipe_cls(
            n_streams, steps=args.frames, hw=g.input_hw[0],
            n_classes=g.n_classes, seed=args.seed + idx, duty_cycle=duty,
        )
        frames, labels = pipe.next_batch()
        params = prog.init(torch.Generator().manual_seed(args.seed + idx), device=device)
        deps[name] = prog.quantize(params, calib=torch.from_numpy(frames).to(device))
        router.register(name, deps[name])
        for s in range(n_streams):
            sid = f"{name}/sensor-{s}"
            clips[sid] = frames[s]
            router.submit(StreamRequest(
                stream_id=sid, frames=clips[sid], label=int(labels[s]),
                arrival=idx + s * len(net_names), net=name,
            ))

    t0 = time.time()
    results = router.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    stats = router.stats()
    agg = stats["aggregate"]

    threaded = any(s["ingest_threaded"] for s in stats["nets"].values())
    gating = (f", gated duty~{duty:.2f}" if gate is not None else "")
    print(f"[serve-fleet] {len(net_names)} nets x {n_streams} sensors x "
          f"{args.frames} frames ({args.backend}, {device}, ladder cap {args.pool}, "
          f"ingest={'thread' if threaded else 'sync'}{gating})")
    print(f"[serve-fleet] {agg['frames_processed']} frames, "
          f"{agg['completed']} streams in {agg['ticks']} ticks, {wall:.2f} s; "
          f"fleet p50 {agg['latency_ms_p50']:.1f} ms / "
          f"p99 {agg['latency_ms_p99']:.1f} ms per tick")
    failures = []
    for name in net_names:
        s = stats["nets"][name]
        scale = "".join(
            f" {e['from_size']}->{e['to_size']}" for e in s["scale_events"]
        ) or " (none)"
        print(f"[serve-fleet]   {name}: completed {s['completed']}, "
              f"built {s['pools_built']}, stepped {s['pools_traced']}, "
              f"scale{scale}, p50 {s['latency_ms_p50']:.1f} ms")
        # zero-rebuild contract: every rung's pool constructed once, and no
        # pool ever built (on the card: captured) its step twice
        bad = {sz: n for sz, n in s["pools_built"].items() if n > 1}
        bad.update({sz: tc for sz, tc in s["pools_traced"].items() if tc > 1})
        if bad:
            failures.append(f"{name}: rebuilt pools {bad}")
        if not any(tc == 1 for tc in s["pools_traced"].values()):
            failures.append(f"{name}: no pool ever stepped (bucket never ran)")

    # per-stream bit-exactness vs lone StreamSessions.  Gated: the lone
    # session is fed exactly the frames ActivityGate.plan selects
    finite = all(
        np.isfinite(r.logits).all() for r in results if r.logits is not None
    )
    checked = mismatched = 0
    for r in results:
        clip = clips[r.stream_id]
        if gate is None:
            processed = list(range(clip.shape[0]))
        else:
            plan = gate.plan([ActivityGate.activity(f) for f in clip])
            processed = [t for t, p in enumerate(plan) if p]
            if r.frames_processed != len(processed):
                mismatched += 1
                failures.append(
                    f"{r.stream_id}: processed {r.frames_processed} frames, "
                    f"gate plan says {len(processed)}")
                continue
        checked += 1
        if not processed:
            if r.logits is not None:
                mismatched += 1
                failures.append(f"{r.stream_id}: all-quiet stream has logits")
            continue
        session = deps[r.net].stream(batch=1, backend=args.backend)
        for t in processed:
            ref = session.step(torch.from_numpy(clip[t][None]).to(device))
        if r.logits is None or not (ref.detach().cpu().numpy()[0] == r.logits).all():
            mismatched += 1
            failures.append(f"{r.stream_id}: pooled logits != lone session")
    print(f"[serve-fleet] bit-exactness: {checked} streams replayed"
          f"{' (gated frame plan)' if gate is not None else ''}, "
          f"{mismatched} mismatches; logits finite: {finite}")
    if not finite:
        failures.append("non-finite logits")
    if len(results) != len(net_names) * n_streams:
        failures.append(
            f"{len(results)}/{len(net_names) * n_streams} streams completed")

    energy = {}
    if gate is not None:
        for name in net_names:
            sg = stats["nets"][name]["gating"]
            nres = [r for r in results if r.net == name]
            energy[name] = energy_summary(
                deps[name],
                frames_processed=sg["frames_processed"],
                frames_total=sg["frames_processed"] + sg["frames_skipped"],
                completed=sum(1 for r in nres if r.logits is not None),
            )
            e = energy[name]
            print(f"[serve-fleet]   {name}: {e['frames_skipped']} of "
                  f"{e['frames_total']} frames skipped -> "
                  f"{e['energy_uj_saved']:.2f} uJ saved on the CUTIE silicon "
                  f"model, {e['energy_uj_per_classification']:.2f} "
                  f"uJ/classification (ungated "
                  f"{e['energy_uj_per_classification_ungated']:.2f})")
            if duty < 1.0 and not e["energy_uj_saved"] > 0.0:
                failures.append(
                    f"{name}: non-positive gated energy saving "
                    f"({e['energy_uj_saved']:.3f} uJ at duty {duty:.2f})")

    # the rebuild audit and gated savings land in the metrics registry too,
    # so a --metrics-out snapshot carries the zero-rebuild and energy story
    # next to the occupancy/latency series
    m_trace = router.metrics.gauge(
        "cutie_trace_count",
        "Step builds per (net, pool rung): CUDA-graph captures on the card, "
        "eager builds on the CPU; contract: <= 1")
    for name in net_names:
        for sz, tc in stats["nets"][name]["pools_traced"].items():
            m_trace.labels(net=name, pool_size=str(sz)).set(tc)
    if energy:
        m_saved = router.metrics.gauge(
            "cutie_gate_energy_saved_uj", "uJ the activity gate saved")
        for name, e in energy.items():
            m_saved.labels(net=name).set(e["energy_uj_saved"])
    _write_obs(args, tracer, deps, router.metrics, tag="serve-fleet")

    if args.out:
        report = {"scenario": {
            "nets": net_names, "streams_per_net": n_streams,
            "frames": args.frames, "backend": args.backend,
            "device": str(device), "ladder_cap": args.pool, "wall_s": wall,
            "gate": dataclasses.asdict(gate) if gate is not None else None,
            "duty_cycle": duty,
        }, "stats": stats, "energy": energy or None, "failures": failures}
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=float)
        print(f"[serve-fleet] report -> {args.out}")
    router.close()
    for msg in failures:
        print(f"[serve-fleet] FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


def _make_tracer(args):
    """A `repro_torch.obs.Tracer` when ``--trace`` was given, else None (the
    serving layer then runs on NULL_TRACER — zero overhead)."""
    if not args.trace:
        return None
    from repro_torch.obs import Tracer

    return Tracer(clock=args.trace_clock)


def _write_obs(args, tracer, programs, metrics, tag: str) -> None:
    """Write the ``--trace`` Perfetto JSON (serving spans, the pools' device
    spans + one sim layer-timeline track per served program) and the
    ``--metrics-out`` Prometheus snapshot, when requested.  Device spans
    still pending are waited for first."""
    if tracer is not None:
        from repro_torch.obs import save_chrome
        from repro_torch.obs.device import resolve_pending

        resolve_pending(tracer)

        save_chrome(
            args.trace, tracer, sim_programs=programs,
            meta={"scenario": tag, "backend": args.backend, "device": args.device},
        )
        print(f"[{tag}] trace -> {args.trace} ({len(tracer)} events, "
              f"{tracer.dropped} dropped; load in ui.perfetto.dev)")
    if args.metrics_out and metrics is not None:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.render())
        print(f"[{tag}] metrics -> {args.metrics_out}")


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
        description="repro_torch serving launcher (LM prefill + decode, DVS "
                    "multi-sensor pool, multi-net fleet, batch classification)")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b",
                    help="LM: architecture to serve (the default path)")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the architecture's reduced SMOKE config")
    ap.add_argument("--quant", default="none",
                    choices=["none", "ternary", "ternary_packed"],
                    help="LM: weight quantization (ternary_packed: 2-bit weights)")
    ap.add_argument("--batch", type=int, default=4,
                    help="LM: prompts per batch; classify: images per tick")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM: prompt tokens")
    ap.add_argument("--tokens", type=int, default=16,
                    help="LM: tokens generated per prompt (prefill's + decode steps)")
    ap.add_argument("--dvs", action="store_true",
                    help="serve DVS sensor streams through a SessionPool")
    ap.add_argument("--classify", action="store_true",
                    help="serve image requests through a BatchClassifier")
    ap.add_argument("--requests", type=int, default=16,
                    help="classify: requests of 1 to 2x --batch images each")
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS))
    ap.add_argument("--frames", type=int, default=8,
                    help="event frames per sensor stream")
    ap.add_argument("--net", default="dvs_cnn_tcn",
                    help="dvs, classify: registry net to serve (e.g. dvs_cnn_tcn_smoke, "
                         "cifar10_tnn)")
    ap.add_argument("--program", default=None, metavar="FILE.cutie",
                    help="dvs: serve a .cutie artifact (repro_torch.artifact) "
                         "instead of quantizing --net")
    ap.add_argument("--pool", type=int, default=4,
                    help="dvs: SessionPool slots (fixed batch width); with "
                         "--fleet: the bucket ladder's cap")
    ap.add_argument("--streams", type=int, default=0,
                    help="dvs: total sensor streams to serve (0 = 2x pool); "
                         "with --fleet: streams PER NET (0 = 4)")
    ap.add_argument("--fleet", action="store_true",
                    help="multi-tenant FleetRouter scenario over --fleet-nets "
                         "instead of a single SessionPool")
    ap.add_argument("--fleet-nets",
                    default="dvs_cnn_tcn_smoke,dvs_cnn_tcn_micro,dvs_cnn_tcn_nano",
                    help="fleet: comma-separated registry nets to register as "
                         "tenants (>= 2, temporal only)")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="fleet: bounded admission FIFO per bucket; overflow "
                         "raises FleetQueueFull")
    ap.add_argument("--shrink-after", type=int, default=3,
                    help="fleet: calm ticks before a bucket shrinks down the "
                         "ladder (grow is immediate)")
    ap.add_argument("--ingest", default="auto",
                    choices=["auto", "thread", "sync", "off"],
                    help="fleet: host-side frame ingestion — a feeder thread "
                         "filling the pool's staging ring (auto/thread), "
                         "synchronous assembly (sync), or no prefetch at all (off)")
    ap.add_argument("--gate", action="store_true",
                    help="fleet: activity-gate the streams (park quiet sensors "
                         "out of their pool slot, wake on events; adds the "
                         "gated bit-exactness and energy-saving gates)")
    ap.add_argument("--duty-cycle", type=float, default=None,
                    help="fleet: fraction of frames carrying events in the "
                         "synthetic traces (default 1.0, or 0.4 with --gate)")
    ap.add_argument("--wake-threshold", type=int, default=16,
                    help="gate: event count that wakes a parked stream")
    ap.add_argument("--park-threshold", type=int, default=4,
                    help="gate: event count below which a frame is quiet")
    ap.add_argument("--park-after", type=int, default=2,
                    help="gate: consecutive quiet frames before parking")
    ap.add_argument("--out", default=None, metavar="FILE.json",
                    help="fleet: write the full stats report as JSON")
    ap.add_argument("--trace", default=None, metavar="FILE.json",
                    help="record a repro_torch.obs trace of the run and write it "
                         "as Chrome/Perfetto trace JSON (tick/step/feeder spans, "
                         "park/wake/scale instants, sim layer timelines; inspect "
                         "with python -m repro_torch.obs)")
    ap.add_argument("--trace-clock", default="wall", choices=["wall", "tick"],
                    help="trace timestamps: wall ns (default) or the "
                         "deterministic per-event sequence")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.prom",
                    help="dvs, fleet: write the serving metrics registry as a "
                         "Prometheus text snapshot")
    ap.add_argument("--shard", action="store_true",
                    help="dvs/fleet: shard each pool's slot axis across the local "
                         "cards (sharding='auto')")
    ap.add_argument("--check-streams", type=int, default=2,
                    help="dvs: streams replayed through single sessions for the "
                         "bit-exactness gate (the fleet replays every stream)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.fleet:
        return serve_fleet_scenario(args)
    if args.classify:
        return serve_classify(args)
    if args.dvs:
        return serve_dvs(args)
    return serve_lm(args)


if __name__ == "__main__":
    sys.exit(main())
