"""`repro_torch.obs` (tracer and metrics registry) held against `repro.obs`
on the CPU, and the observability wiring of the port's serving stack.

  * `MetricsRegistry.render()` gives the reference's text after the same
    operations, and `SampleWindow` the same percentiles;
  * `Tracer` records the reference's event sequence under the tick clock;
    `NULL_TRACER` records nothing;
  * tracing never alters serving (logits byte-identical), and the
    tick-clock event sequence of a gated 2-bucket fleet is the same in the
    port and in the reference;
  * a fleet run fills the same metric series as the reference's.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.program import DeployedProgram as DeployedJ
from repro.obs import MetricsRegistry as MetricsRegistryJ
from repro.obs import SampleWindow as SampleWindowJ
from repro.obs import Tracer as TracerJ
from repro.serving import ActivityGate as ActivityGateJ
from repro.serving import FleetRouter as FleetRouterJ
from repro.serving import StreamRequest as RequestJ
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.obs import (
    NULL_TRACER,
    PORT_EVENTS,
    MetricsRegistry,
    NullTracer,
    SampleWindow,
    Tracer,
)
from repro_torch.serving import ActivityGate, ContinuousBatcher, FleetRouter, StreamRequest
from repro_torch.serving.scheduler import LATENCY_WINDOW

GATE = ActivityGate(wake_threshold=8, park_threshold=3, park_after=2)
GATE_J = ActivityGateJ(wake_threshold=8, park_threshold=3, park_after=2)


def tiny_graph(api, name="tiny_obs"):
    return api.CutieGraph(
        name=name, input_hw=(4, 4), input_ch=2, n_classes=3, tcn_steps=4,
        layers=(api.conv2d(2, 4), api.global_pool(),
                api.tcn(4, 4, dilation=1), api.tcn(4, 4, dilation=2),
                api.last_step(), api.fc(4, 3)),
    )


def _tables(x, leaf):
    if isinstance(x, dict):
        return {k: _tables(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables(v, leaf) for v in x]
    return leaf(x)


@pytest.fixture(scope="module")
def pair():
    """The tiny net quantized by the port and handed as numpy to both
    packages: (reference DeployedProgram, port DeployedProgram)."""
    prog = tapi.CutieProgram(tiny_graph(tapi))
    calib = (torch.rand((2, 6, 4, 4, 2), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    tables = _tables(prog.quantize(
        prog.init(torch.Generator().manual_seed(0), device="cpu"), calib=calib).tables,
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v)
    ref = DeployedJ(tiny_graph(japi), _tables(
        tables, lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v))
    return ref, convert.deployed_from_reference_tables(tiny_graph(tapi), tables, device="cpu")


def event_clips(n_streams, frames, seed=7):
    return (np.random.default_rng(seed).random((n_streams, frames, 4, 4, 2)) < 0.3
            ).astype(np.float32)


def bursty_clips(n_streams, frames):
    """Alternating quiet / burst frames so the gate parks and wakes."""
    clips = np.zeros((n_streams, frames, 4, 4, 2), np.float32)
    for s in range(n_streams):
        for t in range(frames):
            if (t // 2 + s) % 2 == 0:
                clips[s, t].reshape(-1)[: GATE.wake_threshold + 2] = 1.0
    return clips


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def _drive_registry(reg):
    c = reg.counter("cutie_frames_processed_total", "Frames run on device")
    c.labels(net="dvs_a").inc()
    c.labels(net="dvs_a").inc(4)
    c.labels(net="kws").inc(2.5)
    reg.gauge("cutie_pool_occupancy", "Active slots / pool size").labels(net="dvs_a").set(0.75)
    reg.gauge("cutie_queue_depth", "Waiting").set(3)
    h = reg.histogram("cutie_tick_seconds", "Wall time per tick")
    for v in (3.2e-4, 1e-5, 0.02, 7.0, 11.0, 2.5e-3):
        h.labels(net="dvs_a", pool_size="4").observe(v)
    h.labels(net="kws", pool_size="8").observe(1e-3)
    custom = reg.histogram("custom_seconds", "Custom buckets", buckets=(0.5, 0.1, 1.0))
    custom.observe(0.2)
    custom.observe(0.05)
    reg.counter("cutie_frames_processed_total")  # idempotent re-declaration
    return reg


def test_metrics_render_equals_reference():
    got, want = _drive_registry(MetricsRegistry()), _drive_registry(MetricsRegistryJ())
    assert got.render() == want.render()
    assert got.snapshot() == want.snapshot()
    assert got.get("cutie_tick_seconds").value_for(net="dvs_a", pool_size="4") == \
        want.get("cutie_tick_seconds").value_for(net="dvs_a", pool_size="4")


def test_metrics_kind_checks_and_counter_monotonic():
    reg = MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x_total")
    with pytest.raises(ValueError, match="counters only go up"):
        reg.counter("x_total").inc(-1)


def test_sample_window_percentiles_equal_reference():
    seen = []
    got = SampleWindow(64, observe=seen.append)
    want = SampleWindowJ(64)
    r = np.random.default_rng(0)
    for v in r.exponential(1e-3, size=200):
        got.append((4, float(v)))
        want.append((4, float(v)))
    assert len(got) == 64 == got.capacity and len(seen) == 200
    for q in (50, 90, 99):
        assert np.percentile([s for _, s in got], q) == np.percentile([s for _, s in want], q)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _drive_tracer(tr):
    with tr.span("tick", track="dvs_a", tick=0):
        with tr.span("assemble", track="dvs_a"):
            pass
        tr.instant("wake", track="dvs_a", stream="cam-0")
    tr.counter("occupancy", 0.75, track="dvs_a")
    tr.counter("multi", {"a": 1, "b": 2})
    return tr


def test_tick_clock_events_equal_reference():
    got, want = _drive_tracer(Tracer(clock="tick")), _drive_tracer(TracerJ(clock="tick"))
    assert [tuple(e) for e in got.events()] == [tuple(e) for e in want.events()]
    assert got.thread_names == want.thread_names == {0: "main"}


def test_ring_wraparound_and_config():
    tr = Tracer(capacity=3, clock="tick")
    for i in range(5):
        tr.instant(f"e{i}")
    assert [e.name for e in tr.events()] == ["e2", "e3", "e4"] and tr.dropped == 2
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)
    with pytest.raises(ValueError, match="unknown clock"):
        Tracer(clock="gpu")


def test_null_tracer_records_nothing():
    assert isinstance(NULL_TRACER, NullTracer) and not NULL_TRACER
    s1, s2 = NULL_TRACER.span("a"), NULL_TRACER.span("b", track="x", k=1)
    assert s1 is s2
    with s1:
        NULL_TRACER.instant("i")
        NULL_TRACER.counter("c", 1)
    assert NULL_TRACER.events() == []


def test_wall_clock_spans_and_thread_tags():
    tr = Tracer()

    def worker():
        with tr.span("feeder.fill"):
            pass

    t = threading.Thread(target=worker, name="cutie-feeder_0")
    with tr.span("tick", track="a"):
        t.start()
        t.join()
    names = tr.thread_names
    assert set(names.values()) == {"main", "cutie-feeder_0"}
    tick = next(e for e in tr.events() if e.name == "tick")
    assert tick.dur >= 0 and tick.track == "a"


# ---------------------------------------------------------------------------
# the serving stack, observed
# ---------------------------------------------------------------------------

def _drive_pool(deployed, clips, tracer):
    pool = deployed.serve(2, backend="fused")
    batcher = ContinuousBatcher(pool, tracer=tracer)
    for i in range(clips.shape[0]):
        batcher.submit(StreamRequest(f"s{i}", clips[i], arrival=i))
    results = batcher.run()
    return batcher, pool, {r.stream_id: r.logits for r in results}


def test_traced_run_logits_byte_identical(pair):
    clips = event_clips(6, 5)
    batcher0, _, plain = _drive_pool(pair[1], clips, tracer=None)
    assert batcher0.tracer is NULL_TRACER and batcher0.pool.tracer is NULL_TRACER
    tracer = Tracer()
    batcher, pool, traced = _drive_pool(pair[1], clips, tracer=tracer)
    assert plain.keys() == traced.keys()
    for sid in plain:
        assert plain[sid].tobytes() == traced[sid].tobytes()
    assert pool.trace_count == 1
    spans = {e.name for e in tracer.events() if e.phase == "X"}
    assert {"tick", "admit", "assemble", "step", "pool.step"} <= spans
    assert batcher.track == "tiny_obs"


def test_latency_trace_is_bounded(pair):
    batcher = ContinuousBatcher(pair[1].serve(2, backend="fused"))
    assert isinstance(batcher.latency_trace, SampleWindow)
    assert batcher.latency_trace.maxlen == LATENCY_WINDOW
    for _ in range(LATENCY_WINDOW + 100):
        batcher.latency_trace.append((2, 1e-3))
    assert len(batcher.latency_trace) == LATENCY_WINDOW
    stats = batcher.stats()
    assert stats["latency_ms_p50"] == pytest.approx(1.0)
    series = batcher.metrics.get("cutie_tick_seconds").labels(net=batcher.track, pool_size="2")
    assert series.count == LATENCY_WINDOW + 100


def _gated_fleet(package, deployed, backend):
    """One gated 2-bucket fleet scenario under the deterministic clock."""
    Router, Request, Trace, gate, arr = (
        (FleetRouter, StreamRequest, Tracer, GATE, lambda c: c) if package == "port"
        else (FleetRouterJ, RequestJ, TracerJ, GATE_J, jnp.asarray))
    tracer = Trace(clock="tick")
    router = Router(backend=backend, max_pool_size=2, ingest="sync", gate=gate, tracer=tracer)
    router.register("net_a", deployed)
    router.register("net_b", deployed)
    clips = bursty_clips(4, 8)
    for i in range(4):
        router.submit(Request(stream_id=f"s{i}", frames=arr(clips[i]), arrival=i,
                              net="net_a" if i % 2 == 0 else "net_b"))
    results = router.run()
    router.close()
    finals = {r.stream_id: None if r.logits is None else np.asarray(r.logits)
              for r in results}
    return tracer, router, finals


def _reference_view(events):
    """The events the reference also emits (the port's own, `PORT_EVENTS`,
    left out), their tick-clock stamps renumbered by rank: the order of
    every start and end, and so the nesting, is kept."""
    kept = [e for e in events if e.name not in PORT_EVENTS]
    stamps = sorted({t for e in kept for t in (e.ts, e.ts + e.dur)})
    rank = {t: i for i, t in enumerate(stamps)}
    return [(e.phase, e.name, rank[e.ts], rank[e.ts + e.dur] - rank[e.ts], e.track, e.args)
            for e in kept]


def test_gated_fleet_tick_trace_equals_reference(pair):
    """The schedule is the trace: the port's fused fleet and the
    reference's ref fleet emit the same tick-clock event sequence (names,
    lanes, timestamps, arguments) and the same logits, once the port's own
    events are left out."""
    tr, router, fin = _gated_fleet("port", pair[1], "fused")
    tr_j, router_j, fin_j = _gated_fleet("reference", pair[0], "ref")
    sig = _reference_view(tr.events())
    sig_j = _reference_view(tr_j.events())
    assert sig == sig_j
    assert len(sig_j) == len(tr_j.events())  # the reference emits none of the port's
    assert {e.name for e in tr.events()} - {e.name for e in tr_j.events()} == {
        "advance", "flush", "pool.upload", "pool.replay", "pool.build"}
    assert {e.name for e in tr.events() if e.phase == "i"} >= {"park", "wake"}
    assert fin.keys() == fin_j.keys()
    for sid, want in fin_j.items():
        if want is None:
            assert fin[sid] is None
        else:
            np.testing.assert_array_equal(fin[sid], want)
    # the always-on registries hold the same series, bar wall-clock sums
    def no_sums(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("cutie_tick_seconds_bucket")
                and not ln.startswith("cutie_tick_seconds_sum")]
    assert no_sums(router.metrics.render()) == no_sums(router_j.metrics.render())
