"""`repro_torch.serving.fleet`, the scheduler's fleet hooks and the
launcher's ``--fleet`` / ``--program`` paths, held against the reference on
the CPU.

  * `bucket_ladder` equals the reference's;
  * on one submission schedule over the smoke / micro / nano registry nets
    (deploy tables handed to both packages as numpy), the port's
    ``stats()["nets"][*]["scale_events"]`` equal the reference's, and each
    stream's logits equal the reference fleet's;
  * every rung's pool is constructed once and builds its step program at
    most once, through grow and shrink bounces;
  * `FleetQueueFull`, `cancel` and `swap_pool` behave as in the reference;
    feeder-thread ingestion gives the same bits as synchronous ingestion;
  * `serve_fleet` works from `DeployedProgram`s and from ``.cutie``
    `LoadedProgram`s, and the launcher's fleet, gate and program paths
    exit 0 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.program import DeployedProgram as DeployedJ
from repro.data import pipeline as jpipe
from repro.serving import FleetRouter as FleetRouterJ
from repro.serving import StreamRequest as RequestJ
from repro.serving import bucket_ladder as bucket_ladder_j
from repro_torch import api as tapi
from repro_torch import artifact
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (
    ContinuousBatcher,
    FleetQueueFull,
    FleetRouter,
    FrameFeeder,
    NetBucket,
    ScaleEvent,
    SessionPool,
    StreamRequest,
    bucket_ladder,
    serve_fleet,
)

REGISTRY_NETS = ("dvs_cnn_tcn_smoke", "dvs_cnn_tcn_micro", "dvs_cnn_tcn_nano")


def _tables(x, leaf):
    if isinstance(x, dict):
        return {k: _tables(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables(v, leaf) for v in x]
    return leaf(x)


def _pair(graph_t, graph_j, seed):
    """A net quantized by the port and handed as numpy to both packages:
    (reference DeployedProgram, port DeployedProgram)."""
    prog = tapi.CutieProgram(graph_t)
    g = prog.graph
    calib = (torch.rand((2, 4, *g.input_hw, g.input_ch),
                        generator=torch.Generator().manual_seed(seed + 100)) < 0.3).float()
    tables = _tables(prog.quantize(
        prog.init(torch.Generator().manual_seed(seed), device="cpu"), calib=calib).tables,
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v)
    ref = DeployedJ(graph_j, _tables(
        tables, lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v))
    return ref, convert.deployed_from_reference_tables(graph_t, tables, device="cpu")


def tiny_net(api, name, *, input_ch, width, tcn_steps, n_classes):
    return api.CutieGraph(
        name=name, input_hw=(4, 4), input_ch=input_ch, n_classes=n_classes,
        tcn_steps=tcn_steps,
        layers=(api.conv2d(input_ch, width), api.global_pool(),
                api.tcn(width, width, dilation=1), api.tcn(width, width, dilation=2),
                api.last_step(), api.fc(width, n_classes)),
    )


TINY_SPECS = {
    "tiny_a": dict(input_ch=2, width=4, tcn_steps=4, n_classes=3),
    "tiny_b": dict(input_ch=3, width=6, tcn_steps=3, n_classes=4),
    "tiny_c": dict(input_ch=2, width=5, tcn_steps=5, n_classes=2),
}


@pytest.fixture(scope="module")
def tiny():
    """{name: port DeployedProgram} for three distinct tiny temporal nets."""
    return {name: _pair(tiny_net(tapi, name, **spec), tiny_net(japi, name, **spec), i)[1]
            for i, (name, spec) in enumerate(TINY_SPECS.items())}


@pytest.fixture(scope="module")
def registry_pairs():
    return {name: _pair(tapi.get_graph(name), japi.get_graph(name), i)
            for i, name in enumerate(REGISTRY_NETS)}


def _nano_bytes():
    prog = tapi.get_net("dvs_cnn_tcn_nano")
    return prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu")
                         ).to_artifact_bytes()


def clips_for(graph, n_streams, frames, seed=0):
    shape = (n_streams, frames, *graph.input_hw, graph.input_ch)
    return (np.random.default_rng(seed).random(shape) < 0.3).astype(np.float32)


def lone_logits(deployed, clip, backend="ref"):
    session = deployed.stream(batch=1, backend=backend)
    for t in range(clip.shape[0]):
        out = session.step(torch.from_numpy(clip[t][None]))
    return out.numpy()[0]


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,base", [(1, 1), (3, 1), (8, 1), (12, 1), (16, 1), (16, 4),
                                      (6, 2), (100, 3)])
def test_bucket_ladder_equals_reference(cap, base):
    assert bucket_ladder(cap, base=base) == bucket_ladder_j(cap, base=base)


@pytest.mark.parametrize("cap,base", [(0, 1), (4, 0), (2, 4)])
def test_bucket_ladder_rejects_bad_bounds(cap, base):
    with pytest.raises(ValueError, match="cap >= base >= 1"):
        bucket_ladder(cap, base=base)


# ---------------------------------------------------------------------------
# the fleet against the reference fleet
# ---------------------------------------------------------------------------

class TestAgainstReferenceFleet:
    def test_scale_events_and_logits_equal_reference(self, registry_pairs):
        """Three registry nets, 5 streams each: a first wave of 3 that
        overshoots the ladder cap of 2 (grow, FIFO spill), then a calm gap
        (shrink) and a second wave of 2 (grow again); shrink after 2 calm
        ticks."""
        router = FleetRouter(backend="fused", max_pool_size=2, shrink_after=2,
                             ingest="thread")
        router_j = FleetRouterJ(backend="ref", max_pool_size=2, shrink_after=2,
                                ingest="sync")
        clips = {}
        for i, (name, (ref, port)) in enumerate(registry_pairs.items()):
            router.register(name, port)
            router_j.register(name, ref)
            c = clips_for(port.graph, 5, 3, seed=50 + i)
            for s in range(5):
                sid = f"{name}/cam{s}"
                clips[sid] = c[s]
                arrival = i if s < 3 else 14
                router.submit(StreamRequest(sid, c[s], net=name, arrival=arrival))
                router_j.submit(RequestJ(sid, jnp.asarray(c[s]), net=name, arrival=arrival))
        got = {r.stream_id: r for r in router.run()}
        want = {r.stream_id: r for r in router_j.run()}
        stats, stats_j = router.stats(), router_j.stats()
        router.close()
        router_j.close()
        assert list(got) == list(want)
        for sid, r in got.items():
            np.testing.assert_array_equal(r.logits, np.asarray(want[sid].logits), err_msg=sid)
            assert (r.admitted_tick, r.finished_tick) == \
                (want[sid].admitted_tick, want[sid].finished_tick)
        for name in REGISTRY_NETS:
            s, s_j = stats["nets"][name], stats_j["nets"][name]
            assert s["scale_events"] == s_j["scale_events"]
            assert {e["reason"] for e in s["scale_events"]} == {"grow", "shrink"}
            assert s["pools_traced"] == s_j["pools_traced"]
            assert all(n == 1 for n in s["pools_built"].values())
            assert s["ingest_threaded"]
            for key in ("ticks", "completed", "frames_processed", "mean_occupancy",
                        "per_net", "ladder", "pool_size"):
                assert s[key] == s_j[key], key
        assert stats["aggregate"]["ticks"] == stats_j["aggregate"]["ticks"]


# ---------------------------------------------------------------------------
# NetBucket: admission bound, autoscale hysteresis, the rung cache
# ---------------------------------------------------------------------------

class TestNetBucket:
    def test_rejects_non_temporal_and_bad_settings(self, tiny):
        g = tapi.CutieGraph(name="tiny_spatial", input_hw=(4, 4), input_ch=2, n_classes=3,
                            layers=(tapi.conv2d(2, 4), tapi.global_pool(), tapi.fc(4, 3)))
        prog = tapi.CutieProgram(g)
        dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu"))
        with pytest.raises(ValueError, match="not temporal"):
            NetBucket("spatial", dep, backend="ref", ladder=(1, 2))
        with pytest.raises(ValueError, match="ascending"):
            NetBucket("a", tiny["tiny_a"], backend="ref", ladder=(4, 2, 1))
        with pytest.raises(ValueError, match="must be >= 1"):
            NetBucket("a", tiny["tiny_a"], backend="ref", ladder=(1, 2), queue_limit=0)

    def test_bounded_fifo_raises_fleet_queue_full(self, tiny):
        dep = tiny["tiny_a"]
        frames = clips_for(dep.graph, 4, 3, seed=30)
        bucket = NetBucket("tiny_a", dep, backend="ref", ladder=(1,), queue_limit=2,
                           ingest="sync")
        bucket.submit(StreamRequest("s0", frames[0]))
        bucket.submit(StreamRequest("s1", frames[1]))
        with pytest.raises(FleetQueueFull, match="admission FIFO full"):
            bucket.submit(StreamRequest("s2", frames[2]))
        bucket.tick()
        bucket.submit(StreamRequest("s3", frames[3]))
        while bucket.pending:
            bucket.tick()
        assert {r.stream_id for r in bucket.batcher.results} == {"s0", "s1", "s3"}
        bucket.close()

    def test_autoscale_grow_then_shrink_with_hysteresis(self, tiny):
        dep = tiny["tiny_a"]
        frames = clips_for(dep.graph, 5, 8, seed=31)
        bucket = NetBucket("tiny_a", dep, backend="ref", ladder=(1, 2, 4),
                           shrink_after=2, ingest="sync")
        for i in range(4):
            bucket.submit(StreamRequest(f"s{i}", frames[i]))
        assert bucket.size == 1
        bucket.tick()
        assert bucket.size == 4
        grow = bucket.scale_events[0]
        assert isinstance(grow, ScaleEvent)
        assert (grow.reason, grow.from_size, grow.to_size, grow.demand) == ("grow", 1, 4, 4)
        while bucket.batcher.inflight_count:
            bucket.tick()
        assert bucket.size == 4
        bucket.tick()
        assert bucket.size == 4
        bucket.tick()
        assert bucket.size == 1 and bucket.scale_events[-1].reason == "shrink"
        bucket.submit(StreamRequest("late", frames[4]))
        bucket.tick()
        assert bucket._calm_ticks == 0
        assert {s: p.trace_count for s, p in bucket.pools.items()} == {1: 1, 4: 1}
        assert bucket.pools_built == {1: 1, 4: 1}
        bucket.close()

    def test_regrow_reuses_the_cached_pool_object(self, tiny):
        """Bounce 1 -> 2 -> 1 -> 2: the second grow runs the SAME rung-2
        pool object (identity and construction count, not only the step
        program count)."""
        dep = tiny["tiny_b"]
        frames = clips_for(dep.graph, 4, 4, seed=32)
        bucket = NetBucket("tiny_b", dep, backend="ref", ladder=(1, 2), shrink_after=1,
                           ingest="sync")
        seen = {}
        for wave in range(2):
            for i in range(2):
                bucket.submit(StreamRequest(f"w{wave}s{i}", frames[2 * wave + i]))
            while bucket.pending:
                bucket.tick()
                seen.setdefault(bucket.size, set()).add(id(bucket.batcher.pool))
            bucket.tick()
            assert bucket.size == 1
        assert [e.reason for e in bucket.scale_events] == ["grow", "shrink", "grow", "shrink"]
        assert {s: p.trace_count for s, p in bucket.pools.items()} == {1: 0, 2: 1}
        assert bucket.pools_built == {1: 1, 2: 1}
        assert seen == {2: {id(bucket.pools[2])}}
        assert bucket.stats()["pools_built"] == {1: 1, 2: 1}
        bucket.close()


# ---------------------------------------------------------------------------
# the scheduler's fleet hooks: cancel and swap_pool
# ---------------------------------------------------------------------------

class TestCancelAndSwap:
    def test_cancel_queued_and_inflight(self, tiny):
        dep = tiny["tiny_a"]
        frames = clips_for(dep.graph, 3, 4, seed=33)
        bat = ContinuousBatcher(SessionPool(dep, 1, backend="ref"))
        for i in range(3):
            bat.submit(StreamRequest(f"s{i}", frames[i]))
        bat.tick()                                 # s0 in flight, s1/s2 queued
        assert bat.cancel("s1") == "queued"
        assert bat.cancel("s0") == "inflight"
        assert bat.pool.free_slots == 1
        with pytest.raises(KeyError, match="unknown or finished"):
            bat.cancel("s0")
        (r,) = bat.run()
        assert r.stream_id == "s2"
        np.testing.assert_array_equal(r.logits, lone_logits(dep, frames[2]))
        st = bat.stats()
        assert (st["cancelled"], st["completed"]) == (2, 1)
        assert bat.cancelled == ["s1", "s0"]

    def test_cancel_invalidates_the_feeder_prefetch(self, tiny):
        dep = tiny["tiny_c"]
        frames = clips_for(dep.graph, 3, 5, seed=34)
        feeder = FrameFeeder(mode="thread")
        bat = ContinuousBatcher(SessionPool(dep, 2, backend="ref"), feeder=feeder)
        for i in range(3):
            bat.submit(StreamRequest(f"s{i}", frames[i]))
        bat.tick()
        bat.cancel("s0")
        results = {r.stream_id: r for r in bat.run()}
        feeder.close()
        for sid in ("s1", "s2"):
            np.testing.assert_array_equal(results[sid].logits,
                                          lone_logits(dep, frames[int(sid[1])]))

    def test_swap_pool_migrates_bit_exactly(self, tiny):
        dep = tiny["tiny_a"]
        frames = clips_for(dep.graph, 3, 6, seed=35)
        small, big = SessionPool(dep, 1, backend="ref"), SessionPool(dep, 4, backend="ref")
        bat = ContinuousBatcher(big)
        for i in range(3):
            bat.submit(StreamRequest(f"s{i}", frames[i]))
        bat.tick()
        bat.tick()
        with pytest.raises(ValueError, match="cannot swap"):
            bat.swap_pool(small)
        mid = SessionPool(dep, 3, backend="ref")
        assert bat.swap_pool(mid) is big and bat.pool is mid
        assert bat.swap_pool(mid) is mid            # same pool: no-op
        assert len(big) == 0 and len(mid) == 3
        results = {r.stream_id: r for r in bat.run()}
        for i in range(3):
            np.testing.assert_array_equal(results[f"s{i}"].logits,
                                          lone_logits(dep, frames[i]))


# ---------------------------------------------------------------------------
# FleetRouter: routing, ingestion modes, entry points
# ---------------------------------------------------------------------------

class TestFleetRouter:
    def test_routing_errors(self, tiny):
        router = FleetRouter(backend="ref", max_pool_size=2, ingest="sync")
        clip = clips_for(tiny["tiny_a"].graph, 1, 2)[0]
        with pytest.raises(KeyError, match="no nets registered"):
            router.submit(StreamRequest("x", clip))
        router.register("tiny_a", tiny["tiny_a"])
        router.register("tiny_b", tiny["tiny_b"])
        with pytest.raises(ValueError, match="already registered"):
            router.register("tiny_a", tiny["tiny_a"])
        with pytest.raises(KeyError, match="unknown net 'nope'"):
            router.submit(StreamRequest("x", clip, net="nope"))
        with pytest.raises(KeyError, match="set StreamRequest.net"):
            router.submit(StreamRequest("x", clip))
        router.close()

    def test_queue_limit_propagates_and_overrides(self, tiny):
        router = FleetRouter(backend="ref", max_pool_size=1, queue_limit=1, ingest="sync")
        router.register("tiny_c", tiny["tiny_c"])
        router.register("roomy", tiny["tiny_a"], queue_limit=8)
        assert router.buckets["tiny_c"].queue_limit == 1
        assert router.buckets["roomy"].queue_limit == 8
        clip = clips_for(tiny["tiny_c"].graph, 2, 2, seed=70)
        router.submit(StreamRequest("a", clip[0], net="tiny_c"))
        with pytest.raises(FleetQueueFull):
            router.submit(StreamRequest("b", clip[1], net="tiny_c"))
        router.close()

    @pytest.mark.parametrize("backend", ["fused", "ref"])
    def test_thread_and_sync_ingestion_bit_identical(self, tiny, backend):
        per_mode = {}
        for mode in ("thread", "sync", "off"):
            router = serve_fleet(tiny, backend=backend, max_pool_size=2, ingest=mode)
            for i, (name, dep) in enumerate(tiny.items()):
                clips = clips_for(dep.graph, 3, 4, seed=60 + i)
                for s in range(3):
                    router.submit(StreamRequest(f"{name}/s{s}", clips[s], net=name,
                                                arrival=s))
            per_mode[mode] = {r.stream_id: r.logits for r in router.run()}
            threaded = [s["ingest_threaded"] for s in router.stats()["nets"].values()]
            assert all(threaded) if mode == "thread" else not any(threaded)
            router.close()
        for mode in ("sync", "off"):
            assert per_mode[mode].keys() == per_mode["thread"].keys()
            for sid, logits in per_mode["thread"].items():
                np.testing.assert_array_equal(per_mode[mode][sid], logits)

    def test_many_feeder_threads_under_a_short_switch_interval(self, tiny):
        """Stress: 12 buckets (12 feeder threads, more than this host's
        cores) with the interpreter switching threads every microsecond;
        every prefetched batch must still carry exactly the sync bits."""
        import sys

        def run(mode):
            router = FleetRouter(backend="ref", max_pool_size=2, ingest=mode)
            for k in range(4):
                for i, (name, dep) in enumerate(tiny.items()):
                    net = f"{name}_{k}"
                    router.register(net, dep)
                    clips = clips_for(dep.graph, 3, 4, seed=90 + 10 * k + i)
                    for s in range(3):
                        router.submit(StreamRequest(f"{net}/s{s}", clips[s], net=net,
                                                    arrival=s))
            results = {r.stream_id: r.logits for r in router.run(max_ticks=100)}
            router.close()
            return results

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threaded = run("thread")
        finally:
            sys.setswitchinterval(old)
        synced = run("sync")
        assert len(threaded) == len(synced) == 36
        for sid, logits in synced.items():
            np.testing.assert_array_equal(threaded[sid], logits)

    def test_deployed_and_loaded_program_serve_fleet(self, tiny):
        dep = tiny["tiny_a"]
        with dep.serve_fleet(backend="fused", max_pool_size=2, ingest="sync") as router:
            assert set(router.buckets) == {"tiny_a"}
            clip = clips_for(dep.graph, 1, 3, seed=80)[0]
            router.submit(StreamRequest("cam", clip))
            (result,) = router.run()
        assert result.net == "tiny_a"
        np.testing.assert_array_equal(result.logits, lone_logits(dep, clip))
        loaded = artifact.loads(tiny["tiny_b"].to_artifact_bytes(), device="cpu")
        with loaded.serve_fleet(max_pool_size=2, ingest="thread") as router:
            bucket = router.buckets["tiny_b"]
            assert bucket.backend == "bitsim" and bucket.program is loaded
            clips = clips_for(loaded.graph, 2, 3, seed=81)
            for s in range(2):
                router.submit(StreamRequest(f"s{s}", clips[s]))
            results = {r.stream_id: r for r in router.run()}
        for s in range(2):
            np.testing.assert_array_equal(results[f"s{s}"].logits,
                                          lone_logits(tiny["tiny_b"], clips[s]))

    def test_mixed_fleet_shares_one_executor_per_loaded_program(self, tiny):
        loaded = artifact.loads(tiny["tiny_c"].to_artifact_bytes(), device="cpu")
        router = FleetRouter(backend="ref", max_pool_size=4, ingest="sync")
        router.register("tiny_a", tiny["tiny_a"])
        router.register("tiny_c", loaded, backend="fused")
        clip_a = clips_for(tiny["tiny_a"].graph, 1, 3, seed=82)[0]
        clips_c = clips_for(loaded.graph, 4, 3, seed=83)
        router.submit(StreamRequest("a0", clip_a, net="tiny_a"))
        for s in range(4):
            router.submit(StreamRequest(f"c{s}", clips_c[s], net="tiny_c", arrival=s))
        results = {r.stream_id: r for r in router.run()}
        router.close()
        np.testing.assert_array_equal(results["a0"].logits, lone_logits(tiny["tiny_a"], clip_a))
        for s in range(4):
            np.testing.assert_array_equal(results[f"c{s}"].logits,
                                          lone_logits(tiny["tiny_c"], clips_c[s]))
        assert len(router.buckets["tiny_c"].pools) > 1
        assert list(loaded._executors) == ["fused"]


# ---------------------------------------------------------------------------
# FrameFeeder: the double-buffer prefetch unit
# ---------------------------------------------------------------------------

class TestFrameFeeder:
    SHAPE = (2, 2, 1)

    def _items(self, n, base=0.0):
        return [(f"s{i}", i, np.full((1, *self.SHAPE), base + i, np.float32), 0)
                for i in range(n)]

    @pytest.mark.parametrize("mode", ["thread", "sync"])
    def test_prefetch_take_round_trip(self, mode):
        feeder = FrameFeeder(mode=mode)
        assert feeder.take() is None
        feeder.prefetch(4, self.SHAPE, self._items(3))
        batch, active, covered = feeder.take()
        assert batch.shape == (4, *self.SHAPE) and batch.dtype == np.float32
        assert covered == {"s0": 0, "s1": 1, "s2": 2}
        assert list(active) == [True, True, True, False]
        assert all((batch[i] == float(i)).all() for i in range(3))
        assert (batch[3] == 0.0).all() and feeder.take() is None
        assert feeder.threaded == (mode == "thread")
        feeder.close()

    def test_tensor_clips_are_brought_to_the_host(self):
        feeder = FrameFeeder(mode="sync")
        feeder.prefetch(1, self.SHAPE, [("s", 0, torch.full((1, *self.SHAPE), 3.0), 0)])
        batch, _, _ = feeder.take()
        assert isinstance(batch, np.ndarray) and (batch == 3.0).all()
        feeder.close()

    def test_double_buffers_alternate_per_prefetch(self):
        feeder = FrameFeeder(mode="sync")
        feeder.prefetch(2, self.SHAPE, self._items(1, base=5.0))
        first, _, _ = feeder.take()
        feeder.prefetch(2, self.SHAPE, self._items(1, base=9.0))
        second, _, _ = feeder.take()
        assert first is not second and (first[0] == 5.0).all() and (second[0] == 9.0).all()
        feeder.prefetch(2, self.SHAPE, self._items(1, base=7.0))
        assert feeder.take()[0] is first
        feeder.close()

    def test_invalidate_and_unknown_mode(self):
        feeder = FrameFeeder(mode="thread")
        feeder.prefetch(2, self.SHAPE, self._items(2))
        feeder.invalidate()
        assert feeder.take() is None
        feeder.close()
        with pytest.raises(ValueError, match="unknown ingest mode"):
            FrameFeeder(mode="eager")


# ---------------------------------------------------------------------------
# pipelines and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,kw", [
    ("KWSSpectrogramPipeline", dict(steps=5, hw=16, duty_cycle=0.4)),
    ("KWSSpectrogramPipeline", dict(steps=3, hw=8)),
    ("CifarLikePipeline", dict(hw=8, noise=0.5)),
    ("DVSEventPipeline", dict(steps=3, hw=16, duty_cycle=0.5)),
])
def test_pipelines_byte_identical_to_reference(cls, kw):
    got = getattr(tpipe, cls)(3, seed=5, **kw)
    want = getattr(jpipe, cls)(3, seed=5, **kw)
    for _ in range(2):
        (x, y), (xj, yj) = got.next_batch(), want.next_batch()
        assert x.tobytes() == np.asarray(xj).tobytes()
        assert y.tobytes() == np.asarray(yj).tobytes()


@pytest.mark.parametrize("name", ["kws_tcn_smoke", "dvs_cnn_tcn_smoke", "cifar10_tnn_smoke"])
def test_pipeline_for_net_matches_reference(name):
    x, _ = tpipe.pipeline_for_net(tapi.get_graph(name), 2, seed=3).next_batch()
    xj, _ = jpipe.pipeline_for_net(japi.get_graph(name), 2, seed=3).next_batch()
    assert x.tobytes() == np.asarray(xj).tobytes()


class TestLauncher:
    def test_fleet_and_gated_fleet_exit_zero(self, tmp_path, capsys):
        out = tmp_path / "fleet.json"
        assert launch_serve.main(["--fleet", "--pool", "2", "--frames", "3", "--streams", "2",
                                  "--device", "cpu", "--out", str(out)]) == 0
        assert launch_serve.main(["--fleet", "--fleet-nets", "dvs_cnn_tcn_nano,kws_tcn_smoke",
                                  "--pool", "2", "--frames", "6", "--gate", "--ingest",
                                  "sync", "--device", "cpu"]) == 0
        text = capsys.readouterr().out
        assert "0 mismatches" in text and "gated frame plan" in text
        assert "CUTIE silicon model" in text
        import json
        report = json.loads(out.read_text())
        assert report["failures"] == [] and report["scenario"]["device"] == "cpu"

    def test_dvs_serves_a_program_file(self, tmp_path, tiny, capsys):
        path = tmp_path / "net.cutie"
        from repro_torch.artifact import __main__ as cli
        assert cli.main(["build", "dvs_cnn_tcn_nano", "-o", str(path), "--device", "cpu"]) == 0
        assert launch_serve.main(["--dvs", "--program", str(path), "--pool", "2",
                                  "--frames", "3", "--device", "cpu"]) == 0
        assert "program loaded from" in capsys.readouterr().out

    def test_fleet_needs_two_nets_and_temporal_nets(self):
        assert launch_serve.main(["--fleet", "--fleet-nets", "dvs_cnn_tcn_nano",
                                  "--device", "cpu"]) == 2
        assert launch_serve.main(["--fleet", "--fleet-nets",
                                  "dvs_cnn_tcn_nano,cifar10_tnn_smoke", "--device", "cpu"]) == 2

    def test_cuda_without_a_card_raises(self, tmp_path, monkeypatch):
        """The default device is the card; without one every entry point
        raises instead of moving to the CPU."""
        from repro_torch.artifact import __main__ as cli

        data = _nano_bytes()
        path = tmp_path / "net.cutie"
        path.write_bytes(data)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for argv in (["--fleet", "--pool", "2", "--frames", "2"],
                     ["--dvs", "--program", str(path), "--pool", "2", "--frames", "2"]):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                launch_serve.main(argv)
        for argv in (["verify", str(path)], ["info", str(path)],
                     ["build", "dvs_cnn_tcn_nano", "-o", str(tmp_path / "x.cutie")]):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                cli.main(argv)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            artifact.loads(data)

    @pytest.mark.parametrize("flag", ["--trace", "--trace-clock", "--metrics-out", "--shard"])
    def test_obs_and_shard_flags_are_not_defined_yet(self, flag, capsys):
        """The obs flags and ``--shard`` are defined, since the trace export
        (tests/test_torch_obs_export.py) and the split pool
        (tests/test_torch_serving_shard.py) are ported; ``--shard`` is a
        switch and takes no value."""
        if flag == "--shard":
            with pytest.raises(SystemExit) as exit_info:
                launch_serve.main(["--fleet", flag, "x", "--device", "cpu"])
            assert exit_info.value.code == 2
            assert "unrecognized arguments: x" in capsys.readouterr().err
        with pytest.raises(SystemExit) as exit_info:
            launch_serve.main(["--help"])
        assert exit_info.value.code == 0 and flag in capsys.readouterr().out
