"""`repro_torch.serving.gating` and the gated scheduler, held against
`repro.serving.gating` on the CPU.

  * `ActivityGate.plan` equals the reference's on hypothesis-drawn traces
    and gate settings; validation and `activity` behave the same;
  * a gated `ContinuousBatcher` processes exactly the plan's frames, and
    each stream's logits equal a lone batch-1 `StreamSession` fed exactly
    those frames, on ``fused`` and ``ref`` — and equal the reference's
    gated batcher on the same schedule (deploy tables handed to both
    packages as numpy);
  * a parked ring is a first-class `StreamState` that resumes
    bit-identically; an all-quiet stream never takes a slot;
  * `evaluate_frame`, `frame_energy_uj` and `energy_summary` equal the
    reference's for the same program.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import api as japi
from repro import artifact as jart
from repro.api.program import DeployedProgram as DeployedJ
from repro.serving import ActivityGate as ActivityGateJ
from repro.serving import ContinuousBatcher as BatcherJ
from repro.serving import SessionPool as SessionPoolJ
from repro.serving import StreamRequest as RequestJ
from repro.serving import energy_summary as energy_summary_j
from repro.serving import frame_energy_uj as frame_energy_uj_j
from repro.sim.counters import evaluate_frame as evaluate_frame_j
from repro_torch import api as tapi
from repro_torch import artifact
from repro_torch import convert
from repro_torch.core.tcn import StreamState, TCNStream
from repro_torch.serving import (
    ActivityGate,
    ContinuousBatcher,
    FleetRouter,
    GateState,
    SessionPool,
    StreamRequest,
    energy_summary,
    frame_energy_uj,
)
from repro_torch.sim.counters import evaluate_frame

BACKENDS = ("ref", "fused")
GATE = ActivityGate(wake_threshold=8, park_threshold=3, park_after=2)
GATE_J = ActivityGateJ(wake_threshold=8, park_threshold=3, park_after=2)


def tiny_graph(api, name="tiny_gating", tcn_steps=4):
    return api.CutieGraph(
        name=name, input_hw=(4, 4), input_ch=2, n_classes=3, tcn_steps=tcn_steps,
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


def _pair(name="tiny_gating", seed=0):
    """The tiny net quantized by the port and handed as numpy to both
    packages: (reference DeployedProgram, port DeployedProgram)."""
    prog = tapi.CutieProgram(tiny_graph(tapi, name))
    calib = (torch.rand((2, 6, 4, 4, 2), generator=torch.Generator().manual_seed(seed + 1))
             < 0.3).float()
    tables = _tables(prog.quantize(
        prog.init(torch.Generator().manual_seed(seed), device="cpu"), calib=calib).tables,
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v)
    ref = DeployedJ(tiny_graph(japi, name),
                    _tables(tables, lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v))
    return ref, convert.deployed_from_reference_tables(tiny_graph(tapi, name), tables,
                                                       device="cpu")


_PAIR = None


def get_pair():
    """Module-cached pair (a plain function: ``@given`` tests take no
    fixtures under the conftest hypothesis stub)."""
    global _PAIR
    if _PAIR is None:
        _PAIR = _pair()
    return _PAIR


@pytest.fixture(scope="module")
def deployed():
    return get_pair()[1]


def bursty_clip(seed, frames=12, hw=(4, 4), ch=2, gate=GATE):
    """Alternating runs of quiet (< park_threshold events) and burst
    (>= wake_threshold events) frames."""
    r = np.random.default_rng(seed)
    clip = np.zeros((frames, *hw, ch), np.float32)
    burst = bool(r.integers(0, 2))
    t = 0
    while t < frames:
        for _ in range(int(r.integers(1, 5))):
            if t >= frames:
                break
            a = (int(r.integers(gate.wake_threshold, hw[0] * hw[1] * ch))
                 if burst else int(r.integers(0, gate.park_threshold)))
            flat = clip[t].reshape(-1)
            flat[r.choice(flat.size, size=a, replace=False)] = 1.0
            t += 1
        burst = not burst
    return clip


def processed_frames(clip, gate=GATE):
    plan = gate.plan([ActivityGate.activity(f) for f in clip])
    return [t for t, p in enumerate(plan) if p]


def replay(deployed, clip, frame_idx, backend):
    """Lone batch-1 session fed exactly ``frame_idx``'s frames."""
    session = deployed.stream(batch=1, backend=backend)
    out = None
    for t in frame_idx:
        out = session.step(torch.from_numpy(clip[t][None]))
    return None if out is None else out.numpy()[0]


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

class TestActivityGate:
    @given(seed=st.integers(0, 10**6), n=st.integers(0, 40),
           park=st.integers(0, 6), extra=st.integers(1, 6), after=st.integers(1, 4))
    @settings(max_examples=60, deadline=None)
    def test_plan_equals_reference_on_drawn_traces(self, seed, n, park, extra, after):
        wake = park + extra
        r = np.random.default_rng(seed)
        trace = [int(a) for a in r.integers(0, wake + 3, size=n)]
        got = ActivityGate(wake, park, after).plan(trace)
        assert got == ActivityGateJ(wake, park, after).plan(trace)
        assert len(got) == n

    @pytest.mark.parametrize("kw", [dict(wake_threshold=4, park_threshold=4),
                                    dict(park_threshold=-1), dict(park_after=0),
                                    dict(wake_threshold=2, park_threshold=3)])
    def test_validation_matches_reference(self, kw):
        with pytest.raises(ValueError) as got:
            ActivityGate(**kw)
        with pytest.raises(ValueError) as want:
            ActivityGateJ(**kw)
        assert str(got.value) == str(want.value)

    def test_activity_reads_host_frames(self):
        f = np.zeros((4, 4, 2), np.float32)
        f[0, 0, 0], f[1, 2, 1] = 1.0, -1.0
        assert ActivityGate.activity(f) == 2 == ActivityGateJ.activity(f)
        assert ActivityGate.activity(torch.from_numpy(f)) == 2
        assert GATE.active(f) is False and GATE.wakes(f) is False

    def test_defaults_and_gate_state(self):
        assert dataclasses.asdict(ActivityGate()) == dataclasses.asdict(ActivityGateJ())
        gs = GateState()
        assert (gs.awake, gs.processed, gs.retained, gs.last_logits) == (False, 0, None, None)


# ---------------------------------------------------------------------------
# the gated batcher: processed == plan, == lone session, == reference
# ---------------------------------------------------------------------------

class TestGatedBatcher:
    @given(seed=st.integers(0, 9999))
    @settings(max_examples=4, deadline=None)
    def test_gated_pool_matches_plan_replay(self, seed):
        """Bursty traces through a contended 2-slot pool (5 streams,
        staggered arrivals: park/wake/evict/refill churn), both backends."""
        deployed = get_pair()[1]
        n_streams, frames = 5, 12
        clips = {f"s{i}": bursty_clip(seed * 7 + i, frames=frames) for i in range(n_streams)}
        for backend in BACKENDS:
            pool = SessionPool(deployed, 2, backend=backend)
            bat = ContinuousBatcher(pool, gate=GATE)
            for i, (sid, clip) in enumerate(clips.items()):
                bat.submit(StreamRequest(sid, clip, arrival=i % 3))
            results = {r.stream_id: r for r in bat.run()}
            assert len(results) == n_streams
            assert pool.trace_count <= 1
            for sid, clip in clips.items():
                proc = processed_frames(clip)
                r = results[sid]
                assert (r.frames_processed, r.frames_skipped) == (len(proc), frames - len(proc))
                want = replay(deployed, clip, proc, backend)
                if want is None:
                    assert r.logits is None, sid
                else:
                    np.testing.assert_array_equal(r.logits, want, err_msg=sid)

    def test_gated_batcher_equals_reference_batcher(self):
        """The same gated schedule through both packages: per-stream
        logits, processed/skipped splits, admission ticks and the stats'
        gating block are equal."""
        ref, port = get_pair()
        clips = {f"s{i}": bursty_clip(100 + i, frames=10) for i in range(4)}
        bat = ContinuousBatcher(SessionPool(port, 2, backend="fused"), gate=GATE)
        bat_j = BatcherJ(SessionPoolJ(ref, 2, backend="ref"), gate=GATE_J)
        for i, (sid, clip) in enumerate(clips.items()):
            bat.submit(StreamRequest(sid, clip, arrival=i))
            bat_j.submit(RequestJ(sid, jnp.asarray(clip), arrival=i))
        got = {r.stream_id: r for r in bat.run()}
        want = {r.stream_id: r for r in bat_j.run()}
        assert list(got) == list(want)  # same departure order
        for sid, r in got.items():
            w = want[sid]
            assert (r.frames_processed, r.frames_skipped, r.admitted_tick, r.finished_tick) == \
                (w.frames_processed, w.frames_skipped, w.admitted_tick, w.finished_tick)
            if w.logits is None:
                assert r.logits is None
            else:
                np.testing.assert_array_equal(r.logits, np.asarray(w.logits))
        assert bat.stats()["gating"] == bat_j.stats()["gating"]
        assert bat.tick_index == bat_j.tick_index

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_all_active_trace_equals_ungated(self, deployed, backend):
        r = np.random.default_rng(3)
        clips = {}
        for i in range(3):
            clip = np.zeros((6, 4, 4, 2), np.float32)
            for t in range(6):
                clip[t].reshape(-1)[r.choice(32, GATE.wake_threshold + 2, replace=False)] = 1.0
            clips[f"s{i}"] = clip

        def run(gate):
            bat = ContinuousBatcher(SessionPool(deployed, 2, backend=backend), gate=gate)
            for i, (sid, clip) in enumerate(clips.items()):
                bat.submit(StreamRequest(sid, clip, arrival=i))
            return {r.stream_id: r for r in bat.run()}

        gated, ungated = run(GATE), run(None)
        for sid in clips:
            assert (gated[sid].frames_processed, gated[sid].frames_skipped) == (6, 0)
            np.testing.assert_array_equal(gated[sid].logits, ungated[sid].logits)

    def test_zero_activity_stream_never_takes_a_slot(self, deployed):
        quiet = np.zeros((6, 4, 4, 2), np.float32)
        busy = bursty_clip(11, frames=6)
        bat = ContinuousBatcher(SessionPool(deployed, 1, backend="ref"), gate=GATE)
        bat.submit(StreamRequest("quiet", quiet, arrival=0))
        bat.submit(StreamRequest("busy", busy, arrival=0))
        results = {r.stream_id: r for r in bat.run()}
        r = results["quiet"]
        assert r.logits is None and r.pred is None and r.correct is None
        assert (r.frames_processed, r.frames_skipped, r.admitted_tick) == (0, 6, -1)
        np.testing.assert_array_equal(
            results["busy"].logits, replay(deployed, busy, processed_frames(busy), "ref"))

    def test_stream_state_roundtrips_across_park_wake(self, deployed):
        """The parked ring is a `StreamState` on the pool's device: it
        round-trips through a lone session mid-park and the wake resumes
        bit-exactly."""
        clip = np.zeros((8, 4, 4, 2), np.float32)
        for t in (0, 1, 2, 6, 7):  # burst, 3 quiet (parks at t=4), burst
            clip[t].reshape(-1)[: GATE.wake_threshold + 1] = 1.0
        assert processed_frames(clip) == [0, 1, 2, 3, 6, 7]
        bat = ContinuousBatcher(SessionPool(deployed, 1, backend="ref"), gate=GATE)
        bat.submit(StreamRequest("s0", clip, arrival=0))
        while bat._gate_state["s0"].retained is None:
            bat.tick()
        gs = bat._gate_state["s0"]
        assert "s0" in bat._parked and not gs.awake and gs.processed == 4
        parked = gs.retained
        session = deployed.stream(batch=1, backend="ref")
        session.load_state(StreamState(
            ring=TCNStream(buf=parked.ring.buf[None], cursor=parked.ring.cursor),
            steps_seen=parked.steps_seen))
        back = session.export_state()
        tripped = StreamState(ring=TCNStream(buf=back.ring.buf[0], cursor=back.ring.cursor),
                              steps_seen=back.steps_seen)
        assert torch.equal(tripped.ring.buf, parked.ring.buf)
        gs.retained = tripped
        (r,) = bat.run()
        assert r.frames_processed == 6 and bat.stats()["gating"]["wakes"] == 2
        np.testing.assert_array_equal(r.logits, replay(deployed, clip, [0, 1, 2, 3, 6, 7], "ref"))

    def test_cancel_parked_stream(self, deployed):
        bat = ContinuousBatcher(SessionPool(deployed, 1, backend="ref"), gate=GATE)
        bat.submit(StreamRequest("s0", np.zeros((6, 4, 4, 2), np.float32), arrival=0))
        bat.tick()
        assert bat.cancel("s0") == "parked"
        assert not bat.pending and bat.stats()["cancelled"] == 1

    def test_departures_reach_the_host_in_one_copy_per_tick(self, deployed, monkeypatch):
        """Streams finishing parked and in flight in the same tick share
        one device-to-host copy (logits rows stacked)."""
        copies = []
        real = torch.Tensor.cpu

        def counting_cpu(self, *a, **k):
            copies.append(tuple(self.shape))
            return real(self, *a, **k)

        clips = {f"s{i}": bursty_clip(200 + i, frames=9) for i in range(4)}
        bat = ContinuousBatcher(SessionPool(deployed, 4, backend="ref"), gate=GATE)
        for sid, clip in clips.items():
            bat.submit(StreamRequest(sid, clip, arrival=0))
        monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
        while bat.pending:
            before, n_results = len(copies), len(bat.results)
            bat.tick()
            departed = [r for r in bat.results[n_results:] if r.frames_processed]
            assert len(copies) - before == (1 if departed else 0)
        monkeypatch.undo()
        for sid, clip in clips.items():
            r = next(r for r in bat.results if r.stream_id == sid)
            want = replay(deployed, clip, processed_frames(clip), "ref")
            if want is None:
                assert r.logits is None
            else:
                np.testing.assert_array_equal(r.logits, want)

    def test_router_threads_gate_into_buckets(self):
        dep_a, dep_b = _pair("gate_fleet_a", seed=4)[1], _pair("gate_fleet_b", seed=5)[1]
        router = FleetRouter(backend="ref", max_pool_size=2, gate=GATE)
        router.register("a", dep_a)
        router.register("b", dep_b, gate=ActivityGate(wake_threshold=9, park_threshold=2))
        assert router.buckets["a"].batcher.gate is GATE
        assert router.buckets["b"].batcher.gate.wake_threshold == 9
        clips = {}
        for idx, name in enumerate(("a", "b")):
            for s in range(2):
                sid = f"{name}/{s}"
                clips[sid] = bursty_clip(60 + 10 * idx + s, frames=8)
                router.submit(StreamRequest(sid, clips[sid], arrival=idx + s, net=name))
        results = {r.stream_id: r for r in router.run()}
        router.close()
        stats = router.stats()
        assert stats["gating"]["frames_processed"] == sum(
            r.frames_processed for r in results.values())
        for sid, r in results.items():
            gate = router.buckets[sid.split("/")[0]].gate
            assert r.frames_processed == len(processed_frames(clips[sid], gate)), sid
        router2 = FleetRouter(backend="ref", max_pool_size=2)
        router2.register("a", dep_a)
        assert router2.stats()["gating"] is None


# ---------------------------------------------------------------------------
# energy: the CUTIE silicon model's pricing of skipped frames
# ---------------------------------------------------------------------------

class TestEnergy:
    @pytest.mark.parametrize("name", ["dvs_cnn_tcn", "kws_tcn", "dvs_cnn_tcn_smoke"])
    def test_evaluate_frame_equals_reference(self, name):
        from repro.sim.plan import lower as lower_j
        from repro_torch.sim.plan import lower

        got = evaluate_frame(lower(tapi.get_graph(name)), v=0.5)
        want = evaluate_frame_j(lower_j(japi.get_graph(name)), v=0.5)
        assert (got.name, got.cycles, got.energy_j, got.inf_per_s) == \
            (want.name, want.cycles, want.energy_j, want.inf_per_s)

    def test_frame_energy_and_summary_equal_reference(self):
        ref, port = get_pair()
        assert frame_energy_uj(port) == frame_energy_uj_j(ref)
        kw = dict(frames_processed=40, frames_total=100, completed=8)
        assert energy_summary(port, **kw) == energy_summary_j(ref, **kw)

    def test_energy_summary_of_a_loaded_program_equals_reference(self):
        data = get_pair()[1].to_artifact_bytes()
        kw = dict(frames_processed=7, frames_total=12, completed=2)
        got = energy_summary(artifact.loads(data, device="cpu"), **kw)
        assert got == energy_summary_j(jart.loads(data), **kw)
        assert got["energy_uj_saved"] > 0

    def test_energy_summary_without_classifications(self, deployed):
        s = energy_summary(deployed, frames_processed=0, frames_total=10, completed=0)
        assert s["energy_uj_saved"] > 0
        assert np.isnan(s["energy_uj_per_classification"])
