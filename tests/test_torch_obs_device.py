"""The port's own serving spans, its device spans and its request clock.

On the CPU:

  * the exact tick-clock event sequence of a two-slot ungated batcher,
    with the port's ``advance``, ``flush`` (departure ticks only),
    ``pool.upload``, ``pool.replay`` and ``pool.build``;
  * ``NullTracer.complete`` (and a null span's ``set_args``) record
    nothing, ``Tracer.complete`` records the times it is given, and a traced
    run stays logit-byte-identical to an untraced one;
  * `StreamResult.submitted_ns` / ``admitted_ns`` are ordered, follow the
    first-admission rule of ``admitted_tick``, and are left out of equality
    and repr;
  * `repro_torch.obs.device.DeviceSpans` placing, ordering, re-basing and
    resolving timing events (stand-in events with known device times);
  * a pool off the card binds no device recorder; the structural check
    compares a wall-clock trace to the nanosecond.

On the card (``gpu``): a captured pool of 8 over 50 ticks, whose batches
are staged in its pinned ring (``pool.upload`` with ``pinned`` and
``staged``), whose device spans start no earlier than the host spans that
launched them, end before the departures' flush that waits for them, and
hold each replay's kernels as the profiler records them.  This file imports no JAX.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.obs import NULL_TRACER, PORT_EVENTS, Tracer, save_chrome, trace_summary
from repro_torch.obs import device as obs_device
from repro_torch.obs.export import to_chrome, validate_nesting
from repro_torch.serving import ActivityGate, ContinuousBatcher, StreamRequest
from repro_torch.serving.scheduler import StreamResult


def tiny_graph(name="tiny_obs"):
    return tapi.CutieGraph(
        name=name, input_hw=(4, 4), input_ch=2, n_classes=3, tcn_steps=4,
        layers=(tapi.conv2d(2, 4), tapi.global_pool(),
                tapi.tcn(4, 4, dilation=1), tapi.tcn(4, 4, dilation=2),
                tapi.last_step(), tapi.fc(4, 3)),
    )


@pytest.fixture(scope="module")
def deployed():
    prog = tapi.CutieProgram(tiny_graph())
    calib = (torch.rand((2, 6, 4, 4, 2), generator=torch.Generator().manual_seed(1))
             < 0.3).float()
    return prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu"),
                         calib=calib)


def clips(n, frames, seed=7):
    return (np.random.default_rng(seed).random((n, frames, 4, 4, 2)) < 0.3).astype(np.float32)


def _serve(deployed, tracer, n=3, frames=3, pool=2, gate=None):
    batcher = ContinuousBatcher(deployed.serve(pool, backend="fused"), tracer=tracer, gate=gate)
    data = clips(n, frames)
    for i in range(n):
        batcher.submit(StreamRequest(f"s{i}", data[i], arrival=i))
    return batcher, batcher.run()


# ---------------------------------------------------------------------------
# the tick's spans, pinned
# ---------------------------------------------------------------------------

def _tick(t0, k, streams, queued, departures, first=False):
    """One stepping tick of the tiny pool of 2 under the tick clock."""
    upload = ("X", "pool.upload", t0 + 9, 1, {"bytes": 258, "pinned": False, "staged": True})
    if first:  # the build: eager on the CPU, no capture time
        body = [upload, ("i", "pool.build", t0 + 12, 0, {"capture_s": None}),
                ("X", "pool.replay", t0 + 11, 2, {"k1": 0})]
        step_len = 8
    else:
        body = [upload, ("X", "pool.replay", t0 + 11, 1, {"k1": 0})]
        step_len = 7
    ev = [("X", "admit", t0 + 1, 1, None),
          ("C", "occupancy", t0 + 3, 0, {"occupancy": streams / 2}),
          ("C", "queue_depth", t0 + 4, 0, {"queue_depth": queued}),
          ("X", "assemble", t0 + 5, 1, None),
          *body,
          ("X", "pool.step", t0 + 8, step_len - 2, {"pool_size": 2}),
          ("X", "step", t0 + 7, step_len, {"streams": streams}),
          ("X", "advance", t0 + step_len + 8, 1, {"departures": departures})]
    end = t0 + step_len + 10
    if departures:
        ev.append(("X", "flush", end, 1, {"rows": departures}))
        end += 2
    ev.append(("X", "tick", t0, end - t0, {"tick": k}))
    return ev, end + 1


def test_tick_clock_events_of_a_two_slot_batcher_are_pinned(deployed):
    tracer = Tracer(clock="tick")
    _serve(deployed, tracer)
    got = [(e.phase, e.name, e.ts, e.dur, e.args) for e in tracer.events()]
    assert all(e.track == "tiny_obs" for e in tracer.events())
    want, t = [], 0
    # three clips of 3 frames arriving at ticks 0, 1, 2 on two slots: the
    # third waits for the first's departure (tick 2) and runs ticks 3-5
    ticks = [(1, 2, 0), (2, 1, 0), (2, 1, 1), (2, 0, 1), (1, 0, 0), (1, 0, 1)]
    for k, (streams, queued, departures) in enumerate(ticks):
        ev, t = _tick(t, k, streams, queued, departures, first=k == 0)
        want += ev
    assert got == want
    assert {e.name for e in tracer.events()} & set(PORT_EVENTS) == {
        "advance", "flush", "pool.upload", "pool.replay", "pool.build"}
    assert validate_nesting(to_chrome(tracer)) == []


# ---------------------------------------------------------------------------
# the tracer's new calls
# ---------------------------------------------------------------------------

def test_null_tracer_complete_and_set_args_record_nothing():
    assert NULL_TRACER.complete("dev.replay", 10, 5, track="x.device", k1=9) is None
    with NULL_TRACER.span("advance") as span:
        span.set_args(departures=3)
    assert NULL_TRACER.events() == []


def test_tracer_complete_records_the_given_times_and_span_args_set_inside():
    tr = Tracer(clock="tick")
    with tr.span("advance", track="a", keep=1) as span:
        span.set_args(departures=2)
    tr.complete("dev.replay", 1000, 250, track="a.device", k1=9)
    tr.complete("dev.upload", 900, 100, track="a.device")
    adv, rep, up = tr.events()
    assert (adv.name, adv.args) == ("advance", {"keep": 1, "departures": 2})
    assert tuple(rep) == ("X", "dev.replay", 1000, 250, 0, "a.device", {"k1": 9})
    assert tuple(up) == ("X", "dev.upload", 900, 100, 0, "a.device", None)
    assert Tracer().now() >= 0


@pytest.mark.parametrize("clock", ["wall", "tick"])
def test_a_traced_run_is_logit_byte_identical_to_an_untraced_one(deployed, clock):
    _, plain = _serve(deployed, None, n=5, frames=4)
    tracer = Tracer(clock=clock)
    batcher, traced = _serve(deployed, tracer, n=5, frames=4)
    assert [r.stream_id for r in plain] == [r.stream_id for r in traced]
    for a, b in zip(plain, traced):
        assert a.logits.tobytes() == b.logits.tobytes()
    names = [e.name for e in tracer.events()]
    assert names.count("pool.upload") == names.count("pool.replay") == names.count("step")
    assert names.count("advance") == names.count("step")
    assert names.count("flush") == sum(1 for e in tracer.events()
                                       if e.name == "advance" and e.args["departures"])
    assert names.count("pool.build") == 1 and "dev.replay" not in names  # no card here
    assert batcher.pool._device_spans is obs_device.NULL_DEVICE_SPANS


# ---------------------------------------------------------------------------
# the request clock
# ---------------------------------------------------------------------------

def test_stream_result_stamps_are_ordered_and_left_out_of_equality(deployed):
    _, results = _serve(deployed, None, n=4, frames=3)
    for r in results:
        assert 0 < r.submitted_ns <= r.admitted_ns
    # the third and fourth clips wait for slots: admitted later than submitted
    late = [r for r in results if r.admitted_tick > int(r.stream_id[1:])]
    assert late and all(r.admitted_ns > r.submitted_ns for r in late)
    r = results[0]
    twin = StreamResult(r.stream_id, r.logits, r.n_frames, r.admitted_tick, r.finished_tick,
                        submitted_ns=1, admitted_ns=2)
    assert twin == r and repr(twin) == repr(r) and "_ns" not in repr(r)


def test_stream_result_stamps_follow_the_first_admission_under_a_gate(deployed):
    gate = ActivityGate(wake_threshold=8, park_threshold=3, park_after=2)
    data = np.zeros((3, 8, 4, 4, 2), np.float32)
    for t in range(8):  # s0 wakes, parks, wakes again; s1 never wakes; s2 always on
        if t in (0, 1, 5, 6):
            data[0, t].reshape(-1)[:10] = 1.0
        data[2, t].reshape(-1)[:10] = 1.0
    batcher = ContinuousBatcher(deployed.serve(2, backend="fused"), gate=gate)
    for i in range(3):
        batcher.submit(StreamRequest(f"s{i}", data[i]))
    results = {r.stream_id: r for r in batcher.run()}
    s0, s1, s2 = results["s0"], results["s1"], results["s2"]
    assert s0.frames_skipped > 0 and s0.admitted_tick == 0  # parked and woke again
    assert 0 < s0.submitted_ns <= s0.admitted_ns
    assert (s1.admitted_tick, s1.admitted_ns) == (-1, 0) and s1.submitted_ns > 0
    assert 0 < s2.submitted_ns <= s2.admitted_ns
    assert not batcher._submitted_ns and not batcher._admitted_ns  # nothing kept after
    b2 = ContinuousBatcher(deployed.serve(2, backend="fused"))
    b2.submit(StreamRequest("q", clips(1, 3)[0]))
    b2.cancel("q")
    assert not b2._submitted_ns


# ---------------------------------------------------------------------------
# device spans: placing, ordering, re-basing (stand-in events)
# ---------------------------------------------------------------------------

class StandInEvent:
    """A CUDA timing event with a known device time (ms)."""

    def __init__(self, t_ms, done=True):
        self.t, self.done = t_ms, done

    def elapsed_time(self, other):
        return float(np.float32(other.t - self.t))  # float32 ms, as CUDA gives

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def record(self, stream):
        stream.append(self)


class StandInTracer(Tracer):
    """A wall-clock tracer whose host time the test sets (``t``, ns)."""

    t = 0

    def now(self):
        return self.t


def _dev(tracer):
    """The device spans a stand-in tracer holds (not its ``obs.resolve``)."""
    return [e for e in tracer.events() if e.name.startswith("dev.")]


def _spans(anchor_ms=0.0, anchor_ns=5_000):
    tracer = StandInTracer()
    clock = obs_device.DeviceClock(StandInEvent(anchor_ms), anchor_ns)
    obs_device._CLOCKS.setdefault(tracer, {})[torch.device("cuda", 0)] = clock
    spans = obs_device.DeviceSpans(tracer, ["cuda:0"], ["net.device"],
                                   ("dev.upload", "dev.replay"))
    return tracer, spans, clock


def _step(spans, times, recorded, done=True, k1=9):
    spans._pending.append(([[StandInEvent(t, done) for t in times]], recorded,
                           [{"dev.replay": {"k1": k1}}]))


def test_device_spans_are_placed_on_the_tracer_clock_in_order():
    tracer, spans, _ = _spans()
    tracer.t = 10_000_000  # the host asks long after both steps
    _step(spans, (1.0, 1.25, 1.75), recorded=900_000)
    _step(spans, (2.0, 2.1, 2.5), recorded=1_900_000, done=False)
    assert spans.resolve() == 1 and spans.pending == 1  # query() only: the second waits
    up, rep = _dev(tracer)
    cost = tracer.events()[-1]  # the recorder's own host time
    assert (cost.name, cost.args, cost.track) == ("obs.resolve", {"steps": 1}, None)
    assert (up.name, up.ts, up.dur, up.track, up.args) == (
        "dev.upload", 5_000 + 1_000_000, 250_000, "net.device", None)
    assert (rep.name, rep.ts, rep.dur, rep.args) == (
        "dev.replay", up.ts + up.dur, 500_000, {"k1": 9})
    assert spans.resolve(wait=True) == 1 and spans.pending == 0
    assert len(spans._free) == 2  # the events are reused
    # a start that rounding puts before the lane's last end moves up to it
    _step(spans, (2.4999, 2.6, 2.7), recorded=2_000_000)
    spans.resolve()
    third = _dev(tracer)[-2]
    assert third.ts == _dev(tracer)[-3].ts + _dev(tracer)[-3].dur
    assert third.dur == 100_100  # the duration is always the events' own


def test_a_step_is_timed_only_a_gap_after_the_last_timed_one():
    tracer, spans, _ = _spans()
    recorded = []  # the stand-in stream: what was recorded on it
    spans._entry = lambda: [[StandInEvent(0.0) for _ in range(3)]]
    spans._current_streams = lambda: [recorded]
    spans.min_gap_ns = 1_000_000
    opened = []
    for k in range(7):  # a step every 0.4 ms of host time; timed: 0, 1.2, 2.4 ms
        tracer.t = k * 400_000
        for i in range(3):
            spans.mark(i)
        opened.append(spans._open is not None)
        spans.close([{}])
    assert opened == [True, False, False, True, False, False, True]
    assert spans.pending == 3 and len(recorded) == 9
    assert [r for _, r, _ in spans._pending] == [0, 1_200_000, 2_400_000]


def test_the_clock_is_held_between_the_host_s_record_and_its_query():
    tracer, spans, clock = _spans()
    tracer.t = 10_000_000
    # the card's clock fell behind: placed 50 us before the host recorded it
    _step(spans, (1.0, 1.1, 1.2), recorded=1_055_000)
    spans.resolve()
    up = _dev(tracer)[0]
    assert up.ts == 1_055_000 and clock.ns == 5_000 + 50_000
    # the card's clock ran ahead: the step would end after the host saw it done
    tracer.t = 2_000_000
    _step(spans, (1.95, 1.99, 2.0), recorded=1_900_000)
    spans.resolve()
    rep = _dev(tracer)[-1]
    assert rep.ts + rep.dur == 2_000_000 and clock.ns == 55_000 - 55_000
    # inside both bounds nothing moves
    tracer.t = 4_000_000
    _step(spans, (3.0, 3.1, 3.2), recorded=2_500_000)
    spans.resolve()
    assert clock.ns == 0 and _dev(tracer)[-2].ts == 3_000_000


def test_the_clock_keeps_the_least_lag_of_each_window():
    tracer, spans, clock = _spans(anchor_ns=0)
    W = obs_device.WINDOW_NS
    tracer.t = 10 * W
    # first window: the least lag (an idle stream) is 4 us; the reference
    for rec_ms, lag_us in ((100.0, 30), (400.0, 4), (700.0, 12)):
        _step(spans, (rec_ms + lag_us / 1e3, rec_ms + 0.1, rec_ms + 0.2),
              recorded=round(rec_ms * 1e6))
    _step(spans, (1000.5, 1000.6, 1000.7), recorded=1000_400_000)  # closes the window
    spans.resolve()
    # float32 ms from the anchor place each step to within tens of nanoseconds
    assert abs(clock._lag_ref - 4_000) <= 50
    assert abs(_dev(tracer)[-2].ts - 1000_500_000) <= 50  # not moved
    # the card's clock runs 10 us a second fast: in the next window the least
    # lag reads 14 us, and the clock moves back by the 10 us at its end
    for rec_ms, lag_us in ((1500.0, 40), (1800.0, 14)):
        _step(spans, (rec_ms + lag_us / 1e3, rec_ms + 0.1, rec_ms + 0.2),
              recorded=round(rec_ms * 1e6))
    _step(spans, (2000.45, 2000.6, 2000.7), recorded=2000_400_000)
    spans.resolve()
    assert abs(_dev(tracer)[-2].ts - 2000_450_000) <= 50  # the window's steps stay put
    _step(spans, (2500.016, 2500.1, 2500.2), recorded=2500_000_000)
    spans.resolve()
    # 16 us after its record on the card, 6 after the clock's move
    assert abs(_dev(tracer)[-2].ts - 2500_006_000) <= 100


def test_device_clock_rebases_without_losing_time():
    tracer, spans, clock = _spans()
    far = 60_000.0  # a minute past the anchor: float32 ms has a 4 us step there
    tracer.t = 70_000_000_000
    _step(spans, (far + 0.001, far + 0.002, far + 0.003), recorded=0)
    spans.resolve()
    assert clock.event.t == far + 0.003  # re-based on the step's last event
    assert abs(clock.ns - (5_000 + round((far + 0.003) * 1e6))) <= 4_000
    _step(spans, (far + 0.004, far + 0.0045, far + 0.0051), recorded=0)
    spans.resolve()
    up = _dev(tracer)[-2]
    # placed from the new anchor: to the nanosecond of float32 at 1 us
    assert abs(up.ts - (clock.ns + 1_000)) <= 1
    assert up.dur == 500


def test_resolve_pending_waits_for_every_recorder_of_a_tracer():
    tracer, spans, _ = _spans()
    tracer.t = 10_000_000
    _step(spans, (1.0, 1.1, 1.2), recorded=0, done=False)
    assert obs_device.resolve_pending(tracer) == 1 and spans.pending == 0
    assert obs_device.resolve_pending(Tracer()) == 0


def test_device_spans_bind_only_to_an_enabled_wall_clock_tracer_on_a_card(deployed):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert obs_device.records_device_time(Tracer(), cuda)
    assert not obs_device.records_device_time(Tracer(clock="tick"), cuda)
    assert not obs_device.records_device_time(NULL_TRACER, cuda)
    assert not obs_device.records_device_time(Tracer(), cpu)
    pool = deployed.serve(2, backend="fused", tracer=Tracer())
    assert pool._device_spans is obs_device.NULL_DEVICE_SPANS


def test_adjacent_device_spans_nest_to_the_nanosecond():
    tracer = Tracer()
    # 600519501 ns + 335662 ns: the float sum of the microseconds rounds past
    tracer.complete("dev.upload", 600_519_501, 335_662, track="a.device")
    tracer.complete("dev.replay", 600_855_163, 263_360, track="a.device")
    doc = to_chrome(tracer)
    up = next(e for e in doc["traceEvents"] if e.get("name") == "dev.upload")
    assert up["ts"] + up["dur"] > 600_855.163  # what the check must see through
    assert validate_nesting(doc) == []
    tracer.complete("dev.late", 600_855_162, 10_000, track="a.device")  # a real overlap
    assert len(validate_nesting(to_chrome(tracer))) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

TOL_NS = 5_000


def _cuda_pool8_clips():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans come from CUDA events")
    prog = tapi.get_net("dvs_cnn_tcn")
    g = prog.graph
    rng = np.random.default_rng(3)
    frames = (rng.random((16, 60, *g.input_hw, g.input_ch)) < 0.2).astype(np.float32)
    dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cuda"),
                        calib=torch.from_numpy(frames[:4, :g.tcn_steps]).cuda())
    return dep, frames


def _host_spans(events, name):
    return sorted((e.ts, e.ts + e.dur) for e in events if e.name == name and e.phase == "X")


def _profiled_replays(prof):
    """Each replay of a profiled pool as the profiler records it, in order:
    its first kernel's start, its last kernel's end and their device time
    (us).  A replay's kernels are those after a tick's host-to-device copies
    and before the next copy of any kind; kernels elsewhere (an admitted
    slot's ring cleared, after a departure's device-to-host copy) are no
    replay's."""
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    replays, current = [], None
    for s, e, name in ops:
        if name.startswith("Memcpy"):
            if current:
                replays.append(current)
            current = [] if name.startswith("Memcpy HtoD") else None
        elif current is not None:
            current.append((s, e))
    if current:
        replays.append(current)
    return [(r[0][0], r[-1][1], sum(e - s for s, e in r)) for r in replays]


@pytest.mark.gpu
def test_device_spans_of_a_captured_pool_on_the_card(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    dep, frames = _cuda_pool8_clips()
    tracer = Tracer(capacity=1 << 16)
    batcher = ContinuousBatcher(dep.serve(8, backend="fused"), tracer=tracer)
    batcher.pool._device_spans.min_gap_ns = 0  # time every step
    for i in range(16):  # 60 down to 15 frames: departures from tick 39 on
        batcher.submit(StreamRequest(f"s{i}", frames[i, :60 - 3 * i]))
    for _ in range(5):  # the build, then steady replays
        batcher.tick()
    obs_device.resolve_pending(tracer)
    tracer.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            batcher.tick()
        torch.cuda.synchronize()
    obs_device.resolve_pending(tracer)
    ev = tracer.events()
    dev_up, dev_rep = _host_spans(ev, "dev.upload"), _host_spans(ev, "dev.replay")
    host_up, host_rep = _host_spans(ev, "pool.upload"), _host_spans(ev, "pool.replay")
    flushes = _host_spans(ev, "flush")
    assert len(dev_up) == len(dev_rep) == len(host_up) == len(host_rep) == 50
    assert batcher.pool.captured and tracer.dropped == 0
    # every batch came from the pool's pinned staging ring, copied without blocking
    assert all(e.args["pinned"] and e.args["staged"] for e in ev if e.name == "pool.upload")
    for (ds, _), (hs, _) in zip(dev_up, host_up):
        assert ds >= hs - TOL_NS
    for (ds, _), (hs, _) in zip(dev_rep, host_rep):
        assert ds >= hs - TOL_NS
    assert {e.args["k1"] for e in ev if e.name == "dev.replay"} == {9}
    # a departure tick's flush waits for its replay: the replay ends first
    assert len(flushes) >= 5
    for fs, fe in flushes:
        rep = max((r for r in dev_rep if r[0] <= fs), key=lambda r: r[0])
        assert rep[1] <= fe + TOL_NS
    # against the profiler's record of the same 50 ticks: each replay span
    # holds its replay's kernels, from the first one's start to the last
    # one's end, and the card's wait for the graph's launch before them
    replays = _profiled_replays(prof)
    assert len(replays) == 50
    for i, ((s, e), (k0, k1, busy)) in enumerate(zip(dev_rep, replays)):
        assert (e - s) / 1e3 >= (k1 - k0) - TOL_NS / 1e3 >= busy - TOL_NS / 1e3, (
            i, (e - s) / 1e3, k1 - k0, busy)
    # the trace passes the structural check, device lane included
    path = tmp_path / "trace.json"
    save_chrome(str(path), tracer)
    summary = trace_summary(json.loads(path.read_text()))
    assert summary["ok"] and "dvs_cnn_tcn.device" in summary["lanes"], summary["nesting_problems"]
