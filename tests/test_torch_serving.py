"""`repro_torch.serving`, `.data` and `.launch.serve` held against the
reference on the CPU — the scenarios of tests/test_serving.py.

The serving contract: slot p of a P-wide pool is bit-exact vs an independent
batch-1 `StreamSession` fed the same frames, on the fused AND ref backends,
through admissions, evictions, refills, partial ticks, resets and
migration; and the port's pool reproduces the reference's pool logits on
the same numpy frame schedule (tables carried across by
`repro_torch.convert`).  All comparisons are equality: ring algebra moves
data, and the nets' sums are exact in float32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import api as japi
from repro.api.program import CutieProgram as CutieProgramJ
from repro.data.pipeline import DVSEventPipeline as PipelineJ
from repro.serving import masking as jmask
from repro.serving import SessionPool as SessionPoolJ
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core.tcn import StreamState, TCNStream
from repro_torch.data.pipeline import DVSEventPipeline, PipelineState
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (
    ContinuousBatcher,
    PoolFullError,
    PoolState,
    SessionPool,
    StreamRequest,
    clear_slot,
    gather_slot,
    masked_push,
    ordered_windows,
    scatter_slot,
)

BACKENDS = ("ref", "fused")


def _tree_np(x):
    if isinstance(x, dict):
        return {k: _tree_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree_np(v) for v in x]
    return np.array(x) if hasattr(x, "shape") else x


def _tiny_layers(api):
    return (api.conv2d(2, 4), api.global_pool(),
            api.tcn(4, 4, dilation=1), api.tcn(4, 4, dilation=2),
            api.last_step(), api.fc(4, 3))


def tiny_graph(api, tcn_steps: int = 4):
    return api.CutieGraph(
        name="tiny_serving", input_hw=(4, 4), input_ch=2, n_classes=3,
        tcn_steps=tcn_steps, layers=_tiny_layers(api),
    )


def clips_for(graph, n_streams: int, frames: int, seed: int = 0) -> np.ndarray:
    shape = (n_streams, frames, *graph.input_hw, graph.input_ch)
    return (np.random.RandomState(seed).rand(*shape) < 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The reference's deployed tiny net and the port's, over the same
    tables."""
    prog = CutieProgramJ(tiny_graph(japi))
    frames = clips_for(prog.graph, 2, 6, seed=1)
    ref = prog.quantize(prog.init(jax.random.PRNGKey(0)), calib=jnp.asarray(frames))
    port = convert.deployed_from_reference_tables(
        tiny_graph(tapi), _tree_np(ref.tables), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def deployed(pair):
    return pair[1]


def exact(a, b):
    to_np = lambda v: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.testing.assert_array_equal(to_np(a), to_np(b))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# masking: the pure state algebra, against the reference on the same state
# ---------------------------------------------------------------------------

class TestMasking:
    def test_masked_push_and_ordered_windows_equal_reference(self):
        """Random pushes with random active masks over a cursor wrap: buf,
        cursor, steps and the ordered view match the reference each step."""
        rng = np.random.RandomState(0)
        st_t = PoolState.create(3, 4, 5, device="cpu")
        st_j = jmask.PoolState.create(3, 4, 5)
        for _ in range(11):
            feats = rng.randint(-4, 5, (3, 5)).astype(np.float32) / 4
            active = rng.rand(3) < 0.6
            st_t = masked_push(st_t, _t(feats), _t(active))
            st_j = jmask.masked_push(st_j, jnp.asarray(feats), jnp.asarray(active))
            exact(st_t.buf, st_j.buf)
            exact(st_t.cursor, st_j.cursor)
            exact(st_t.steps, st_j.steps)
            exact(ordered_windows(st_t), jmask.ordered_windows(st_j))

    def test_masked_push_freezes_inactive_slots(self):
        state = PoolState.create(3, 4, 2, device="cpu")
        feats = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        new = masked_push(state, feats, torch.tensor([True, False, True]))
        assert bool((new.buf[0, 0] == feats[0]).all())
        assert not bool(new.buf[1].any())
        assert new.cursor.tolist() == [1, 0, 1] and new.steps.tolist() == [1, 0, 1]
        assert float(state.buf.abs().sum()) == 0.0  # functional: old state intact

    def test_ordered_windows_matches_per_stream_ring(self):
        state = PoolState.create(2, 3, 2, device="cpu")
        rings = [TCNStream.create(3, 2, device="cpu") for _ in range(2)]
        for slot, n in enumerate([3, 5]):  # different ages -> different cursors
            for t in range(n):
                v = torch.full((2,), float(10 * slot + t))
                rings[slot] = rings[slot].push(v)
                state = masked_push(state, torch.stack([v, v]), torch.arange(2) == slot)
        windows = ordered_windows(state)
        for slot in range(2):
            exact(windows[slot], rings[slot].ordered())

    def test_slot_surgery_equal_reference(self):
        rng = np.random.RandomState(1)
        st_t = PoolState.create(3, 4, 2, device="cpu")
        st_j = jmask.PoolState.create(3, 4, 2)
        for _ in range(5):
            feats = rng.randn(3, 2).astype(np.float32)
            active = np.array([True, True, False])
            st_t = masked_push(st_t, _t(feats), _t(active))
            st_j = jmask.masked_push(st_j, jnp.asarray(feats), jnp.asarray(active))
        g_t, g_j = gather_slot(st_t, 1), jmask.gather_slot(st_j, 1)
        assert int(g_t.steps_seen) == int(g_j.steps_seen) == 5
        exact(g_t.ring.buf, g_j.ring.buf)
        assert int(g_t.ring.cursor) == int(g_j.ring.cursor)
        s_t = scatter_slot(PoolState.create(3, 4, 2, device="cpu"), 2, g_t)
        s_j = jmask.scatter_slot(jmask.PoolState.create(3, 4, 2), 2, g_j)
        exact(s_t.buf, s_j.buf); exact(s_t.cursor, s_j.cursor); exact(s_t.steps, s_j.steps)
        c_t, c_j = clear_slot(st_t, 0), jmask.clear_slot(st_j, 0)
        exact(c_t.buf, c_j.buf); exact(c_t.cursor, c_j.cursor); exact(c_t.steps, c_j.steps)
        assert not bool(c_t.buf[0].any()) and bool(c_t.buf[1].any())

    def test_gathered_state_does_not_alias_the_pool(self):
        state = masked_push(PoolState.create(2, 4, 2, device="cpu"), torch.ones(2, 2),
                            torch.tensor([True, True]))
        got = gather_slot(state, 0)
        state.buf.zero_()
        assert float(got.ring.buf.sum()) == 2.0

    def test_scatter_rejects_batched_and_misshaped_states(self):
        state = PoolState.create(2, 4, 2, device="cpu")
        with pytest.raises(ValueError, match="batch-free"):
            scatter_slot(state, 0, StreamState.create(4, 2, batch=3, device="cpu"))
        with pytest.raises(ValueError, match="does not fit"):
            scatter_slot(state, 0, StreamState.create(5, 2, device="cpu"))


# ---------------------------------------------------------------------------
# the pool: bit-exactness + continuous batching
# ---------------------------------------------------------------------------

class TestSessionPool:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_bit_exact_vs_independent_sessions_with_churn(self, deployed, backend):
        """Admissions, a mid-flight evict+refill, and a partial tick — every
        pooled logit equals its lone session."""
        frames = clips_for(deployed.graph, 4, 6, seed=2)
        pool = SessionPool(deployed, 3, backend=backend)
        sessions = [deployed.stream(batch=1, backend=backend) for _ in range(4)]

        def check(out, i, t):
            exact(out, sessions[i].step(_t(frames[i:i + 1, t]))[0])

        pool.admit("s0"); pool.admit("s1"); pool.admit("s2")
        for t in range(3):
            out = pool.step({"s0": frames[0, t], "s1": frames[1, t], "s2": frames[2, t]})
            check(out["s0"], 0, t); check(out["s1"], 1, t); check(out["s2"], 2, t)
        pool.evict("s1")                     # departs mid-flight
        pool.admit("s3")                     # slot refilled
        for t in range(3, 6):
            out = pool.step({"s0": frames[0, t], "s3": frames[3, t - 3],
                             "s2": frames[2, t]})
            check(out["s0"], 0, t); check(out["s3"], 3, t - 3); check(out["s2"], 2, t)
        out = pool.step({"s3": frames[3, 3]})  # partial tick: others frozen
        check(out["s3"], 3, 3)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_pool_logits_equal_reference_pool_on_same_schedule(self, pair, backend):
        """The same numpy frame schedule (with churn and a partial tick)
        through the reference's pool and the port's: equal logits per tick."""
        ref, port = pair
        frames = clips_for(port.graph, 3, 7, seed=11)
        pool_j = SessionPoolJ(ref, 2, backend=backend)
        pool_t = SessionPool(port, 2, backend=backend)
        schedule = [
            ("admit", "a"), ("admit", "b"),
            ("step", {"a": 0, "b": 0}), ("step", {"a": 1, "b": 1}), ("step", {"a": 2}),
            ("evict", "b"), ("admit", "c"),
            ("step", {"a": 3, "c": 0}), ("step", {"a": 4, "c": 1}),
            ("step", {"a": 5, "c": 2}), ("step", {"a": 6, "c": 3}), ("step", {"c": 4}),
        ]
        clip = {"a": 0, "b": 1, "c": 2}
        for op, arg in schedule:
            if op == "admit":
                assert pool_t.admit(arg) == pool_j.admit(arg)
            elif op == "evict":
                s_t, s_j = pool_t.evict(arg), pool_j.evict(arg)
                exact(s_t.ring.buf, s_j.ring.buf)
                assert int(s_t.steps_seen) == int(s_j.steps_seen)
            else:
                batch = {sid: frames[clip[sid], t] for sid, t in arg.items()}
                out_t, out_j = pool_t.step(batch), pool_j.step(batch)
                assert set(out_t) == set(out_j)
                for sid in out_t:
                    exact(out_t[sid], out_j[sid])
        exact(pool_t.state.buf, pool_j.state.buf)
        exact(pool_t.state.cursor, pool_j.state.cursor)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_registry_smoke_net_exact(self, backend):
        """Same contract on the real (shrunken) DVS registry net, the port
        on its own weights."""
        prog = tapi.get_net("dvs_cnn_tcn_smoke")
        frames = (np.random.RandomState(3).rand(2, 3, 32, 32, 2) < 0.05).astype(np.float32)
        dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu"),
                            calib=_t(frames))
        pool = dep.serve(2, backend=backend)
        pool.admit("a"); pool.admit("b")
        s = [dep.stream(batch=1, backend=backend) for _ in range(2)]
        for t in range(3):
            out = pool.step({"a": frames[0, t], "b": _t(frames[1, t])})
            exact(out["a"], s[0].step(_t(frames[0:1, t]))[0])
            exact(out["b"], s[1].step(_t(frames[1:2, t]))[0])

    def test_evicted_then_refilled_slot_matches_fresh_session(self, deployed):
        frames = clips_for(deployed.graph, 2, 5, seed=4)
        pool = SessionPool(deployed, 1, backend="ref")
        pool.admit("old")
        for t in range(5):
            pool.step({"old": frames[0, t]})
        pool.evict("old")
        pool.admit("new")                    # same physical slot
        fresh = deployed.stream(batch=1, backend="ref")
        assert pool.steps_seen("new") == 0 and not pool.window_warm("new")
        for t in range(5):
            out = pool.step({"new": frames[1, t]})
            exact(out["new"], fresh.step(_t(frames[1:2, t]))[0])

    def test_state_migrates_pool_to_session_and_back(self, deployed):
        """evict -> StreamSession.load_state -> export -> admit(state=...)
        round-trips with bit-identical logits vs an uninterrupted session."""
        frames = clips_for(deployed.graph, 1, 8, seed=5)[0]
        oracle = deployed.stream(batch=None, backend="ref")
        pool_a = SessionPool(deployed, 2, backend="ref")
        pool_a.admit("m")
        outs = [pool_a.step({"m": frames[t]})["m"] for t in range(3)]
        state = pool_a.evict("m")
        session = deployed.stream(batch=None, backend="ref")
        session.load_state(state)
        assert session.steps_seen == 3
        outs += [session.step(_t(frames[t][None]))[0] for t in range(3, 5)]
        pool_b = SessionPool(deployed, 3, backend="ref")
        pool_b.admit("m", state=session.export_state())
        assert pool_b.steps_seen("m") == 5
        outs += [pool_b.step({"m": frames[t]})["m"] for t in range(5, 8)]
        for t in range(8):
            exact(outs[t], oracle.step(_t(frames[t][None]))[0])

    def test_per_slot_reset(self, deployed):
        frames = clips_for(deployed.graph, 2, 6, seed=6)
        pool = SessionPool(deployed, 2, backend="ref")
        s0 = deployed.stream(batch=1, backend="ref")
        pool.admit("a"); pool.admit("b")
        for t in range(3):
            pool.step({"a": frames[0, t], "b": frames[1, t]})
            s0.step(_t(frames[0:1, t]))
        pool.reset("b")
        s1b = deployed.stream(batch=1, backend="ref")  # fresh oracle for b
        assert pool.steps_seen("b") == 0
        for t in range(3, 6):
            out = pool.step({"a": frames[0, t], "b": frames[1, t]})
            exact(out["a"], s0.step(_t(frames[0:1, t]))[0])
            exact(out["b"], s1b.step(_t(frames[1:2, t]))[0])

    def test_admission_bookkeeping_and_errors(self, deployed):
        pool = SessionPool(deployed, 2, backend="ref")
        pool.admit("x")
        with pytest.raises(ValueError, match="already admitted"):
            pool.admit("x")
        pool.admit("y")
        assert pool.occupancy == 1.0 and pool.free_slots == 0 and len(pool) == 2
        with pytest.raises(PoolFullError):
            pool.admit("z")
        with pytest.raises(KeyError):
            pool.evict("ghost")
        with pytest.raises(KeyError):
            pool.step({"ghost": np.zeros((4, 4, 2), np.float32)})
        with pytest.raises(ValueError, match="frame shape"):
            pool.step({"x": np.zeros((5, 5, 2), np.float32)})
        pool.evict("x")
        assert pool.occupancy == 0.5 and "x" not in pool and "y" in pool
        assert pool.active_streams == ("y",) and pool.slot_of("y") == 1
        assert "SessionPool(size=2" in repr(pool)
        with pytest.raises(ValueError, match="pool_size"):
            SessionPool(deployed, 0)
        with pytest.raises(ValueError, match="not available in repro_torch"):
            SessionPool(deployed, 2, backend="interpret")

    def test_window_warm_per_slot(self, deployed):
        T = deployed.graph.tcn_steps
        frames = clips_for(deployed.graph, 2, T + 1, seed=7)
        pool = SessionPool(deployed, 2, backend="ref")
        pool.admit("a")
        for t in range(T):
            pool.step({"a": frames[0, t]})
        pool.admit("b")                       # admitted late: cold window
        pool.step({"a": frames[0, T], "b": frames[1, 0]})
        assert pool.window_warm("a") and not pool.window_warm("b")
        assert pool.steps_seen("a") == T + 1 and pool.steps_seen("b") == 1


# ---------------------------------------------------------------------------
# the scheduler: arrivals / departures / refill policy
# ---------------------------------------------------------------------------

class TestContinuousBatcher:
    def test_staggered_arrivals_all_served_and_exact(self, deployed):
        """6 streams x 4 frames through 2 slots, arrivals at tick i: every
        stream completes and its final logits equal a lone session replay."""
        frames = clips_for(deployed.graph, 6, 4, seed=8)
        pool = SessionPool(deployed, 2, backend="fused")
        batcher = ContinuousBatcher(pool)
        for i in range(6):
            batcher.submit(StreamRequest(f"s{i}", frames[i], label=i % 3, arrival=i))
        results = batcher.run()
        assert len(results) == 6
        stats = batcher.stats()
        assert stats["completed"] == 6 and stats["frames_processed"] == 24
        assert 0.0 < stats["mean_occupancy"] <= 1.0
        assert stats["per_net"] == {"tiny_serving": {"completed": 6, "inflight": 0,
                                                     "queued": 0}}
        assert stats["latency_ms_p50"] > 0.0
        for r in results:
            session = deployed.stream(batch=1, backend="fused")
            idx = int(r.stream_id[1:])
            for t in range(4):
                want = session.step(_t(frames[idx:idx + 1, t]))
            assert isinstance(r.logits, np.ndarray)
            exact(r.logits, want[0])
            assert r.n_frames == 4 and r.finished_tick >= r.admitted_tick

    def test_results_equal_reference_batcher(self, pair):
        """Same requests through the reference's batcher and the port's:
        same lifecycle ticks, equal final logits."""
        from repro.serving import ContinuousBatcher as BatcherJ
        from repro.serving import StreamRequest as RequestJ

        ref, port = pair
        frames = clips_for(port.graph, 5, 3, seed=12)
        b_j = BatcherJ(SessionPoolJ(ref, 2, backend="fused"))
        b_t = ContinuousBatcher(SessionPool(port, 2, backend="fused"))
        for i in range(5):
            b_j.submit(RequestJ(f"s{i}", jnp.asarray(frames[i]), arrival=2 * i % 3))
            b_t.submit(StreamRequest(f"s{i}", frames[i], arrival=2 * i % 3))
        r_j = {r.stream_id: r for r in b_j.run()}
        r_t = {r.stream_id: r for r in b_t.run()}
        assert set(r_j) == set(r_t)
        for sid, r in r_t.items():
            exact(r.logits, r_j[sid].logits)
            assert (r.admitted_tick, r.finished_tick) == (
                r_j[sid].admitted_tick, r_j[sid].finished_tick)
        assert b_t.occupancy_trace == b_j.occupancy_trace

    def test_future_head_does_not_block_admissible_streams(self, deployed):
        frames = clips_for(deployed.graph, 2, 2, seed=13)
        batcher = ContinuousBatcher(SessionPool(deployed, 1, backend="ref"))
        batcher.submit(StreamRequest("future", frames[0], arrival=6))
        batcher.submit(StreamRequest("now", frames[1], arrival=0))
        assert batcher.admissible() == 1 and batcher.queue_depth == 2
        results = batcher.run(max_ticks=30)
        by_id = {r.stream_id: r for r in results}
        assert set(by_id) == {"future", "now"}
        assert by_id["now"].admitted_tick == 0       # served immediately
        assert by_id["future"].admitted_tick == 6

    def test_arrival_gap_advances_time(self, deployed):
        frames = clips_for(deployed.graph, 1, 2, seed=9)
        batcher = ContinuousBatcher(SessionPool(deployed, 2, backend="ref"))
        batcher.submit(StreamRequest("late", frames[0], arrival=3))
        results = batcher.run(max_ticks=20)
        assert len(results) == 1 and results[0].admitted_tick == 3

    def test_submit_validation(self, deployed):
        frames = clips_for(deployed.graph, 1, 2, seed=10)
        batcher = ContinuousBatcher(SessionPool(deployed, 2, backend="ref"))
        batcher.submit(StreamRequest("dup", frames[0]))
        with pytest.raises(ValueError, match="duplicate"):
            batcher.submit(StreamRequest("dup", frames[0]))
        with pytest.raises(ValueError, match="frames must be"):
            StreamRequest("bad", frames[0, 0])
        with pytest.raises(ValueError, match="empty clip"):
            StreamRequest("empty", frames[0][:0])

    def test_results_report_accuracy_and_tensor_clips(self, deployed):
        """Clips may be tensors as well as numpy arrays; labelled results
        feed the accuracy aggregate."""
        frames = clips_for(deployed.graph, 2, 2, seed=14)
        batcher = ContinuousBatcher(SessionPool(deployed, 2, backend="ref"))
        batcher.submit_many([
            StreamRequest("a", _t(frames[0]), label=0),
            StreamRequest("b", frames[1]),
        ])
        ra, rb = sorted(batcher.run(), key=lambda r: r.stream_id)
        assert ra.correct in (True, False) and rb.correct is None
        assert batcher.stats()["accuracy"] in (0.0, 1.0)
        assert not batcher.pending and batcher.inflight_count == 0


# ---------------------------------------------------------------------------
# data pipeline and the launcher (the slice as a whole)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(batch=3, steps=4, hw=32, seed=0),
    dict(batch=2, steps=3, hw=64, seed=5, n_classes=6),
    dict(batch=2, steps=6, hw=32, seed=2, duty_cycle=0.4),
])
def test_dvs_pipeline_byte_identical(kw):
    batch = kw.pop("batch")
    pj, pt = PipelineJ(batch, **kw), DVSEventPipeline(batch, **kw)
    for _ in range(2):  # two consecutive batches: the cursor advances alike
        fj, lj = pj.next_batch()
        ft, lt = pt.next_batch()
        assert isinstance(ft, np.ndarray) and ft.dtype == np.float32
        assert ft.tobytes() == np.asarray(fj).tobytes()
        assert lt.dtype == np.int32 and lt.tobytes() == np.asarray(lj).tobytes()
    assert pt.state.to_dict() == pj.state.to_dict()
    assert PipelineState.from_dict(pt.state.to_dict()) == pt.state
    with pytest.raises(ValueError, match="duty_cycle"):
        DVSEventPipeline(1, duty_cycle=1.5)


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_launch_serve_dvs_main_returns_zero(backend, capsys):
    """The slice as a whole, through the entry point a user calls."""
    rc = launch_serve.main([
        "--dvs", "--net", "dvs_cnn_tcn_smoke", "--pool", "2", "--streams", "3",
        "--frames", "4", "--device", "cpu", "--backend", backend,
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "12 frames in" in out and "2 streams replayed, 0 mismatches" in out
    assert "logits finite: True" in out


def test_launch_serve_edge_cases(capsys):
    assert launch_serve.main(["--dvs", "--frames", "0", "--device", "cpu"]) == 0
    assert "stays idle" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "no-such-arch", "--device", "cpu"])  # not an LM
    with pytest.raises(SystemExit):
        launch_serve.main(["--dvs", "--backend", "pallas", "--device", "cpu"])


def test_launch_serve_refuses_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="is_available"):
        launch_serve.main(["--dvs", "--net", "dvs_cnn_tcn_smoke", "--frames", "2"])


def test_launch_serve_matches_reference_launcher_frames():
    """The launcher feeds the pool the reference launcher's frames: same
    pipeline arguments, same bytes."""
    g = tapi.get_graph("dvs_cnn_tcn_smoke")
    ft, lt = DVSEventPipeline(3, steps=4, hw=g.input_hw[0], seed=0).next_batch()
    fj, lj = PipelineJ(3, steps=4, hw=g.input_hw[0], seed=0).next_batch()
    exact(ft, fj); exact(lt, lj)
