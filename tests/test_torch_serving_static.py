"""The serving step over static tensors — `SessionPool(jit=...)`,
`StreamSession(jit=...)`, the pool's staging ring (`stage`, `next_pair`,
the fleet feeder's prefetch into it) and its copy events, the in-place slot
surgery and `stream_tcn_apply` — held against the reference on the CPU.

The pool and the session keep their state in tensors whose addresses never
change (on the card a captured CUDA graph reads and writes them there); on
the CPU the step runs eagerly over the same tensors, so the address
invariant and the numerics are both checked here.  Nets are the registry's
``dvs_cnn_tcn_nano`` / ``_smoke``, quantized by the port and handed to the
reference as numpy; every comparison is equality.  The captured path itself
runs only on a card: the ``gpu``-marked tests at the end (and
``chip_smoke.py``) hold it against the eager step there.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import api as japi
from repro.api.program import DeployedProgram as DeployedJ
from repro.core import tcn as jtcn
from repro.serving import SessionPool as SessionPoolJ
from repro.serving import masking as jmask
from repro_torch import api as tapi
from repro_torch import artifact, convert
from repro_torch.capture import CapturedStep
from repro_torch.obs import Tracer
from repro_torch.core import TCNStream, stream_tcn_apply
from repro_torch.serving import (
    ContinuousBatcher,
    FrameFeeder,
    PoolState,
    SessionPool,
    StreamRequest,
    clear_slot,
    clear_slot_,
    masked_push,
    masked_push_,
    scatter_slot,
    scatter_slot_,
)
from repro_torch.serving.masking import gather_slot

NANO = "dvs_cnn_tcn_nano"
ROOT = Path(__file__).resolve().parent.parent


def _tables(x, leaf):
    if isinstance(x, dict):
        return {k: _tables(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables(v, leaf) for v in x]
    return leaf(x)


def _pair(name, seed=0):
    """A registry net quantized by the port, handed as numpy to both
    packages: (reference DeployedProgram, port DeployedProgram)."""
    prog = tapi.get_net(name)
    g = prog.graph
    calib = (torch.rand((2, 4, *g.input_hw, g.input_ch),
                        generator=torch.Generator().manual_seed(seed + 100)) < 0.3).float()
    tables = _tables(prog.quantize(
        prog.init(torch.Generator().manual_seed(seed), device="cpu"), calib=calib).tables,
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v)
    ref = DeployedJ(japi.get_graph(name), _tables(
        tables, lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v))
    return ref, convert.deployed_from_reference_tables(g, tables, device="cpu")


@pytest.fixture(scope="module")
def nano():
    return _pair(NANO)


def clips_for(graph, n_streams, frames, seed=0):
    shape = (n_streams, frames, *graph.input_hw, graph.input_ch)
    return (np.random.default_rng(seed).random(shape) < 0.3).astype(np.float32)


def exact(a, b):
    to_np = lambda v: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.testing.assert_array_equal(to_np(a), to_np(b))


def _ptrs(pool):
    return [(b.state.buf.data_ptr(), b.state.cursor.data_ptr(), b.state.steps.data_ptr(),
             b.frames.data_ptr(), b.active.data_ptr()) for b in pool._blocks]


# ---------------------------------------------------------------------------
# the in-place slot surgery
# ---------------------------------------------------------------------------

def _pushed(seed, n=5):
    """A port state and the reference's after ``n`` identical masked pushes."""
    rng = np.random.RandomState(seed)
    st_t, st_j = PoolState.create(3, 4, 2, device="cpu"), jmask.PoolState.create(3, 4, 2)
    for _ in range(n):
        feats = rng.randint(-4, 5, (3, 2)).astype(np.float32) / 4
        active = rng.rand(3) < 0.7
        st_t = masked_push(st_t, torch.from_numpy(feats), torch.from_numpy(active))
        st_j = jmask.masked_push(st_j, jnp.asarray(feats), jnp.asarray(active))
    return st_t, st_j


def _same_state(a, b):
    exact(a.buf, b.buf); exact(a.cursor, b.cursor); exact(a.steps, b.steps)


def _copy(st):
    return PoolState(st.buf.clone(), st.cursor.clone(), st.steps.clone())


def test_masked_push_in_place_equals_functional_and_reference():
    rng = np.random.RandomState(0)
    st, st_f = PoolState.create(3, 4, 5, device="cpu"), PoolState.create(3, 4, 5, device="cpu")
    st_j = jmask.PoolState.create(3, 4, 5)
    ptrs = (st.buf.data_ptr(), st.cursor.data_ptr(), st.steps.data_ptr())
    for _ in range(9):  # over a cursor wrap
        feats = rng.randint(-4, 5, (3, 5)).astype(np.float32) / 4
        active = rng.rand(3) < 0.6
        masked_push_(st, torch.from_numpy(feats), torch.from_numpy(active))
        st_f = masked_push(st_f, torch.from_numpy(feats), torch.from_numpy(active))
        st_j = jmask.masked_push(st_j, jnp.asarray(feats), jnp.asarray(active))
        _same_state(st, st_f)
        _same_state(st, st_j)
    assert (st.buf.data_ptr(), st.cursor.data_ptr(), st.steps.data_ptr()) == ptrs


@pytest.mark.parametrize("slot", [0, 2])
def test_scatter_and_clear_in_place_equal_functional_and_reference(slot):
    st_t, st_j = _pushed(1)
    src_t, src_j = _pushed(2)
    moved_t, moved_j = gather_slot(src_t, 1), jmask.gather_slot(src_j, 1)
    inplace = _copy(st_t)
    scatter_slot_(inplace, slot, moved_t)
    _same_state(inplace, scatter_slot(st_t, slot, moved_t))
    _same_state(inplace, jmask.scatter_slot(st_j, slot, moved_j))
    clear_slot_(inplace, slot)
    _same_state(inplace, clear_slot(scatter_slot(st_t, slot, moved_t), slot))
    _same_state(inplace, jmask.clear_slot(jmask.scatter_slot(st_j, slot, moved_j), slot))


def test_scatter_in_place_rejects_what_the_functional_form_rejects():
    from repro_torch.core.tcn import StreamState

    state = PoolState.create(2, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="batch-free"):
        scatter_slot_(state, 0, StreamState.create(4, 2, batch=3, device="cpu"))
    with pytest.raises(ValueError, match="does not fit"):
        scatter_slot_(state, 0, StreamState.create(5, 2, device="cpu"))
    assert float(state.buf.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the pool's static tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", [True, False])
def test_pool_state_keeps_its_addresses(nano, jit):
    """Ticks, admit, admit(state=...), evict, reset and a swap_pool write
    into the same tensors."""
    _, dep = nano
    frames = clips_for(dep.graph, 4, 6, seed=1)
    pool = SessionPool(dep, 3, backend="fused", jit=jit)
    ptrs = _ptrs(pool)
    pool.admit("a"); pool.admit("b")
    pool.step({"a": frames[0, 0], "b": frames[1, 0]})
    state = pool.evict("b")
    pool.admit("c", state=state)
    pool.reset("a")
    pool.step({"a": frames[0, 1], "c": frames[1, 1]})
    assert _ptrs(pool) == ptrs

    bat = ContinuousBatcher(pool)
    for i in range(2):
        bat.submit(StreamRequest(f"s{i}", frames[2 + i]))
    pool.evict("a"); pool.evict("c")
    bat.tick()
    bigger = SessionPool(dep, 4, backend="fused", jit=jit)
    big_ptrs = _ptrs(bigger)
    bat.swap_pool(bigger)
    bat.run()
    assert _ptrs(pool) == ptrs and _ptrs(bigger) == big_ptrs


@pytest.mark.parametrize("jit", [True, False])
def test_returned_logits_do_not_change_on_the_next_tick(nano, jit):
    _, dep = nano
    frames = clips_for(dep.graph, 2, 4, seed=2)
    pool = SessionPool(dep, 2, backend="ref", jit=jit)
    pool.admit("a"); pool.admit("b")
    kept = []
    for t in range(4):
        logits = pool.step_prepared(*pool.stage({"a": frames[0, t], "b": frames[1, t]}))
        kept.append((logits, logits.clone()))
    for logits, copy in kept:
        assert torch.equal(logits, copy)
    assert len({l.data_ptr() for l, _ in kept}) == len(kept)


def test_prepare_writes_into_the_callers_buffers_as_the_reference(nano):
    """The port's `stage` assembles what the reference pool's `prepare`
    writes into the caller's buffers, for the same admissions and
    evictions, a tensor frame with a leading axis among them."""
    ref, dep = nano
    frames = clips_for(dep.graph, 3, 1, seed=3)[:, 0]
    pool_t, pool_j = SessionPool(dep, 4), SessionPoolJ(ref, 4, backend="ref")
    for sid in ("a", "b", "c"):
        assert pool_t.admit(sid) == pool_j.admit(sid)
    pool_t.evict("b"); pool_j.evict("b")
    got_b, got_a = pool_t.stage({"a": frames[0], "c": torch.from_numpy(frames[2][None])})
    want_b, want_a = pool_j.prepare({"a": frames[0], "c": frames[2][None]},
                                    out_batch=np.full_like(got_b, 7.0),
                                    out_active=np.ones((4,), bool))
    exact(got_b, want_b); exact(got_a, want_a)


def test_step_prepared_rejects_a_misshaped_batch(nano):
    """`step_prepared` takes only a pair of this pool's ring: a misshaped
    batch, fresh arrays of the right shape and another pool's staged pair
    are refused, naming `stage`."""
    _, dep = nano
    pool, other = SessionPool(dep, 2), SessionPool(dep, 2)
    pool.admit("a"); other.admit("a")
    frame = clips_for(dep.graph, 1, 1, seed=5)[0, 0]
    staged = pool.stage({"a": frame})
    for batch, active in (
            (np.zeros((1, *pool.frame_shape), np.float32), np.zeros(2, bool)),
            (staged[0].copy(), staged[1].copy()),
            (staged[0], np.zeros(2, bool)),
            other.stage({"a": frame})):
        with pytest.raises(ValueError, match=r"stage\(\)"):
            pool.step_prepared(batch, active)
    assert pool.trace_count == 0
    pool.step_prepared(*staged)
    assert pool.trace_count == 1


# ---------------------------------------------------------------------------
# the pool's staging ring
# ---------------------------------------------------------------------------

def _assembled(pool, frames):
    """A tick's ``(batch, active)`` assembled from scratch in numpy: each
    stream's frame in its slot's lane, marked active; every other lane zero."""
    batch = np.zeros((pool.pool_size, *pool.frame_shape), np.float32)
    active = np.zeros((pool.pool_size,), bool)
    for sid, frame in frames.items():
        frame = frame.numpy() if isinstance(frame, torch.Tensor) else frame
        batch[pool.slot_of(sid)] = frame.reshape(pool.frame_shape)
        active[pool.slot_of(sid)] = True
    return batch, active


def test_staged_batch_equals_prepare_through_churn_and_readmission(nano):
    """`stage` hands out the ring's two pairs in turn, and each holds what
    a from-scratch assembly holds: a lane that went idle reads zero and
    inactive, and a slot re-admitted to another stream carries its frame."""
    _, dep = nano
    frames = clips_for(dep.graph, 5, 8, seed=11)
    pool = SessionPool(dep, 4, backend="fused")
    ticks = [  # (evicted, admitted, the streams that step)
        ([], ["a", "b", "c"], "abc"),
        ([], ["d"], "abd"),      # c skips a tick: its lane idles
        (["a"], [], "bcd"),
        ([], ["e"], "ce"),       # e takes a's slot; b and d idle
        (["c", "e"], [], "bd"),
        ([], ["a"], "a"),        # a back, in the slot e left
        ([], [], ""),
        ([], [], "abd"),
    ]
    handed = []
    for k, (evicted, admitted, stepping) in enumerate(ticks):
        for sid in evicted:
            pool.evict(sid)
        for sid in admitted:
            pool.admit(sid)
        batch = {sid: frames["abcde".index(sid), k] for sid in stepping}
        if "b" in batch:  # a tensor with a leading axis, as `stage` takes it
            batch["b"] = torch.from_numpy(batch["b"][None])
        got_b, got_a = pool.stage(batch)
        want_b, want_a = _assembled(pool, batch)
        exact(got_b, want_b); exact(got_a, want_a)
        idle = sorted(set(range(4)) - {pool.slot_of(sid) for sid in stepping})
        assert not got_a[idle].any() and not got_b[idle].any()
        pool.step_prepared(got_b, got_a)
        handed.append(got_b)
    assert not any(p.pinned or p.copied is not None for p in pool._ring)
    assert all(b is pool._ring[k % 2].batch for k, b in enumerate(handed))
    # a frame the fill rejects leaves the pair it was writing consistent
    with pytest.raises(ValueError, match="frame shape"):
        pool.stage({"a": frames[0, 0], "b": np.zeros((3, 3), np.float32)})
    pool.stage({"d": frames[3, 1]})
    for batch in ({"d": frames[3, 2]}, {"a": frames[0, 3], "b": frames[1, 3]}):
        got_b, got_a = pool.stage(batch)
        want_b, want_a = _assembled(pool, batch)
        exact(got_b, want_b); exact(got_a, want_a)


def test_stage_waits_for_a_pairs_copy_before_rewriting_it(nano):
    _, dep = nano
    frames = clips_for(dep.graph, 1, 4, seed=12)
    tracer = Tracer(clock="tick")
    pool = SessionPool(dep, 2, tracer=tracer)
    pool.admit("a")
    first, _ = pool.stage({"a": frames[0, 0]})
    pool._ring[0].copied = landed = _Event(done=True)
    pool.stage({"a": frames[0, 1]})
    pool._ring[1].copied = in_flight = _Event(done=False)
    again, _ = pool.stage({"a": frames[0, 2]})  # the first pair: its copy has landed
    assert again is first and landed.waited == 0
    assert not [e for e in tracer.events() if e.name == "pool.stage_wait"]
    pool.stage({"a": frames[0, 3]})  # the second: waits for its copy, once
    assert in_flight.waited == 1
    pool.stage({"a": frames[0, 0]}); pool.stage({"a": frames[0, 1]})  # both landed now
    assert (landed.waited, in_flight.waited) == (0, 1)
    waits = [e for e in tracer.events() if e.name == "pool.stage_wait"]
    assert len(waits) == 1 and waits[0].phase == "i" and waits[0].args["waited_us"] >= 0


# ---------------------------------------------------------------------------
# jit=True / jit=False against the reference pool, with churn and migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", [True, False])
def test_pool_equals_reference_pool_under_churn_refill_and_migration(nano, jit):
    ref, dep = nano
    frames = clips_for(dep.graph, 4, 7, seed=4)
    pools_t = [SessionPool(dep, 2, backend="fused", jit=jit),
               SessionPool(dep, 3, backend="ref", jit=jit)]
    pools_j = [SessionPoolJ(ref, 2, backend="ref"), SessionPoolJ(ref, 3, backend="ref")]
    clip = {"a": 0, "b": 1, "c": 2, "d": 3}
    schedule = [
        (0, "admit", "a"), (0, "admit", "b"),
        (0, "step", {"a": 0, "b": 0}), (0, "step", {"a": 1, "b": 1}), (0, "step", {"b": 2}),
        (0, "evict", "b"), (0, "admit", "c"),                     # refill
        (0, "step", {"a": 2, "c": 0}),
        (0, "migrate", "a"),                                      # pool 0 -> pool 1
        (1, "admit", "d"),
        (1, "step", {"a": 3, "d": 0}), (0, "step", {"c": 1}),
        (1, "reset", "d"),
        (1, "step", {"a": 4, "d": 1}), (0, "step", {"c": 2}),
        (1, "step", {"a": 5}),
    ]
    for p, op, arg in schedule:
        pt, pj = pools_t[p], pools_j[p]
        if op == "admit":
            assert pt.admit(arg) == pj.admit(arg)
        elif op == "evict":
            pt.evict(arg); pj.evict(arg)
        elif op == "reset":
            pt.reset(arg); pj.reset(arg)
        elif op == "migrate":
            assert pools_t[1].admit(arg, state=pt.evict(arg)) == pools_j[1].admit(
                arg, state=pj.evict(arg))
        else:
            batch = {sid: frames[clip[sid], t] for sid, t in arg.items()}
            out_t, out_j = pt.step(batch), pj.step(batch)
            assert set(out_t) == set(out_j)
            for sid in out_t:
                exact(out_t[sid], out_j[sid])
    for pt, pj in zip(pools_t, pools_j):
        _same_state(pt.state, pj.state)
        assert pt.trace_count == 1


def test_trace_count_is_one_through_a_batcher_run_and_a_swap(nano):
    _, dep = nano
    frames = clips_for(dep.graph, 5, 4, seed=5)
    small, big = SessionPool(dep, 2), SessionPool(dep, 4)
    assert small.trace_count == big.trace_count == 0
    bat = ContinuousBatcher(small)
    for i in range(5):
        bat.submit(StreamRequest(f"s{i}", frames[i], arrival=i // 2))
    for _ in range(2):
        bat.tick()
    bat.swap_pool(big)
    bat.run()
    bat.swap_pool(small)
    for i in range(2):
        bat.submit(StreamRequest(f"t{i}", frames[i]))
    results = bat.run()
    assert len(results) == 7
    assert small.trace_count == big.trace_count == 1


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("batch", [None, 2])
def test_stream_session_jit_equals_reference_session(nano, jit, batch):
    ref, dep = nano
    frames = clips_for(dep.graph, 2, 5, seed=6)
    s_t = dep.stream(batch=batch, backend="fused", jit=jit)
    s_j = ref.stream(batch=batch, backend="ref", jit=True)
    ptrs = (s_t.state.ring.buf.data_ptr(), s_t.state.steps_seen.data_ptr())
    clip = frames[:1] if batch is None else frames
    for t in range(5):
        exact(s_t.step(torch.from_numpy(clip[:, t])), s_j.step(jnp.asarray(clip[:, t])))
    assert s_t.steps_seen == s_j.steps_seen == 5 and s_t.trace_count == 1
    exported = s_t.export_state()
    exact(exported.ring.buf, s_j.export_state().ring.buf)
    s_t.step(torch.from_numpy(clip[:, 0]))
    exact(exported.ring.buf, s_j.export_state().ring.buf)  # a copy: unmoved
    s_t.reset()
    assert s_t.steps_seen == 0 and float(s_t.state.ring.buf.abs().sum()) == 0.0
    s_t.load_state(exported)
    assert s_t.steps_seen == 5
    assert (s_t.state.ring.buf.data_ptr(), s_t.state.steps_seen.data_ptr()) == ptrs


def test_loaded_program_stream_passes_jit_through(nano):
    _, dep = nano
    loaded = artifact.loads(dep.to_artifact_bytes(), device="cpu")
    frames = clips_for(dep.graph, 1, 3, seed=7)
    a = loaded.stream(batch=1, backend="fused", jit=False)
    b = dep.stream(batch=1, backend="fused", jit=True)
    assert a.jit is False and b.jit is True
    for t in range(3):
        exact(a.step(torch.from_numpy(frames[:, t])), b.step(torch.from_numpy(frames[:, t])))
    assert dep.serve(2, jit=False).jit is False


# ---------------------------------------------------------------------------
# stream_tcn_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 2])
def test_stream_tcn_apply_equals_reference(batch):
    rng = np.random.RandomState(8)
    w = rng.randint(-1, 2, (4, 3)).astype(np.float32)
    ring_t = TCNStream.create(5, 4, batch=batch, device="cpu")
    ring_j = jtcn.TCNStream.create(5, 4, batch=batch)
    for _ in range(7):  # past a wrap
        v = rng.randint(-2, 3, (4,) if batch is None else (batch, 4)).astype(np.float32)
        ring_t, ring_j = ring_t.push(torch.from_numpy(v)), ring_j.push(jnp.asarray(v))
    got = stream_tcn_apply(ring_t, lambda x: x[:, -1, :] @ torch.from_numpy(w)
                           + x.sum(dim=1)[:, :3])
    want = jtcn.stream_tcn_apply(ring_j, lambda x: x[:, -1, :] @ jnp.asarray(w)
                                 + x.sum(axis=1)[:, :3])
    assert got.shape == ((3,) if batch is None else (batch, 3))
    exact(got, want)


# ---------------------------------------------------------------------------
# CapturedStep off the card, and the feeder's copy events
# ---------------------------------------------------------------------------

def test_captured_step_runs_eagerly_off_the_card():
    calls = []

    def fn():
        calls.append(1)
        return torch.full((2,), float(len(calls)))

    step = CapturedStep(fn, "cpu", capture=True)
    assert not step.capture and step.builds == 0
    assert step().tolist() == [1.0, 1.0] and step().tolist() == [2.0, 2.0]
    assert step.builds == 1 and not step.captured and len(calls) == 2


class _Event:
    """A stand-in for a copy's CUDA event: landed or not, and waited on."""

    def __init__(self, done=False):
        self.done, self.waited = done, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_feeder_waits_on_a_buffers_copy_event_before_refilling_it(nano):
    """A feeder prefetch takes the pool's next ring pair: where that pair's
    last copy is in flight it waits for it once, through the pool, with
    one ``pool.stage_wait``."""
    _, dep = nano
    frames = clips_for(dep.graph, 1, 4, seed=14)
    tracer = Tracer(clock="tick")
    pool = SessionPool(dep, 2, tracer=tracer)
    pool.admit("s")
    items = lambda t: [("s", pool.slot_of("s"), frames[0], t)]
    feeder = FrameFeeder(mode="sync")
    first, _ = pool.stage({"s": frames[0, 0]})
    pool._ring[0].copied = in_flight = _Event(done=False)  # the copy from `first`
    feeder.prefetch(pool, items(1))  # the other pair: no wait
    assert in_flight.waited == 0
    feeder.take()
    feeder.prefetch(pool, items(2))  # `first` again: waits for its copy first
    assert in_flight.waited == 1
    batch, active, covered = feeder.take()
    assert batch is first and covered == {"s": pool.slot_of("s")}
    exact(batch, _assembled(pool, {"s": frames[0, 2]})[0])
    feeder.prefetch(pool, items(3))
    pool.stage({"s": frames[0, 0]})  # landed now: no second wait
    assert in_flight.waited == 1
    waits = [e for e in tracer.events() if e.name == "pool.stage_wait"]
    assert len(waits) == 1 and waits[0].args["waited_us"] >= 0
    feeder.close()


def test_a_stage_after_an_invalidated_prefetch_leaves_no_stale_lane(nano):
    """The feeder fills a pair for three streams, the prefetch is
    invalidated, one stream is cancelled, and the later `stage` into the
    same pair holds exactly a from-scratch assembly."""
    _, dep = nano
    frames = clips_for(dep.graph, 3, 3, seed=15)
    pool = SessionPool(dep, 4)
    for sid in ("a", "b", "c"):
        pool.admit(sid)
    feeder = FrameFeeder(mode="thread")
    feeder.prefetch(pool, [(sid, pool.slot_of(sid), frames[i], 1)
                           for i, sid in enumerate("abc")])
    feeder.invalidate()
    assert feeder.take() is None
    pool.evict("b")
    pool.stage({"a": frames[0, 0], "c": frames[2, 0]})  # the ring's other pair
    tick = {"a": frames[0, 2], "c": frames[2, 2]}
    got_b, got_a = pool.stage(tick)  # the pair the feeder filled
    assert got_b is pool._ring[0].batch
    want_b, want_a = _assembled(pool, tick)
    exact(got_b, want_b); exact(got_a, want_a)
    feeder.close()


# ---------------------------------------------------------------------------
# the two serving examples, at their smallest on a smoke net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,args,done", [
    ("serve_dvs_stream_torch.py", ["--batch", "2", "--frames", "3"], "serve_dvs_stream OK"),
    ("serve_sensor_pool_torch.py", ["--pool", "2", "--frames", "3"], "serve_sensor_pool OK"),
])
def test_serving_example_runs_on_the_cpu(script, args, done):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         "--net", "dvs_cnn_tcn_smoke", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.rstrip().splitlines()[-1] == done
    if script.startswith("serve_sensor_pool"):
        assert "trace_count 1 " in proc.stdout


# ---------------------------------------------------------------------------
# on the card: the captured step == the eager step
# ---------------------------------------------------------------------------

def _cuda_pair(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph")
    prog = tapi.get_net(name)
    g = prog.graph
    frames = clips_for(g, 4, 6, seed=9)
    dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cuda"),
                        calib=torch.from_numpy(frames).cuda())
    return dep, frames


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "kernel", "ref", "bitsim"])
def test_captured_pool_equals_eager_pool_on_the_card(backend):
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda

    dep, frames = _cuda_pair("dvs_cnn_tcn_smoke")
    out = {}
    for jit in (True, False):
        pool = dep.serve(3, backend=backend, jit=jit)
        bat = ContinuousBatcher(pool)
        for i in range(4):
            bat.submit(StreamRequest(f"s{i}", frames[i], arrival=i))
        ternary_conv2d_cuda.launches = 0
        out[jit] = {r.stream_id: r.logits for r in bat.run()}
        per_tick = 9 if backend in ("fused", "kernel") else 0
        assert ternary_conv2d_cuda.launches == per_tick * len(bat.latency_trace)
        assert pool.trace_count == 1 and pool.captured == jit
    for sid, logits in out[False].items():
        np.testing.assert_array_equal(out[True][sid], logits)


@pytest.mark.gpu
def test_captured_session_equals_eager_session_on_the_card():
    dep, frames = _cuda_pair("dvs_cnn_tcn_smoke")
    a = dep.stream(batch=1, jit=True)
    b = dep.stream(batch=1, jit=False)
    clip = torch.from_numpy(frames[:1]).cuda()
    for t in range(6):
        assert torch.equal(a.step(clip[:, t]), b.step(clip[:, t]))
    assert a.trace_count == 1 and a.captured and not b.captured
    with pytest.raises(ValueError, match="captured step takes"):
        a.step(clip[:, 0].repeat(2, 1, 1, 1))


@pytest.mark.gpu
def test_dead_sessions_collected_during_a_capture_do_not_break_it():
    """A dead captured session (a reference cycle) freed by the garbage
    collector in the middle of another capture would end that capture: the
    collector is paused while capturing.  A threshold of 1 makes it run at
    nearly every allocation."""
    import gc

    dep, frames = _cuda_pair("dvs_cnn_tcn_smoke")
    clip = torch.from_numpy(frames[:1]).cuda()
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(4):
            session = dep.stream(batch=1, jit=True)
            for t in range(2):
                session.step(clip[:, t])
            assert session.captured
    finally:
        gc.set_threshold(*threshold)
    assert gc.isenabled()


@pytest.mark.gpu
def test_a_staged_batcher_on_the_card_equals_lone_sessions():
    """A churned batcher on a CUDA pool assembles through the pinned ring
    and copies without blocking: every ``pool.upload`` is pinned and
    staged, and each stream's logits equal, bit for bit, a lone
    `StreamSession` fed its clip."""
    dep, _ = _cuda_pair("dvs_cnn_tcn_smoke")
    clips = clips_for(dep.graph, 9, 8, seed=13)
    lengths = [2 + (5 * i) % 7 for i in range(9)]
    tracer = Tracer(clock="tick")
    bat = ContinuousBatcher(dep.serve(3, backend="fused", tracer=tracer), tracer=tracer)
    for i in range(9):  # 2-8 frames, more streams than slots: slots refill
        bat.submit(StreamRequest(f"s{i}", clips[i, :lengths[i]], arrival=i // 2))
    out = {r.stream_id: r.logits for r in bat.run()}
    assert len(out) == 9
    for i in range(9):
        session = dep.stream(batch=1, backend="fused")
        clip = torch.from_numpy(clips[i:i + 1, :lengths[i]]).cuda()
        for t in range(lengths[i]):
            lone = session.step(clip[:, t])
        np.testing.assert_array_equal(out[f"s{i}"], lone.cpu().numpy()[0])
    uploads = {tuple(sorted(e.args.items())) for e in tracer.events()
               if e.name == "pool.upload"}
    nbytes = 3 * int(np.prod(dep.graph.input_hw)) * dep.graph.input_ch * 4 + 3
    assert uploads == {(("bytes", nbytes), ("pinned", True), ("staged", True))}


@pytest.mark.gpu
def test_a_staged_pair_is_not_rewritten_while_its_copy_is_in_flight():
    """The stream is stalled before a tick's copy; the host stages the next
    two ticks without a synchronize, the second into the stalled copy's
    pair, which must wait for it.  Logits equal a run synchronized after
    every tick."""
    dep, frames = _cuda_pair("dvs_cnn_tcn_smoke")
    out, waits = {}, {}
    for stall in (True, False):
        tracer = Tracer(clock="tick")
        pool = dep.serve(4, backend="fused", tracer=tracer)
        for i in range(4):
            pool.admit(f"s{i}")
        ticks = []
        for t in range(6):
            if stall and t in (1, 4):
                torch.cuda._sleep(100_000_000)  # tens of ms of the stream's time
            ticks.append(pool.step({f"s{i}": frames[i, t] for i in range(4) if (t + i) % 5}))
            if not stall:
                torch.cuda.synchronize()
        out[stall] = [{sid: v.cpu().numpy() for sid, v in tick.items()} for tick in ticks]
        waits[stall] = sum(e.name == "pool.stage_wait" for e in tracer.events())
    assert waits[True] >= 1 and waits[False] == 0
    for got, want in zip(out[True], out[False]):
        assert got.keys() == want.keys()
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid])
