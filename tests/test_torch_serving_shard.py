"""The pool's slot axis laid across devices (`SessionPool(sharding=...)`,
`PoolSharding`, `_resolve_sharding`) on the CPU — the counterpart of
tests/test_serving.py's forced-device sharding test — plus the launcher's
``--shard`` and the packed-ternary decode example.

Four blocks on the one CPU run the same code as four cards: each block its
own static tensors and step.  Every comparison is equality, against the
unsplit pool and the reference's pool on the same tables and frames."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.program import CutieProgram as CutieProgramJ
from repro.configs import get_config as ref_config
from repro.models.model import init_params as ref_init_params
from repro.serving import SessionPool as SessionPoolJ
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (
    ContinuousBatcher,
    PoolSharding,
    SessionPool,
    StreamRequest,
)
from repro_torch.serving.pool import _resolve_sharding
from tests.test_torch_serving import _tree_np, clips_for, exact, tiny_graph

ROOT = Path(__file__).resolve().parent.parent
CPU4 = PoolSharding(["cpu"] * 4)


@pytest.fixture(scope="module")
def pair():
    """The reference's deployed tiny net and the port's, over the same tables."""
    prog = CutieProgramJ(tiny_graph(japi))
    frames = clips_for(prog.graph, 4, 3, seed=12)
    ref = prog.quantize(prog.init(jax.random.PRNGKey(0)), calib=jnp.asarray(frames))
    port = convert.deployed_from_reference_tables(
        tiny_graph(tapi), _tree_np(ref.tables), device="cpu")
    return ref, port


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_split_pool_equals_plain_and_reference_pool(pair, backend):
    """The reference's forced-device scenario: four streams, three ticks,
    split == plain == the reference's pool, bit for bit."""
    ref, port = pair
    frames = clips_for(port.graph, 4, 3, seed=12)
    split = SessionPool(port, 4, backend=backend, sharding=CPU4)
    plain = SessionPool(port, 4, backend=backend)
    want = SessionPoolJ(ref, 4, backend=backend)
    assert split.sharding is CPU4 and plain.sharding is None
    assert [(b.lo, b.size) for b in split._blocks] == [(0, 1), (1, 1), (2, 1), (3, 1)]
    for pool in (split, plain, want):
        for i in range(4):
            pool.admit(f"s{i}")
    for t in range(3):
        fr = {f"s{i}": frames[i, t] for i in range(4)}
        a, b, c = split.step(fr), plain.step(fr), want.step(fr)
        for k in fr:
            exact(a[k], b[k])
            exact(a[k], c[k])
    exact(split.state.buf, plain.state.buf)
    exact(split.state.steps, plain.state.steps)
    assert split.trace_count == 4 and plain.trace_count == 1


def test_split_pool_through_admit_partial_evict_reset(pair):
    """Two blocks of three slots: churn across the block boundary, partial
    ticks, a mid-stream reset, evict -> re-admit with state into the other
    block; every tick == the plain pool's, and the evicted states equal."""
    _, port = pair
    frames = clips_for(port.graph, 6, 8, seed=3)
    split = SessionPool(port, 6, backend="fused", sharding=PoolSharding(["cpu", "cpu"]))
    plain = SessionPool(port, 6, backend="fused")
    assert [(b.lo, b.size) for b in split._blocks] == [(0, 3), (3, 3)]
    plan = {
        0: ("admit", ["a", "b", "c", "d"]),
        2: ("evict", ["b"]),
        3: ("admit", ["e", "f"]),
        4: ("reset", ["d"]),
        5: ("migrate", ["a"]),
    }
    clip = {sid: i for i, sid in enumerate("abcdef")}
    moved = {}
    for t in range(8):
        op, sids = plan.get(t, (None, []))
        for sid in sids:
            for pool in (split, plain):
                if op == "admit":
                    pool.admit(sid)
                elif op == "evict":
                    pool.evict(sid)
                elif op == "reset":
                    pool.reset(sid)
                elif op == "migrate":
                    moved[id(pool)] = pool.evict(sid)
                    pool.admit(sid, state=moved[id(pool)])
        live = split.active_streams
        assert live == plain.active_streams
        # partial ticks: on odd ticks only every other stream steps
        stepping = [s for j, s in enumerate(live) if t % 2 == 0 or j % 2 == 0]
        fr = {sid: frames[clip[sid], t] for sid in stepping}
        a, b = split.step(fr), plain.step(fr)
        for sid in fr:
            exact(a[sid], b[sid])
        for sid in live:
            assert split.steps_seen(sid) == plain.steps_seen(sid)
    for k in ("buf", "cursor", "steps"):
        exact(getattr(split.state, k), getattr(plain.state, k))
    a, b = split.evict("e"), plain.evict("e")
    exact(a.ring.buf, b.ring.buf)
    exact(a.steps_seen, b.steps_seen)
    assert split.trace_count == 2


def test_split_pool_through_the_batcher_and_swap_pool(pair):
    """Continuous batching over a split pool, swapped mid-run into a split
    pool of another size and back: per-stream logits == the plain pools'."""
    _, port = pair
    frames = clips_for(port.graph, 6, 5, seed=7)

    def run(sharding_small, sharding_big):
        small = SessionPool(port, 2, backend="fused", sharding=sharding_small)
        big = SessionPool(port, 4, backend="fused", sharding=sharding_big)
        batcher = ContinuousBatcher(small)
        for i in range(6):
            batcher.submit(StreamRequest(f"s{i}", frames[i], arrival=i))
        swapped_back = False
        while batcher.pending:
            if batcher.tick_index == 2:
                assert batcher.swap_pool(big) is small
            elif (batcher.tick_index >= 6 and not swapped_back
                  and batcher.inflight_count <= small.pool_size):
                batcher.swap_pool(small)
                swapped_back = True
            batcher.tick()
        assert swapped_back
        return {r.stream_id: r.logits for r in batcher.results}, small, big

    got, small, big = run(PoolSharding(["cpu", "cpu"]), CPU4)
    want, *_ = run(None, None)
    assert sorted(got) == sorted(want) == [f"s{i}" for i in range(6)]
    for sid in want:
        exact(got[sid], want[sid])
    assert small.trace_count == 2 and big.trace_count == 4


class TestResolveSharding:
    def test_off(self):
        for off in (None, False):
            assert _resolve_sharding(off, 8, torch.device("cpu")) is None

    def test_auto_is_none_on_one_device(self):
        for auto in ("auto", True):
            assert _resolve_sharding(auto, 8, torch.device("cpu")) is None

    def test_int_errors_in_the_references_words(self):
        with pytest.raises(ValueError, match=r"^requested 2 devices, host has 1$"):
            _resolve_sharding(2, 8, torch.device("cpu"))
        with pytest.raises(ValueError, match=r"^pool_size 3 not divisible by 2 devices$"):
            _resolve_sharding(PoolSharding(["cpu", "cpu"]), 3, torch.device("cpu"))
        with pytest.raises(ValueError, match="unknown sharding spec"):
            _resolve_sharding("model", 8, torch.device("cpu"))

    def test_one_device_and_passthrough(self):
        one = _resolve_sharding(1, 8, torch.device("cpu"))
        assert isinstance(one, PoolSharding) and one.devices == (torch.device("cpu"),)
        assert _resolve_sharding(CPU4, 8, torch.device("cpu")) is CPU4

    def test_cards_are_the_local_devices(self, monkeypatch):
        """On the card "auto" takes every card when they divide the pool."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        got = _resolve_sharding("auto", 8, torch.device("cuda", 0))
        assert got.devices == tuple(torch.device("cuda", i) for i in range(4))
        assert _resolve_sharding("auto", 6, torch.device("cuda", 0)) is None
        assert _resolve_sharding(2, 6, torch.device("cuda", 0)).devices == (
            torch.device("cuda", 0), torch.device("cuda", 1))
        with pytest.raises(ValueError, match=r"^pool_size 6 not divisible by 4 devices$"):
            _resolve_sharding(4, 6, torch.device("cuda", 0))
        with pytest.raises(ValueError, match=r"^requested 5 devices, host has 4$"):
            _resolve_sharding(5, 10, torch.device("cuda", 0))

    def test_pool_takes_the_errors(self, pair):
        with pytest.raises(ValueError, match="requested 4 devices, host has 1"):
            SessionPool(pair[1], 8, sharding=4)

    def test_program_copies_for_a_block_on_another_device(self, pair):
        """A block on another device runs ``program.to(device)``: the same
        program with every table tensor there (itself on its own device)."""
        port = pair[1]
        assert port.to("cpu") is port
        moved = port.to("meta")
        assert moved.graph is port.graph and moved.device.type == "meta"
        leaves = lambda t: [x for x in _flat(t) if isinstance(x, torch.Tensor)]
        assert [x.shape for x in leaves(moved.tables)] == [x.shape for x in leaves(port.tables)]
        assert all(x.device.type == "meta" for x in leaves(moved.tables))

    def test_loaded_program_copies_too(self, pair):
        from repro_torch import artifact

        loaded = artifact.loads(pair[1].to_artifact_bytes(), device="cpu")
        assert loaded.to("cpu") is loaded
        other = loaded.to("meta")
        assert other.device.type == "meta" and other.plan is loaded.plan


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_shard_flag_on_the_launcher(capsys):
    """``--dvs --shard`` on one device: the pool stays one block and the
    summary line says so; ``--fleet --shard`` serves as without it."""
    argv = ["--dvs", "--net", "dvs_cnn_tcn_nano", "--pool", "2", "--streams", "3",
            "--frames", "3", "--device", "cpu", "--shard"]
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "-slot pool (shard=False)" in out
    assert launch_serve.main(["--fleet", "--pool", "2", "--frames", "3", "--streams", "2",
                              "--device", "cpu", "--shard", "--fleet-nets",
                              "dvs_cnn_tcn_nano,dvs_cnn_tcn_micro"]) == 0


def test_ternary_llm_decode_example():
    """`examples/ternary_llm_decode_torch.py --device cpu` ends with its OK
    line and counts the packed bytes the reference's config gives."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "ternary_llm_decode_torch.py"),
         "--device", "cpu", "--tokens", "4"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ternary_llm_decode OK"
    cfg = ref_config("gemma-2b", smoke=True, quant="ternary_packed")
    params = jax.eval_shape(lambda k: ref_init_params(cfg, k, dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(params)
    packed = sum(int(np.prod(l.shape)) for l in leaves if l.dtype == jnp.uint8)
    dense = sum(int(np.prod(l.shape)) for l in leaves if l.dtype != jnp.uint8)
    m = re.search(r"(\d+) packed-uint8 bytes \(= (\d+) ternary weights\), (\d+) float params",
                  proc.stdout)
    assert m and tuple(map(int, m.groups())) == (packed, 4 * packed, dense), proc.stdout
    assert re.search(r"ms/token on cpu", proc.stdout)
