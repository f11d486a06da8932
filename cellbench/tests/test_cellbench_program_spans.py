"""CPU tests of the readers of the program's own spans and request clock
(``python -m pytest cellbench/tests``): ``upload_host_ms``,
``advance_host_ms``, ``flush_host_ms``, ``replay_device_ms`` and
``admit_wait_ms_p50``.  Each is held to hand arithmetic on a made-up run
record, reads nothing (None) where a program lacks what it reads, and
reports on a traced run of a small cell on the CPU — all but
``replay_device_ms``, whose device spans exist only on a card.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cellbench import bench, traffic  # noqa: E402
from cellbench.spec import Cell, load_json, load_module  # noqa: E402

DATA = HERE / "data"
READERS = ("upload_host_ms", "advance_host_ms", "flush_host_ms", "replay_device_ms",
           "admit_wait_ms_p50")


def new_metrics():
    spec = load_json(ROOT / "BENCHMARK.json")
    return [m for m in spec["per_layer"] if m["name"] in READERS]


def record(spans, clips=(), tick_base=0):
    cell = Cell("made_up", {}, {}, 1, [], [])
    return bench.RunRecord(cell=cell, setup_s=1.0, window_s=1.0, frames=0, ticks=4,
                           step_ticks=4, batch=4, clips=list(clips), tick_walls=[0.0] * 8,
                           tick_base=tick_base, spans=spans, profile=None)


def clip(admitted_tick, submitted_ns, admitted_ns):
    result = types.SimpleNamespace(admitted_tick=admitted_tick, submitted_ns=submitted_ns,
                                   admitted_ns=admitted_ns)
    return bench.ClipRecord(traffic.Clip(idx=0, length=4, seq=0, off=0), 0.0, 0.0,
                            result=result)


SPANS = {
    "step": [(0.0, 0.004), (1.0, 0.002), (2.0, 0.003), (3.0, 0.003)],
    "pool.upload": [(0.0, 0.001), (1.0, 0.0005), (2.0, 0.0005), (3.0, 0.002)],
    "advance": [(0.0, 0.0002), (1.0, 0.0004), (2.0, 0.0003), (3.0, 0.0003)],
    "flush": [(1.0, 0.0006), (3.0, 0.001)],
    "dev.replay": [(0.0, 0.0001), (1.0, 0.0002), (2.0, 0.00015), (3.0, 0.00015)],
}
WANT = {"upload_host_ms": 1.0, "advance_host_ms": 0.3, "flush_host_ms": 0.4,
        "replay_device_ms": 0.15}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_span_reader_is_its_hand_arithmetic(name):
    read = load_module("metrics", name).read
    assert read(record(SPANS)) == pytest.approx(WANT[name])
    # a program without the span (the parent, or the CPU for device spans)
    missing = "flush" if name == "flush_host_ms" else {
        "upload_host_ms": "pool.upload", "advance_host_ms": "advance",
        "replay_device_ms": "dev.replay"}[name]
    assert read(record({k: v for k, v in SPANS.items() if k != missing})) is None
    assert read(record({})) is None


def test_the_admission_wait_reads_the_program_s_own_stamps():
    read = load_module("metrics", "admit_wait_ms_p50").read
    clips = [clip(5, 1_000_000, 1_500_000), clip(6, 2_000_000, 4_000_000),
             clip(7, 3_000_000, 3_100_000),
             clip(1, 0, 90_000_000),      # admitted before the window: left out
             clip(-1, 4_000_000, 0)]      # never admitted: left out
    assert read(record({}, clips, tick_base=2)) == pytest.approx(0.5)
    # results without the stamps (a program that does not record them)
    bare = [bench.ClipRecord(c.clip, 0.0, 0.0, result=types.SimpleNamespace(admitted_tick=5))
            for c in clips]
    assert read(record({}, bare, tick_base=2)) is None


def test_a_traced_run_on_the_cpu_reports_the_program_s_spans():
    spec = load_json(ROOT / "BENCHMARK.json")
    per_layer = new_metrics() + [m for m in spec["per_layer"] if m["name"] == "pool_step_host_ms"]
    cell = Cell("smoke", load_json(DATA / "dvs_cnn_tcn_smoke.json"),
                load_json(DATA / "closed_small.json"), 1, spec["end_to_end"], per_layer)
    result, _ = bench.run_cell(cell, 2**31 + 23, 1.0, True, device="cpu")
    assert result["correct"]
    got = result["metrics"]
    assert set(got) == {"upload_host_ms", "advance_host_ms", "flush_host_ms",
                        "admit_wait_ms_p50", "pool_step_host_ms"}
    assert 0 < got["upload_host_ms"]["value"] < got["pool_step_host_ms"]["value"]
    assert got["advance_host_ms"]["value"] > 0 and got["flush_host_ms"]["value"] > 0
    assert got["admit_wait_ms_p50"]["value"] >= 0
    assert all(v["unit"] == "ms" for v in got.values())


def test_the_new_metrics_are_one_cell_each_and_move_its_end_to_end_metric():
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {m["name"]: (m["workloads"], m["moves"], m["layer"]) for m in new_metrics()}
    assert cells == {
        "upload_host_ms": (["dvs_pool64_closed"], "frames_per_s", "pool"),
        "advance_host_ms": (["dvs_pool64_closed"], "frames_per_s", "scheduler"),
        "flush_host_ms": (["dvs_pool8_open"], "clip_latency_ms_p95", "scheduler"),
        "replay_device_ms": (["dvs_pool8_open"], "clip_latency_ms_p95", "device"),
        "admit_wait_ms_p50": (["dvs_pool8_open"], "clip_latency_ms_p95", "scheduler"),
    }
    assert [m["name"] for m in spec["per_layer"][-5:]] == list(READERS)
