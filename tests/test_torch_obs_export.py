"""`repro_torch.obs.export` and ``python -m repro_torch.obs`` held against
`repro.obs.export` on the CPU, and the launchers' ``--trace`` /
``--metrics-out`` wiring.

The export is plain Python over the tracer's events and the sim counters,
so for the same tick-clock event sequence and the same programs the two
packages must write **equal** documents (compared as parsed JSON):
`to_chrome`, `layer_timeline` (over a `DeployedProgram` and over a
`LoadedProgram`), `save_chrome`, `trace_summary`, `phase_breakdown` and
`trace_diff`.  Programs are quantized by the port and their tables handed
to the reference as numpy, or shipped as `.cutie` bytes.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import artifact as artifact_j
from repro.api.program import DeployedProgram as DeployedJ
from repro.obs import Tracer as TracerJ
from repro.obs import export as EJ
from repro_torch import api as tapi
from repro_torch import artifact
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import Tracer, load, validate_nesting
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import export as ET

NETS = ["cifar10_tnn_smoke", "dvs_cnn_tcn_smoke"]


def _tables(x, leaf):
    if isinstance(x, dict):
        return {k: _tables(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables(v, leaf) for v in x]
    return leaf(x)


def _calib(graph):
    g = torch.Generator().manual_seed(2)
    h, w = graph.input_hw
    if graph.is_temporal:
        return (torch.rand((2, 3, h, w, graph.input_ch), generator=g) < 0.05).float()
    return torch.randint(-1, 2, (2, h, w, graph.input_ch), generator=g).float()


@pytest.fixture(scope="module")
def programs():
    """{net: (reference DeployedProgram, port DeployedProgram)} over the
    port's calibrated tables."""
    out = {}
    for name in NETS:
        prog = tapi.get_net(name)
        dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu"),
                            calib=_calib(prog.graph))
        tables = _tables(dep.tables, lambda v: jnp.asarray(v.numpy())
                         if isinstance(v, torch.Tensor) else v)
        out[name] = (DeployedJ(japi.get_graph(name), tables), dep)
    return out


def _drive(tr, lanes=("dvs_a", "kws_b"), ticks=3, extra=False):
    """A tick-clock scenario: per lane, tick spans holding the tick phases,
    park/wake instants, occupancy counters; one untracked span."""
    for t in range(ticks):
        for lane in lanes:
            with tr.span("tick", track=lane, tick=t):
                with tr.span("gate.scan", track=lane):
                    pass
                with tr.span("admit", track=lane, admitted=t % 2):
                    pass
                with tr.span("assemble", track=lane):
                    pass
                with tr.span("step", track=lane, pool=4):
                    with tr.span("pool.step", track=lane):
                        pass
                if t == 1:
                    tr.instant("park", track=lane, stream=f"{lane}/s0")
            tr.counter("occupancy", 0.25 * (t + 1), track=lane)
    with tr.span("feeder.fill", streams=2):
        pass
    if extra:
        tr.instant("scale", track=lanes[0], from_size=1, to_size=2)
    tr.counter("multi", {"a": 1, "b": 2})
    return tr


def _same(a, b):
    assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))


def test_to_chrome_summary_and_phases_equal_reference():
    meta = {"scenario": "unit"}
    doc = ET.to_chrome(_drive(Tracer(clock="tick")), meta=meta)
    doc_j = EJ.to_chrome(_drive(TracerJ(clock="tick")), meta=meta)
    _same(doc, doc_j)
    assert ET.validate_nesting(doc) == [] and ET.trace_summary(doc)["ok"]
    _same(ET.trace_summary(doc), EJ.trace_summary(doc_j))
    _same(ET.phase_breakdown(doc), EJ.phase_breakdown(doc_j))
    assert set(ET.phase_breakdown(doc)) == {"dvs_a", "kws_b"}
    assert ET.TICK_PHASES == EJ.TICK_PHASES


def test_trace_diff_equals_reference():
    a = ET.to_chrome(_drive(Tracer(clock="tick")))
    b = ET.to_chrome(_drive(Tracer(clock="tick"), ticks=4, extra=True))
    d = ET.trace_diff(a, b)
    _same(d, EJ.trace_diff(a, b))
    assert not d["identical_shape"] and d["span_count_delta"]["tick"] == {"a": 6, "b": 8}
    assert ET.trace_diff(a, a)["identical_shape"]


def test_validate_nesting_flags_partial_overlap_as_reference():
    doc = {"traceEvents": [
        {"ph": "X", "name": "outer", "pid": 1, "tid": 0, "ts": 0, "dur": 10},
        {"ph": "X", "name": "inner", "pid": 1, "tid": 0, "ts": 2, "dur": 3},
        {"ph": "X", "name": "bad", "pid": 1, "tid": 0, "ts": 8, "dur": 5},
        {"ph": "X", "name": "other_lane", "pid": 1, "tid": 1, "ts": 8, "dur": 5},
    ]}
    problems = ET.validate_nesting(doc)
    assert problems == EJ.validate_nesting(doc) and len(problems) == 1
    assert "'bad'" in problems[0]
    assert not ET.trace_summary(doc)["ok"] and not ET.trace_summary({"traceEvents": []})["ok"]


@pytest.mark.parametrize("name", NETS)
def test_layer_timeline_of_a_deployed_program_equals_reference(programs, name):
    ref, port = programs[name]
    got = ET.layer_timeline(port, name=name, pid=ET.SIM_PID + 3)
    _same(got, EJ.layer_timeline(ref, name=name, pid=EJ.SIM_PID + 3))
    spans = [e for e in got if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 1 for e in spans)


def test_layer_timeline_of_a_loaded_program_equals_reference(programs):
    """The graph-free path: the same `.cutie` bytes loaded by each package
    give equal timelines (plan and packed images read from the file)."""
    data = artifact.assemble(programs["dvs_cnn_tcn_smoke"][1])
    got = ET.layer_timeline(artifact.loads(data, device="cpu"))
    _same(got, EJ.layer_timeline(artifact_j.loads(data)))


def test_save_chrome_and_load_equal_reference(programs, tmp_path):
    sims = {n: programs[n][1] for n in NETS}
    sims_j = {n: programs[n][0] for n in NETS}
    meta = {"scenario": "unit", "backend": "fused"}
    doc = ET.save_chrome(str(tmp_path / "p.json"), _drive(Tracer(clock="tick")),
                         sim_programs=sims, meta=meta)
    doc_j = EJ.save_chrome(str(tmp_path / "j.json"), _drive(TracerJ(clock="tick")),
                           sim_programs=sims_j, meta=meta)
    _same(doc, doc_j)
    assert load(str(tmp_path / "p.json")) == EJ.load(str(tmp_path / "j.json"))
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="not a Chrome trace"):
        load(str(tmp_path / "bad.json"))


def test_obs_cli_exit_codes(tmp_path, capsys):
    good = tmp_path / "good.json"
    ET.save_chrome(str(good), _drive(Tracer(clock="tick")))
    other = tmp_path / "other.json"
    ET.save_chrome(str(other), _drive(Tracer(clock="tick"), ticks=2))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": 0, "dur": 10},
        {"ph": "X", "name": "b", "pid": 1, "tid": 0, "ts": 5, "dur": 10}]}))
    assert obs_cli.main(["summarize", str(good), "--json"]) == 0
    assert obs_cli.main(["summarize", str(empty)]) == 1
    assert obs_cli.main(["summarize", str(bad)]) == 1
    assert obs_cli.main(["diff", str(good), str(good), "--strict"]) == 0
    assert obs_cli.main(["diff", str(good), str(other)]) == 0
    assert obs_cli.main(["diff", str(good), str(other), "--strict"]) == 1
    out = tmp_path / "with_sim.json"
    assert obs_cli.main(["export", str(good), "-o", str(out), "--net",
                         "cifar10_tnn_smoke", "--device", "cpu"]) == 0
    doc = load(str(out))
    assert {e["pid"] for e in doc["traceEvents"]} >= {1, ET.SIM_PID + 50}
    assert validate_nesting(doc) == []
    assert "ok: spans balanced" in capsys.readouterr().out


def test_serve_fleet_trace_and_metrics_out(tmp_path):
    """``launch.serve --fleet --trace --metrics-out``: the trace nests, holds
    the tick spans and one sim track per net; the ``.prom`` snapshot is the
    registry's rendering with the rebuild audit beside the series."""
    trace, prom = tmp_path / "fleet.json", tmp_path / "fleet.prom"
    rc = launch_serve.main(["--fleet", "--pool", "2", "--frames", "3", "--streams", "2",
                            "--device", "cpu", "--trace", str(trace),
                            "--metrics-out", str(prom)])
    assert rc == 0
    doc = load(str(trace))
    assert validate_nesting(doc) == []
    summary = ET.trace_summary(doc)
    assert summary["ok"] and summary["spans"]["tick"] > 0
    assert set(summary["phase_breakdown"]) == {
        "dvs_cnn_tcn_smoke", "dvs_cnn_tcn_micro", "dvs_cnn_tcn_nano"}
    assert len({e["pid"] for e in doc["traceEvents"] if e["pid"] >= ET.SIM_PID}) == 3
    text = prom.read_text()
    assert "# TYPE cutie_trace_count gauge" in text
    assert 'cutie_frames_processed_total{net="dvs_cnn_tcn_nano"} 6' in text


def test_serve_dvs_trace_on_the_tick_clock(tmp_path):
    trace = tmp_path / "dvs.json"
    rc = launch_serve.main(["--dvs", "--net", "dvs_cnn_tcn_smoke", "--pool", "2",
                            "--streams", "3", "--frames", "2", "--device", "cpu",
                            "--trace", str(trace), "--trace-clock", "tick"])
    assert rc == 0
    doc = load(str(trace))
    assert doc["otherData"]["clock"] == "tick" and validate_nesting(doc) == []
    assert ET.phase_breakdown(doc)["dvs_cnn_tcn_smoke"]["ticks"] > 0
