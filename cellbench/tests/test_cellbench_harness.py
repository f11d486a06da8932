"""CPU tests of the benchmark harness (``python -m pytest cellbench/tests``).

They hold the yardstick to hand arithmetic, the generators to their seed,
the plain reference to the port at the registry's smoke nets, every name in
``BENCHMARK.json`` to its file, and drive whole runs of small cells on the
CPU (the port's plain kernels), traced and untraced.
"""
from __future__ import annotations

import ast
import hashlib
import importlib.util
import json
from collections import Counter
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cellbench import bench, check, guard, traffic, yardstick  # noqa: E402
from cellbench.reference import cutie  # noqa: E402
from cellbench.spec import Cell, Spec, load_json, load_module  # noqa: E402

stream_pool = load_module("systems", "stream_pool")
DATA = HERE / "data"
SMOKE = {"dvs_cnn_tcn_smoke": "closed_small", "kws_tcn_smoke": "gated_small"}


def fixture(kind: str, name: str):
    """``data/<kind>/<name>.py``, a module that a test copies beside the harness."""
    spec = importlib.util.spec_from_file_location(f"fixture_{kind}_{name}",
                                                  DATA / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_cell(config: str, mix: str, name: str = "smoke") -> Cell:
    """A small cell on the CPU that reports every metric the harness has a reader for."""
    bench_spec = load_json(ROOT / "BENCHMARK.json")
    per_layer = bench_spec["per_layer"] + [{"name": "gate_ms", "unit": "ms"}]
    return Cell(name, load_json(DATA / f"{config}.json"), load_json(DATA / f"{mix}.json"), 1,
                bench_spec["end_to_end"], per_layer)


# -- the yardstick -------------------------------------------------------------------

def test_operations_per_frame_match_hand_arithmetic():
    dvs = load_json(ROOT / "cellbench/configs/dvs_cnn_tcn.json")
    kws = load_json(ROOT / "cellbench/configs/kws_tcn.json")
    mac = lambda h, w, k, ci, co: h * w * k * k * ci * co  # noqa: E731
    dvs_mac = (mac(64, 64, 3, 2, 64) + mac(32, 32, 3, 64, 64) + mac(16, 16, 3, 64, 96)
               + mac(8, 8, 3, 96, 96) + mac(4, 4, 3, 96, 96) + 4 * 24 * 3 * 96 * 96 + 96 * 12)
    # strided layers count their strided output once: 16x16 and 8x8, not 32x32 and 16x16
    kws_mac = (mac(16, 16, 3, 1, 64) + mac(16, 16, 1, 64, 64) + mac(8, 8, 3, 64, 96)
               + mac(8, 8, 1, 96, 96) + 3 * 16 * 3 * 96 * 96 + 96 * 12)
    assert yardstick.ops_per_frame(dvs) == 2 * dvs_mac
    assert yardstick.ops_per_frame(kws) == 2 * kws_mac
    assert round(dvs_mac / 1e6, 1) == 65.9 and round(kws_mac / 1e6, 1) == 6.7
    conv2 = yardstick.layers(dvs, 1)[1]
    assert conv2.ops / yardstick.ops_per_frame(dvs) == pytest.approx(0.573, abs=1e-3)


# per weight layer (kind, operations a frame, bytes at the batch), as the
# yardstick priced them before it took nets without a ring
LAYERS = {
    ("dvs_cnn_tcn", 64): [
        ("conv2d", 9437184, 6292256), ("conv2d", 75497472, 5252608),
        ("conv2d", 28311552, 1456384), ("conv2d", 10616832, 513024),
        ("conv2d", 2654208, 144384), ("tcn", 1327104, 744960), ("tcn", 1327104, 302592),
        ("tcn", 1327104, 302592), ("tcn", 1327104, 302592), ("fc", 2304, 9552)],
    ("kws_tcn", 8): [
        ("conv2d", 294912, 164496), ("conv2d", 2097152, 263680), ("conv2d", 7077888, 194816),
        ("conv2d", 1179648, 101376), ("tcn", 884736, 69120), ("tcn", 884736, 32256),
        ("tcn", 884736, 32256), ("fc", 2304, 1488)],
}


@pytest.mark.parametrize("config, batch", sorted(LAYERS))
def test_the_layers_of_the_cells_configurations_are_priced_as_before(config, batch):
    cfg = load_json(ROOT / f"cellbench/configs/{config}.json")
    got = [(layer.kind, layer.ops, layer.bytes) for layer in yardstick.layers(cfg, batch)]
    assert got == LAYERS[config, batch]
    assert all(layer.batch == batch for layer in yardstick.layers(cfg, batch))


def test_a_spatial_classifier_is_priced_without_a_ring():
    cfg = load_json(DATA / "cifar10_tnn.json")
    assert "tcn_steps" not in cfg
    mac = lambda h, k, ci, co: h * h * k * k * ci * co  # noqa: E731
    # 2 convs at 32x32, 3 at 16x16, 3 at 8x8, the classifier over 4x4x96 trits
    want = (mac(32, 3, 3, 96) + mac(32, 3, 96, 96) + 3 * mac(16, 3, 96, 96)
            + 3 * mac(8, 3, 96, 96) + 4 * 4 * 96 * 10)
    assert want == 167_230_464 and 4 * 4 * 96 * 10 == 15_360
    assert yardstick.ops_per_frame(cfg) == 2 * 167_230_464
    fc = yardstick.layers(cfg, 256)[-1]
    # int8 trits in after the flatten, 2-bit weights, float32 scale, float32 logits out
    assert fc.kind == "fc" and fc.bytes == 256 * 1536 * 1 + 1536 * 10 / 4 + 4 * 10 + 256 * 10 * 4
    assert yardstick.k1_bound_s(cfg, 256) > 0


def test_the_bound_is_the_larger_of_operations_and_bytes():
    kws = load_json(ROOT / "cellbench/configs/kws_tcn.json")
    for layer in yardstick.layers(kws, 64):
        t_ops = layer.ops * 64 / yardstick.PEAK_OPS
        t_bytes = layer.bytes / yardstick.PEAK_BYTES
        assert layer.bound_s == max(t_ops, t_bytes) > 0
    stem = yardstick.layers(kws, 64)[0]
    # float32 frames read once, 2-bit weights, scale and threshold, int8 strided output
    assert stem.bytes == 64 * 32 * 32 * 1 * 4 + 9 * 64 / 4 + 8 * 64 + 64 * 16 * 16 * 64


# -- the generators ----------------------------------------------------------------------

def test_the_generators_repeat_from_a_seed_and_keep_the_work_across_seeds():
    mix = load_json(DATA / "gated_small.json")
    a = traffic.lengths(mix["length"], 500, traffic.rng(2**31 + 5, "x"))
    b = traffic.lengths(mix["length"], 500, traffic.rng(2**31 + 5, "x"))
    c = traffic.lengths(mix["length"], 500, traffic.rng(7, "x"))
    assert (a == b).all() and not (a == c).all()
    assert sorted(a) == sorted(c)  # the same work in another order
    g1 = traffic.gaps(100.0, 400, traffic.rng(1, "g"))
    g2 = traffic.gaps(100.0, 400, traffic.rng(2, "g"))
    assert np.allclose(sorted(g1), sorted(g2)) and abs(g1.mean() - 0.01) < 0.001
    m = traffic.activity_mask({"duty": 0.25, "mean_on_run": 8}, 16, 256, traffic.rng(3, "a"))
    assert (m == traffic.activity_mask({"duty": 0.25, "mean_on_run": 8}, 16, 256,
                                       traffic.rng(3, "a"))).all()
    assert 0.18 < m.mean() < 0.32


@pytest.mark.parametrize("config", sorted(SMOKE))
def test_the_frame_bank_repeats_from_a_seed(config):
    cfg, mix = load_json(DATA / f"{config}.json"), load_json(DATA / f"{SMOKE[config]}.json")
    source = load_module("sources", cfg["frames"])
    one = traffic.make_bank(source, cfg, mix, 12345678901, "cpu")
    two = traffic.make_bank(source, cfg, mix, 12345678901, "cpu")
    other = traffic.make_bank(source, cfg, mix, 5, "cpu")
    assert (one.frames == two.frames).all() and not (one.frames == other.frames).all()
    want = (mix["bank"], mix["length"]["max"], *cfg["input_hw"], cfg["input_ch"])
    assert one.frames.shape == want
    events = np.count_nonzero(one.content.reshape(*one.content.shape[:2], -1), axis=2)
    assert (events > 0).all()  # every frame of the content carries events


# -- the reference against the port ---------------------------------------------------------

@pytest.mark.parametrize("config", sorted(SMOKE))
def test_the_reference_equals_the_port_bit_for_bit(config):
    from repro_torch.api.program import CutieProgram
    from repro_torch.api.registry import get_graph

    cfg = load_json(DATA / f"{config}.json")
    params = bench.make_params(cfg, 99, torch.device("cpu"))
    bank, calib = bench.make_frames(smoke_cell(config, SMOKE[config]), 99, torch.device("cpu"))
    graph = get_graph(cfg["registry"])
    check.check_graph(graph, cfg)
    deployed = CutieProgram(graph).quantize(params, calib=calib)
    tables = cutie.derive(cfg, params, calib)
    port = deployed._constants()
    for kind in ("conv", "tcn"):
        for mine, (eff, thr) in zip(tables[kind], port[kind]):
            assert torch.equal(mine["eff"], eff)
    frames = torch.from_numpy(bank.frames[0, :cfg["tcn_steps"] + 3].copy())
    session = deployed.stream(backend="fused")
    for t in range(len(frames)):
        got = session.step(frames[t])[0]
        window = frames[max(0, t + 1 - cfg["tcn_steps"]):t + 1]
        want = stream_pool.reference_logits(cfg, tables, [window.numpy()], "cpu")[0]
        assert np.array_equal(got.numpy(), want), t


def test_the_reference_classifier_equals_the_port_bit_for_bit():
    from repro_torch.api.program import CutieProgram
    from repro_torch.api.registry import get_graph

    cfg, mix = load_json(DATA / "cifar10_tnn_smoke.json"), load_json(DATA / "batch_small.json")
    params = bench.make_params(cfg, 99, torch.device("cpu"))
    bank = traffic.make_bank(fixture("sources", cfg["frames"]), cfg, mix, 99, "cpu")
    calib = torch.from_numpy(traffic.calibration(bank, cfg))
    assert calib.shape == (cfg["calib_frames"], *cfg["input_hw"], cfg["input_ch"])
    graph = get_graph(cfg["registry"])
    check.check_graph(graph, cfg)
    deployed = CutieProgram(graph).quantize(params, calib=calib)
    tables = cutie.derive(cfg, params, calib)
    for mine, (eff, thr) in zip(tables["conv"], deployed._constants()["conv"]):
        assert torch.equal(mine["eff"], eff)
    assert len(tables["conv"]) == 8 and tables["tcn"] == []
    x = torch.from_numpy(bank.frames.reshape(-1, *bank.frames.shape[2:]).copy())
    got = deployed.forward(x, backend="fused")
    want = cutie.spatial(cfg, tables, x)
    assert got.shape == (len(x), cfg["n_classes"]) and torch.equal(got, want)
    assert not torch.equal(cutie.spatial(cfg, tables, x, "bf16"), want)


def test_the_check_counts_every_answer_and_samples_the_probed_clips():
    frames = np.ones((30, 2, 2, 1), np.float32)
    good = check.Answer(frames, np.zeros(3), 30)
    short = check.Answer(frames, np.zeros(3), 24)   # stepped only its last 24
    blank = check.Answer(frames, None, 30)          # stepped, but no logits
    assert check.count([good, short, blank], [30, 30, 30]) == {"mismatch": 2, "wrong": {1, 2}}
    assert check.count([good, short, blank], [30, 24, 0]) == {"mismatch": 1, "wrong": {2}}
    lengths, probed = list(range(1000)), [i % 2 == 0 for i in range(1000)]
    picked = check.sample(lengths, probed, 2**31 + 9)
    assert picked == check.sample(lengths, probed, 2**31 + 9)
    assert len(picked) == check.SAMPLE and 999 in picked  # the longest, not probed
    assert sum(probed[i] for i in picked) == check.SAMPLE - 1


def test_probes_keep_an_early_step_and_one_anywhere_for_one_clip_in_four():
    probes = stream_pool.Probes(2**31 + 7, 8, 3, "cpu")
    clips = [traffic.Clip(idx=i, length=20, seq=0, off=0) for i in range(800)]
    for c in clips:
        probes.choose(c)
    assert 150 < len(probes.want) < 250
    for want in probes.want.values():
        assert min(want) < 8 and max(want) < 20
    sid, want = next(iter(probes.want.items()))
    steps, rows = Counter(), dict(want)
    for step in range(20):
        steps[sid] += 1
        probes.see({sid: torch.full((3,), float(step))}, steps)
    kept = [(s, float(lg[0])) for s, lg in probes.read()[sid]]
    assert kept == [(s, float(s)) for s in sorted(rows)]
    assert sid not in probes.want


def test_the_gate_plan_matches_the_port():
    from repro_torch.serving import ActivityGate

    rng = np.random.default_rng(0)
    for _ in range(50):
        acts = rng.choice([0, 2, 5, 20, 40], size=60).tolist()
        assert cutie.gate_plan(acts, 16, 4, 2) == ActivityGate(16, 4, 2).plan(acts)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "cellbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"repro", "repro_torch", "jax", "jaxlib", "flax",
                                               "cellbench"}, (path, n)


# -- names and files -----------------------------------------------------------------------

def test_every_name_in_the_benchmark_resolves_to_its_file():
    spec = Spec.load(ROOT)
    assert spec.resolve_all() and all(v is None for v in spec.resolve_all().values())
    names = {w["name"] for w in spec.bench["workloads"]}
    assert names == {"dvs_pool64_closed", "dvs_pool8_open"}
    for m in spec.bench["per_layer"]:
        for w in m.get("workloads", []):
            cell = spec.cell(w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("system, error", [
    ("no_such_system", "FileNotFoundError: systems 'no_such_system': no file "
                       "cellbench/systems/no_such_system.py"),
    ("no such/system", "ValueError: not a valid name: 'no such/system'")],
    ids=["no_file", "not_a_name"])
def test_a_configuration_naming_an_unknown_system_is_reported(system, error, tmp_path):
    bench_spec = load_json(ROOT / "BENCHMARK.json")
    cfg = dict(load_json(ROOT / "cellbench/configs/dvs_cnn_tcn.json"), name="dvs_renamed")
    cfg["system"] = system
    (tmp_path / "dvs_renamed.json").write_text(json.dumps(cfg))
    bench_spec["configs"].append(dict(bench_spec["configs"][0], name="dvs_renamed",
                                      file=str(tmp_path / "dvs_renamed.json")))
    bench_spec["workloads"].append(dict(bench_spec["workloads"][0], name="renamed",
                                        config="dvs_renamed"))
    resolved = Spec(bench_spec, ROOT).resolve_all()
    assert resolved["workload renamed"] == error
    assert all(v is None for k, v in resolved.items() if k != "workload renamed")


def test_a_new_cell_config_mix_and_metric_need_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = load_json(ROOT / "BENCHMARK.json")
    shutil.copy(DATA / "kws_tcn_smoke.json", root / "cellbench/configs/kws_tcn_smoke.json")
    shutil.copy(DATA / "gated_small.json", root / "cellbench/traffic/gated_small.json")
    (root / "cellbench/metrics/zz_parked_share.py").write_text(
        "def read(run):\n    return None\n")
    spec["configs"].append({"name": "kws_tcn_smoke", "source": "x", "reduced": [], "why": "x",
                            "file": "cellbench/configs/kws_tcn_smoke.json"})
    spec["workloads"].append({"name": "kws_smoke_gated", "config": "kws_tcn_smoke",
                              "traffic": "gated_small", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "zz_parked_share", "unit": "%", "better": "lower",
                              "source": "program_span", "layer": "gate",
                              "moves": "clip_latency_ms_p95", "workloads": ["kws_smoke_gated"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from cellbench.spec import Spec; s = Spec.load(sys.argv[1]); "
            "print(json.dumps([s.resolve_all(), [m['name'] for m in "
            "s.cell('kws_smoke_gated').per_layer]]))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    resolved, metrics = json.loads(out.stdout)
    assert all(v is None for v in resolved.values()) and "workload kws_smoke_gated" in resolved
    assert "zz_parked_share" in metrics and "gate_ms" not in metrics


def hashes(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


NEW_SYSTEM = {  # copied beside the harness: (file in the copy, file of data/)
    "systems/fixture_batch.py": "systems/fixture_batch.py",
    "sources/images8.py": "sources/images8.py",
    "configs/cifar10_tnn_smoke.json": "cifar10_tnn_smoke.json",
    "traffic/batch_small.json": "batch_small.json",
}
RUN_NEW_SYSTEM = """
import json, sys
root, src = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, src]
from cellbench import bench, control
from cellbench.spec import Spec
spec = Spec.load(root)
cell = spec.cell("cifar_smoke_batch")
out = {"resolved": spec.resolve_all(), "control": control.readings(cell, 2**31 + 29, "cpu", n=16)}
keep = ("correct", "failed", "attempted", "metrics", "checks")
for trace in (0, 1):
    result, _ = bench.run_cell(cell, 2**31 + 29, 1.0, bool(trace), device="cpu")
    out[trace] = dict({k: result[k] for k in keep}, compared=result["info"]["compared"])
from repro_torch.api.program import DeployedProgram
forward = DeployedProgram.forward
def altered(self, x, backend="fused"):  # one image's logits moved by a tenth
    y = forward(self, x, backend).clone()
    y[0, 0] += 0.1 * float(y[0].abs().max().clamp(min=1e-3))
    return y
DeployedProgram.forward = altered
result, _ = bench.run_cell(cell, 2**31 + 29, 1.0, False, device="cpu")
out["fault"] = {k: result[k] for k in keep}
print(json.dumps(out))
"""


def test_a_new_system_serves_a_spatial_net_through_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = hashes(root / "cellbench")
    assert before == {k: v for k, v in hashes(ROOT / "cellbench").items()
                      if not k.startswith("tests/")}
    for dst, src in NEW_SYSTEM.items():
        assert not (root / "cellbench" / dst).exists()
        shutil.copy(DATA / src, root / "cellbench" / dst)
    spec = load_json(ROOT / "BENCHMARK.json")
    spec["configs"].append({"name": "cifar10_tnn_smoke", "source": "x", "reduced": [], "why": "x",
                            "file": "cellbench/configs/cifar10_tnn_smoke.json"})
    spec["workloads"].append({"name": "cifar_smoke_batch", "config": "cifar10_tnn_smoke",
                              "traffic": "batch_small", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("frames_per_s", "step_mfu", "device_idle_pct", "k1_roofline"):
            m["workloads"].append("cifar_smoke_batch")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", RUN_NEW_SYSTEM, str(root), str(ROOT / "src")],
                         capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert all(v is None for v in got["resolved"].values()), got["resolved"]
    for trace, names in (("0", {"setup_s", "frames_per_s"}), ("1", {"step_mfu"})):
        run = got[trace]
        assert run["correct"] and run["failed"] == 0 and run["attempted"] > 0, run
        assert run["checks"]["logit_gap"]["value"] == 0.0 and run["compared"] > 0
        assert names <= set(run["metrics"]), run["metrics"]
    assert not got["fault"]["correct"], got["fault"]
    assert got["fault"]["checks"]["logit_gap"]["value"] > 0.05
    assert got["control"]["logit_gap"]["value"] > got["control"]["logit_gap"]["limit"]
    # nothing that the copy held before was touched
    after = hashes(root / "cellbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == set(NEW_SYSTEM)


def test_the_jax_check_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro", "repro.core.ternary", "repro_torch",
                                    "repro_torch.api", "jax", "jaxlib.xla_client", "flax",
                                    "jaxtyping", "numpy"]) == [
        "flax", "jax", "jaxlib.xla_client", "repro", "repro.core.ternary"]


def test_the_harness_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    run = [sys.executable, "cellbench/run.py", "--workload", "dvs_pool64_closed",
           "--seed", "3000000019", "--seconds", "10", "--trace", "0"]
    out = subprocess.run(run, capture_output=True, text=True, cwd=ROOT)
    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "cellbench", bare / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    out = subprocess.run(run, capture_output=True, text=True, cwd=bare)
    assert out.returncode != 0 and out.stdout == ""


# -- whole runs on the CPU -----------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(SMOKE))
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_cpu_is_correct_and_reports_its_metrics(config, trace):
    cell = smoke_cell(config, SMOKE[config])
    result, lines = bench.run_cell(cell, 2**31 + 11, 1.0, trace, device="cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks" and set(result["checks"]) == {
        "logit_gap", "frames_mismatch", "missing"}
    assert len(lines) == 3 and lines[0].startswith("check logit_gap")
    names = set(result["metrics"])
    if not trace:
        assert {"setup_s", "frames_per_s", "clip_latency_ms_p95"} <= names
    else:
        assert {"pool_step_host_ms", "sched_host_ms", "queue_wait_ms_p50"} <= names
        assert ("gate_ms" in names) == (cell.traffic["gate"] is not None)
        assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_a_limit_whose_number_the_system_did_not_give_fails_the_run(monkeypatch):
    assert check.judge({"logit_gap": 0.0, "wrong": 0}, {"logit_gap": 1e-4, "missing": 0}) == {
        "logit_gap": {"value": 0.0, "limit": 1e-4}, "missing": {"value": None, "limit": 0}}
    assert not check.passed(check.judge({"logit_gap": 0.0}, {"logit_gap": 1e-4, "missing": 0}))
    compare = stream_pool.compare

    def forgetful(*args):  # a system whose comparison leaves out one limited number
        numbers, info = compare(*args)
        del numbers["logit_gap"]
        return numbers, info

    monkeypatch.setattr(stream_pool, "compare", forgetful)
    result, lines = bench.run_cell(smoke_cell("dvs_cnn_tcn_smoke", "closed_small"), 2**31 + 11,
                                   1.0, False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] is None
    assert result["checks"]["frames_mismatch"]["value"] == 0.0
    assert lines[0] == "check logit_gap: None (limit 0.0001)"
