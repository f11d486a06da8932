"""`benchmarks/serving_bench_torch.py` on the CPU: its smoke run (pool 2,
three frames) exits 0, its four cells carry the reference's
``BENCH_serving.smoke.json`` keys, the reference's unchanged checker
(``--serving``) accepts it and refuses any flipped exactness flag, and a
pooled stream other than stream 0 that differs from its lone session fails
the bench (the reference checks stream 0 only)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import serving_bench_torch as sb  # noqa: E402

REF = json.loads((ROOT / "BENCH_serving.smoke.json").read_text())
CHECKER = ROOT / "scripts" / "check_bench_regression.py"
SMOKE = ["--smoke", "--device", "cpu", "--pools", "2", "--frames", "3"]


def _check(*args) -> int:
    return subprocess.run([sys.executable, str(CHECKER), *map(str, args)],
                          capture_output=True, text=True, timeout=120).returncode


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("sbench") / "BENCH_serving_torch.smoke.json"
    rc = sb.main([*SMOKE, "--out", str(out)])
    return rc, out, json.loads(out.read_text())


def test_smoke_run_exits_0_with_every_gate_true(smoke):
    rc, _, p = smoke
    assert rc == 0
    assert [(r["pool_size"], r["backend"]) for r in p["results"]] == [(2, "fused"), (2, "ref")]
    for r in p["results"]:
        assert r["exact_vs_single_session"] and r["trace_count"] == 1
        assert r["streams"] == 4 and r["frames_per_stream"] == 3
    assert p["fleet"]["exact_vs_single_session"] and p["fleet"]["zero_retrace"]
    assert p["fleet"]["completed"] == 3 * 4
    assert p["gated"]["exact_vs_gate_plan"] and p["gated"]["trace_count"] == 1
    assert p["phases"]["exact_vs_untraced"] and p["phases"]["trace_count"] == 1
    assert p["meta"]["device"] == "cpu" and p["schema"] == REF["schema"] == 4


def test_cells_have_the_reference_keys(smoke):
    _, _, p = smoke
    assert set(p) == set(REF)
    for row in p["results"]:
        assert set(row) == set(REF["results"][0])
    for cell in ("fleet", "gated", "phases"):
        assert set(p[cell]) == set(REF[cell]), cell
    for net, per in p["fleet"]["per_net"].items():
        assert set(per) == set(REF["fleet"]["per_net"][next(iter(REF["fleet"]["per_net"]))])
    assert set(p["fleet"]["per_net"]) == set(sb.FLEET_NETS_SMOKE)
    assert set(p["phases"]["phase_fraction"]) == set(REF["phases"]["phase_fraction"])
    assert set(p["meta"]) == (set(REF["meta"]) - {"jax_backend", "jax_version"}
                              | {"device", "torch_version"})


def test_unchanged_checker_accepts_the_port_json(smoke):
    _, out, _ = smoke
    assert _check("--serving", out, out) == 0


@pytest.mark.parametrize("path", [("results", 0, "exact_vs_single_session"),
                                  ("results", 1, "exact_vs_single_session"),
                                  ("fleet", "exact_vs_single_session"),
                                  ("fleet", "zero_retrace"),
                                  ("gated", "exact_vs_gate_plan"),
                                  ("phases", "exact_vs_untraced")],
                         ids=lambda p: "/".join(map(str, p)))
def test_unchanged_checker_refuses_a_flipped_flag(smoke, tmp_path, path):
    _, out, p = smoke
    cell = p
    for key in path[:-1]:
        cell = cell[key]
    cell[path[-1]] = False
    flipped = tmp_path / "flipped.json"
    flipped.write_text(json.dumps(p))
    assert _check("--serving", out, flipped) == 1


def test_a_later_stream_off_its_lone_session_fails_the_bench(monkeypatch, tmp_path):
    real = sb._run_sequential

    def off_by_one_stream(*args):
        wall, finals = real(*args)
        finals[3] = finals[3].copy()
        finals[3][0] += 1.0
        return wall, finals

    monkeypatch.setattr(sb, "_run_sequential", off_by_one_stream)
    out = tmp_path / "s.json"
    rc = sb.main([*SMOKE, "--backends", "fused", "--no-fleet", "--no-gate",
                  "--no-phases", "--out", str(out)])
    assert rc == 1
    assert json.loads(out.read_text())["results"][0]["exact_vs_single_session"] is False


def test_latency_percentiles_come_from_the_synchronised_ticks():
    p = sb._percentiles([0.001, 0.002, 0.003])
    assert p["latency_ms_p50"] == pytest.approx(2.0)
    assert p["latency_ms_p99"] == pytest.approx(2.98)
