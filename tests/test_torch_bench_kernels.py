"""`benchmarks/kernel_bench_torch.py` on the CPU: its smoke run exits 0, its
rows are the reference's ``BENCH_kernels.smoke.json`` rows with
``pallas_interp_us`` renamed ``plain_us`` and the dense yardstick's two
cuDNN settings added, and the reference's unchanged
``scripts/check_bench_regression.py --kernels`` gates them."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import kernel_bench_torch as kb  # noqa: E402

REF = json.loads((ROOT / "BENCH_kernels.smoke.json").read_text())
CHECKER = ROOT / "scripts" / "check_bench_regression.py"
META_RENAMES = ({"jax_backend", "jax_version"}, {"device", "torch_version"})


def _check(*args) -> int:
    return subprocess.run([sys.executable, str(CHECKER), *map(str, args)],
                          capture_output=True, text=True, timeout=120).returncode


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("kbench") / "BENCH_kernels_torch.smoke.json"
    rc = kb.main(["--smoke", "--device", "cpu", "--repeats", "1", "--out", str(out)])
    return rc, out, json.loads(out.read_text())


def test_smoke_run_exits_0_with_every_cell_bit_exact(smoke):
    rc, _, payload = smoke
    assert rc == 0
    assert [r["bit_exact"] for r in payload["results"]] == [True] * 3
    assert all(r["max_err_float"] < 1e-4 for r in payload["results"])
    assert payload["meta"]["device"] == "cpu" and payload["meta"]["smoke"] is True
    assert payload["meta"]["torch_version"] == torch.__version__


def test_rows_have_the_reference_keys_with_the_documented_rename(smoke):
    _, _, payload = smoke
    want = set(REF["results"][0]) - {"pallas_interp_us"} | {
        "plain_us", "dense_autotuned_us", "dense_deterministic_us"}
    for row in payload["results"]:
        assert set(row) == want
    assert set(payload) == set(REF)
    old, new = META_RENAMES
    assert set(payload["meta"]) == set(REF["meta"]) - old | new


def test_dense_is_the_faster_cudnn_setting(smoke):
    _, _, payload = smoke
    for r in payload["results"]:
        assert r["dense_us"] == min(r["dense_autotuned_us"], r["dense_deterministic_us"])
        assert r["speedup_packed_vs_unpacked"] == pytest.approx(r["dense_us"] / r["packed_us"],
                                                                rel=1e-12)


def test_names_and_weight_bytes_equal_the_reference(smoke):
    _, _, payload = smoke
    assert [r["name"] for r in payload["results"]] == [r["name"] for r in REF["results"]]
    for got, want in zip(payload["results"], REF["results"]):
        for key in ("kind", "weight_bytes_dense_bf16", "weight_bytes_packed",
                    "bytes_reduction"):
            assert got[key] == want[key], key


def test_unchanged_checker_accepts_the_port_json_and_refuses_a_flipped_flag(smoke, tmp_path):
    _, out, payload = smoke
    assert _check("--kernels", out, out) == 0
    payload["results"][1]["bit_exact"] = False
    flipped = tmp_path / "flipped.json"
    flipped.write_text(json.dumps(payload))
    assert _check("--kernels", out, flipped) == 1


def test_a_kernel_off_its_oracle_makes_the_bench_exit_1(monkeypatch, tmp_path):
    real = kb.ternary_matmul

    def one_ulp_off(x, wp, sc):
        y = real(x, wp, sc)
        y.view(-1)[0] = torch.nextafter(y.view(-1)[0], torch.tensor(float("inf")))
        return y

    monkeypatch.setattr(kb, "ternary_matmul", one_ulp_off)
    monkeypatch.setattr(kb, "SMOKE_CONVS", [])
    rc = kb.main(["--smoke", "--device", "cpu", "--repeats", "1",
                  "--out", str(tmp_path / "k.json")])
    assert rc == 1
    assert json.loads((tmp_path / "k.json").read_text())["results"][0]["bit_exact"] is False


def test_default_cells_are_the_references():
    assert kb.FULL_MATMULS == [(512, 2048, 512)]
    assert kb.FULL_CONVS == [(1, 32, 96, 96, 0), (4, 32, 96, 96, 0), (1, 32, 96, 96, 2)]
    assert kb.SMOKE_MATMULS == [(128, 512, 128)]
    assert kb.SMOKE_CONVS == [(1, 16, 8, 8, 0), (2, 16, 8, 8, 2)]
