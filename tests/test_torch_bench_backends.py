"""`benchmarks/backend_bench_torch.py` on the CPU: its smoke run exits 0 with
every exact backend bit-equal to ``ref``, its rows are the reference's
``BENCH_backends.smoke.json`` rows plus ``captured``, the reference's
unchanged checker reads them, and one backend's logits one ulp off — in
every call, or in the timed calls only (a replay on the card) — make the
bench exit 1."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import backend_bench_torch as bb  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.program import DeployedProgram  # noqa: E402
from repro_torch.capture import CapturedStep  # noqa: E402

REF = json.loads((ROOT / "BENCH_backends.smoke.json").read_text())
CHECKER = ROOT / "scripts" / "check_bench_regression.py"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("bbench") / "BENCH_backends_torch.smoke.json"
    rc = bb.main(["--smoke", "--device", "cpu", "--repeats", "1", "--out", str(out)])
    return rc, out, json.loads(out.read_text())


def test_smoke_run_exits_0_every_backend_equal_to_ref(smoke):
    rc, _, payload = smoke
    assert rc == 0
    rows = payload["results"]
    assert {r["backend"] for r in rows} == set(api.BACKENDS)
    assert all(r["exact_vs_ref"] and r["max_abs_diff_vs_ref"] == 0.0 for r in rows)
    assert not any(r["captured"] for r in rows)  # the CPU runs each forward eagerly
    assert payload["meta"]["device"] == "cpu"


def test_rows_have_the_reference_keys_plus_captured(smoke):
    _, _, payload = smoke
    for row in payload["results"]:
        assert set(row) == set(REF["results"][0]) | {"captured"}
    assert set(payload["meta"]) == (set(REF["meta"]) - {"jax_backend", "jax_version"}
                                    | {"device", "torch_version"})


def test_cells_are_the_references_for_the_ports_backends(smoke):
    _, _, payload = smoke

    def cells(p):
        return {(r["net"], r["workload"], r["batch"]) for r in p["results"]}

    assert cells(payload) == cells(REF)


def test_unchanged_checker_accepts_the_port_json(smoke):
    _, out, _ = smoke
    rc = subprocess.run([sys.executable, str(CHECKER), str(out), str(out)],
                        capture_output=True, text=True, timeout=120).returncode
    assert rc == 0


@pytest.mark.parametrize("backend", ["fused", "kernel", "bitsim"])
def test_one_backend_one_ulp_off_makes_the_bench_exit_1(backend, monkeypatch, tmp_path):
    real = DeployedProgram.forward

    def forward(self, x, backend="fused"):
        y = real(self, x, backend=backend)
        if backend == perturbed:
            y = y.clone()
            y.view(-1)[0] = torch.nextafter(y.view(-1)[0], torch.tensor(float("inf")))
        return y

    perturbed = backend
    monkeypatch.setattr(DeployedProgram, "forward", forward)
    out = tmp_path / "b.json"
    rc = bb.main(["--smoke", "--device", "cpu", "--repeats", "1",
                  "--nets", "cifar10_tnn_smoke", "--out", str(out)])
    assert rc == 1
    rows = {r["backend"]: r for r in json.loads(out.read_text())["results"]}
    assert not rows[backend]["exact_vs_ref"]
    assert rows[backend]["allclose_vs_ref"]  # only the stricter gate trips
    assert all(rows[b]["exact_vs_ref"] for b in api.BACKENDS if b != backend)


@pytest.mark.parametrize("backend", list(api.BACKENDS))
def test_a_timed_call_one_ulp_off_its_warm_up_makes_the_bench_exit_1(backend, monkeypatch,
                                                                   tmp_path):
    """The timed calls — graph replays on the card — are gated, not only the
    eager warm-up: here every call after a step's first is one ulp off."""

    class ReplayOff(CapturedStep):
        def __call__(self, *args):
            first = self._args is None
            y = super().__call__(*args)
            if not first and self.fn.keywords["backend"] == backend:
                y = y.clone()
                y.view(-1)[0] = torch.nextafter(y.view(-1)[0], torch.tensor(float("inf")))
            return y

    monkeypatch.setattr(bb, "CapturedStep", ReplayOff)
    out = tmp_path / "b.json"
    rc = bb.main(["--smoke", "--device", "cpu", "--repeats", "1",
                  "--nets", "cifar10_tnn_smoke", "--out", str(out)])
    assert rc == 1
    rows = {r["backend"]: r for r in json.loads(out.read_text())["results"]}
    assert not rows[backend]["exact_vs_ref"]
    assert all(rows[b]["exact_vs_ref"] for b in api.BACKENDS if b != backend)
