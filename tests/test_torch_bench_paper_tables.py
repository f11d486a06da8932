"""`benchmarks/paper_tables_torch.py` on the CPU against the reference's
`benchmarks/paper_tables.py`: the same tables, the ``--silicon`` sweep
equal to the committed ``BENCH_silicon.json`` row for row (and accepted by
the unchanged checker), and the ``--bitsim-check`` gate."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import paper_tables as ref_pt  # noqa: E402
from benchmarks import paper_tables_torch as pt  # noqa: E402
from repro_torch.api.program import DeployedProgram  # noqa: E402

BENCH_SILICON = json.loads((ROOT / "BENCH_silicon.json").read_text())
CHECKER = ROOT / "scripts" / "check_bench_regression.py"


@pytest.mark.parametrize("name", ["table1", "fig5", "fig6", "dvs_tcn_soa_comparison"])
def test_table_equals_the_reference(name):
    assert getattr(pt, name)() == getattr(ref_pt, name)()


def test_silicon_sweep_equals_the_reference():
    assert pt.silicon_sweep() == ref_pt.silicon_sweep()


def test_silicon_flag_writes_the_committed_rows(tmp_path):
    out = tmp_path / "BENCH_silicon_torch.json"
    assert pt.main(["--silicon", "--device", "cpu", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["results"] == BENCH_SILICON["results"]
    assert payload["meta"]["schema"] == BENCH_SILICON["meta"]["schema"]
    assert payload["meta"]["nets"] == BENCH_SILICON["meta"]["nets"]
    assert payload["meta"]["corners"] == BENCH_SILICON["meta"]["corners"]
    assert payload["meta"]["device"] == "cpu"
    for base in (ROOT / "BENCH_silicon.json", out):
        rc = subprocess.run([sys.executable, str(CHECKER), "--silicon", str(base), str(out)],
                            capture_output=True, text=True, timeout=120).returncode
        assert rc == 0


def test_silicon_default_out_is_beside_the_references():
    assert pt.SILICON_OUT == ROOT / "BENCH_silicon_torch.json"


@pytest.fixture
def smoke_bitsim_nets(monkeypatch):
    """``--bitsim-check`` on the smoke registry nets (the paper-size ones are
    the card's)."""
    monkeypatch.setattr(pt, "BITSIM_NETS", tuple(f"{n}_smoke" for n in pt.BITSIM_NETS))


def test_bitsim_check_passes(smoke_bitsim_nets, capsys):
    assert pt.main(["--bitsim-check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK") == 7 and "MISMATCH" not in out


def test_bitsim_check_fails_on_a_bitsim_one_ulp_off(smoke_bitsim_nets, monkeypatch, capsys):
    real = DeployedProgram.forward

    def forward(self, x, backend="fused"):
        y = real(self, x, backend=backend)
        if backend == "bitsim":
            y = y.clone()
            y.view(-1)[0] = torch.nextafter(y.view(-1)[0], torch.tensor(float("inf")))
        return y

    monkeypatch.setattr(DeployedProgram, "forward", forward)
    assert pt.main(["--bitsim-check", "--device", "cpu"]) == 1
    assert "bitsim==ref MISMATCH" in capsys.readouterr().out
