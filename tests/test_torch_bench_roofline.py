"""`benchmarks/roofline_torch.py` and `benchmarks/run_torch.py` on the CPU:
the roofline terms of a SMOKE dry-run artifact from the H100 constants, the
same row arithmetic as the reference's `benchmarks/roofline.py`, the CSV
runner's every row family, and each bench port that runs on a device
raising on ``--device cuda`` without a card (the roofline reads JSON only)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import backend_bench_torch, kernel_bench_torch, paper_tables_torch  # noqa: E402
from benchmarks import roofline as ref_rl  # noqa: E402
from benchmarks import roofline_torch as rl  # noqa: E402
from benchmarks import run_torch, serving_bench_torch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402


# SMOKE gemma-2b, one cell of each step kind, at reduced shapes, written
# under the names the roofline reads
SMOKE_ARCH = "gemma-2b"
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 16, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 16, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 16, 2, "decode"),
}


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    art = tmp_path_factory.mktemp("dryrun_torch")
    return art, {name: dryrun.run_cell(SMOKE_ARCH, name, overrides={"smoke": True},
                                       shape=shape, device="cpu", out_dir=art,
                                       verbose=False)
                 for name, shape in SMOKE_SHAPES.items()}


def test_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW, rl.CHIPS) == (989e12, 3.35e12, 450e9, 256)


@pytest.mark.parametrize("name", list(SMOKE_SHAPES))
def test_roofline_row_terms_from_the_h100_constants(smoke_cells, name):
    _, cells = smoke_cells
    r = cells[name]
    shape = SHAPES[name]
    row = rl.roofline_row(r)
    probe = r["probe"]
    assert row["t_compute"] == probe["flops"] / 989e12
    assert row["t_memory"] == probe["bytes"] / 3.35e12
    assert row["t_collective"] == probe["collective_total"] / 450e9
    terms = {k: row[f"t_{k}"] for k in ("compute", "memory", "collective")}
    assert row["dominant"] == max(terms, key=terms.get)
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    assert row["model_flops"] == (6.0 if shape.kind == "train" else 2.0) * \
        r["n_active_params"] * tokens
    mem = r["memory_analysis"]
    assert row["mem_gib"] == (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    # the bandwidth share uncapped: the irreducible bytes over what the bound
    # step time moves
    min_bytes = 2 * r["n_active_params"] / 256
    if shape.kind == "decode":
        min_bytes += max(mem["argument_bytes"] - min_bytes, 0)
    assert row["bw_fraction"] == pytest.approx(
        (min_bytes / 3.35e12) / max(terms.values()), rel=1e-12)


def test_bw_fraction_above_1_is_not_capped(smoke_cells):
    """A byte count below the irreducible bytes (a wrong count) shows as a
    share above 1."""
    _, cells = smoke_cells
    r = {**cells["train_4k"], "probe": {**cells["train_4k"]["probe"], "flops": 1.0,
                                        "bytes": 1.0, "collective_total": 0}}
    assert rl.roofline_row(r)["bw_fraction"] > 1.0


@pytest.mark.parametrize("name", list(SMOKE_SHAPES))
def test_roofline_row_is_the_references_arithmetic(smoke_cells, name):
    """At the full shape both read, the port's row is the reference's with the
    TPU v5e peaks swapped for the H100's."""
    _, cells = smoke_cells
    got, want = rl.roofline_row(cells[name]), ref_rl.roofline_row(cells[name])
    assert got["t_compute"] * rl.PEAK_FLOPS == pytest.approx(want["t_compute"] * ref_rl.PEAK_FLOPS)
    assert got["t_memory"] * rl.HBM_BW == pytest.approx(want["t_memory"] * ref_rl.HBM_BW)
    assert got["t_collective"] * rl.LINK_BW == pytest.approx(
        want["t_collective"] * ref_rl.ICI_BW)
    for key in ("model_flops", "hlo_flops_per_dev", "useful_ratio", "mem_gib",
                "collectives_by_kind"):
        assert got[key] == want[key], key


def test_full_table_reads_the_artifacts_and_marks_the_missing(smoke_cells, tmp_path):
    rows = rl.full_table(art_dir=tmp_path)
    assert rows and all(r["status"] == "missing" for r in rows)


def test_main_prints_the_cells_it_reads(smoke_cells, capsys):
    art, _ = smoke_cells
    assert rl.main(["--art-dir", str(art)]) == 0
    out = capsys.readouterr().out
    assert "H100" in out
    for name in SMOKE_SHAPES:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"gemma-2b                 {name} "))
        assert "[missing]" not in line, line


def test_run_torch_prints_every_row_family(smoke_cells, capsys):
    art, _ = smoke_cells
    assert run_torch.main(["--device", "cpu", "--art-dir", str(art)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",", 1)[0] for line in lines[1:]]
    for family in ("table1/", "fig5/", "fig6/", "soa/", "kernel/", "train_smoke/",
                   "roofline/", "total_bench_seconds"):
        assert any(n.startswith(family) for n in names), family
    kernel_rows = [line for line in lines if line.startswith("kernel/")]
    assert [r.split(",", 1)[0] for r in kernel_rows] == [
        "kernel/ternary_matmul_128x512x128", "kernel/ternary_conv2d_1x16x16x8->8",
        "kernel/ternary_conv2d_2x16x16x8->8_fused_pool2"]
    assert all("bit_exact=True" in r for r in kernel_rows)
    assert "roofline/cells_ok,,n=3" in lines
    assert {n for n in names if n.startswith("train_smoke/")} == {
        "train_smoke/gemma-2b", "train_smoke/mamba2-370m"}


@pytest.mark.parametrize("module", [kernel_bench_torch, backend_bench_torch,
                                    serving_bench_torch, paper_tables_torch, run_torch],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_cuda_without_a_card_raises(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])
