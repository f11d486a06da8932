"""CPU tests of the ``classify`` system (``systems/classify.py``): the
port's batch classifier served through the harness at ``cifar10_tnn_smoke``
(the port's plain kernels), its check against the plain reference, and the
names the benchmark gives it.
"""
from __future__ import annotations

import sys
from collections import deque
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cellbench import bench, control  # noqa: E402
from cellbench.spec import Cell, Spec, load_json, load_module  # noqa: E402

DATA = HERE / "data"
SEED = 2**31 + 37
CELL = "cifar_b256_closed"


def smoke_cell() -> Cell:
    """The cell's metrics over ``cifar10_tnn_smoke`` served by ``classify``
    under a small closed mix (batch 4, requests of 1-3 images)."""
    real = Spec.load(ROOT).cell(CELL)
    cfg = dict(load_json(DATA / "cifar10_tnn_smoke.json"), system="classify",
               frames="images_u8")
    mix = dict(load_json(DATA / "batch_small.json"), length={"dist": "uniform", "min": 1,
                                                             "max": 7})
    return Cell("cifar_smoke", cfg, mix, 1, real.end_to_end, real.per_layer)


def test_the_new_cell_and_everything_it_names_resolve():
    spec = Spec.load(ROOT)
    resolved = spec.resolve_all()
    assert all(v is None for v in resolved.values()), resolved
    for what in ("workload cifar_b256_closed", "metric classify_host_ms",
                 "metric classify_flush_ms", "metric classify_replay_device_ms"):
        assert what in resolved
    cell = spec.cell(CELL)
    assert cell.config["system"] == "classify" and cell.config["frames"] == "images_u8"
    assert cell.traffic["batch"] == 256 and cell.traffic["loop"] == "closed"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "frames_per_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "k1_roofline", "step_mfu", "device_idle_pct", "classify_host_ms", "classify_flush_ms",
        "classify_replay_device_ms"}
    ends = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in ends for m in cell.per_layer)
    assert spec.config_entry("cifar10_tnn")["reduced"] == []


@pytest.mark.parametrize("trace", [False, True])
def test_the_classifier_serves_the_smoke_net_correct(trace):
    result, lines = bench.run_cell(smoke_cell(), SEED, 1.0, trace, device="cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result
    checks = result["checks"]
    assert checks["logit_gap"]["value"] == 0.0
    assert checks["frames_mismatch"]["value"] == 0.0 and checks["missing"]["value"] == 0.0
    assert result["info"]["compared"] > 0 and result["info"]["images_compared"] > 0
    names = set(result["metrics"])
    if not trace:
        assert names == {"setup_s", "frames_per_s"}
        assert result["info"]["frames"] == round(result["metrics"]["frames_per_s"]["value"]
                                                 * result["info"]["window_s"])
    else:
        assert {"classify_host_ms", "classify_flush_ms", "step_mfu"} <= names
        assert "classify_replay_device_ms" not in names  # no device spans on the CPU


def test_a_logit_moved_by_a_tenth_is_not_correct(monkeypatch):
    from repro_torch.api.program import DeployedProgram

    forward = DeployedProgram.spatial_forward

    def altered(self, x, backend="fused"):  # each batch's first row moved by a tenth
        y = forward(self, x, backend).clone()
        y[0, 0] += 0.1 * float(y[0].abs().max().clamp(min=1e-3))
        return y

    monkeypatch.setattr(DeployedProgram, "spatial_forward", altered)
    result, _ = bench.run_cell(smoke_cell(), SEED, 1.0, False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > 0.05


def test_padding_counted_as_stepped_is_not_correct(monkeypatch):
    from repro_torch.serving import BatchClassifier

    tick = BatchClassifier.tick

    def padded(self):  # a server that counts a short batch's zero rows as stepped
        n, departed = tick(self)
        return (self.batch if n else 0), departed

    monkeypatch.setattr(BatchClassifier, "tick", padded)
    result, _ = bench.run_cell(smoke_cell(), SEED, 1.0, False, device="cpu")
    assert not result["correct"] and result["checks"]["frames_mismatch"]["value"] > 0


def test_the_bfloat16_control_is_not_correct():
    checks = control.readings(smoke_cell(), SEED, "cpu", n=16)
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]
    assert checks["frames_mismatch"]["value"] == 0.0


def test_stepped_images_are_laid_over_the_queue_in_order():
    classify = load_module("systems", "classify")
    c = classify.Classifier.__new__(classify.Classifier)
    c.order = deque([["a", 3, 0], ["b", 5, 0], ["c", 2, 0]])
    c._count(4)
    assert [e[2] for e in c.order] == [3, 1, 0]
    c._count(8)  # two more than are queued: they land on the last request
    assert [e[2] for e in c.order] == [3, 5, 4]
