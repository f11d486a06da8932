"""``correct`` has to come out false for the control and for each fault a
serving cell can have (``python -m pytest cellbench/tests``).

* The control: the plain reference served in bfloat16 (the precision below
  the configuration's float32) in the program's place, read by the run's
  own comparison (`cellbench.control.readings`), at the cells' own
  configurations on the CPU for 16 clips; on the card for 256 clips with
  ``cellbench/control.py``.
* The faults, each planted in the program underneath a whole run on the CPU
  (the harness's look for a card skipped): a step that leaves the ring state
  unchanged; half of the pool's batch left out (its frames zeroed before the
  step); an answer altered where it is produced (one logit of the pool's
  output moved by a tenth of its row's largest).  The exchange between
  chips does not exist in a one-card cell.
* Two faults that leave every clip's last logits right where each clip is
  at least ``tcn_steps`` frames long, as in the cells: a slot admitted with
  the ring its last stream left (the early probes catch it), and a clip
  stepped only over its last ``tcn_steps`` frames (the count of stepped
  frames catches it).
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cellbench import bench, check, control  # noqa: E402
from cellbench.spec import Cell, load_json  # noqa: E402

DATA = HERE / "data"
SMOKE = {"dvs_cnn_tcn_smoke": "closed_small", "kws_tcn_smoke": "gated_small"}
LONG = {"dvs_cnn_tcn_smoke": "closed_long", "kws_tcn_smoke": "open_long"}
CELL_LIMITS = {"dvs_cnn_tcn_smoke": "dvs_cnn_tcn", "kws_tcn_smoke": "kws_tcn"}


def cell_for(config: str, mix: str = None) -> Cell:
    cfg = load_json(DATA / f"{config}.json")
    # the limits the benchmark's own configuration holds its cells to
    cfg["limits"] = load_json(ROOT / f"cellbench/configs/{CELL_LIMITS[config]}.json")["limits"]
    mix = mix or SMOKE[config]
    return Cell("smoke", cfg, load_json(DATA / f"{mix}.json"), 1, [], [])


@pytest.mark.parametrize("workload", ["dvs_pool64_closed", "dvs_pool8_open"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(workload, seed):
    from cellbench.spec import Spec

    checks = control.readings(Spec.load(ROOT).cell(workload), seed, "cpu", n=16)
    assert not check.passed(checks)
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def _state_unchanged(monkeypatch):
    import repro_torch.serving.pool as pool

    monkeypatch.setattr(pool, "masked_push_", lambda state, feats, active: None)


def _half_batch_left_out(monkeypatch):
    from repro_torch.serving.pool import _Block

    run = _Block._run_step

    def step(self):
        self.frames[: self.size // 2].zero_()
        return run(self)

    monkeypatch.setattr(_Block, "_run_step", step)


def _answer_altered(monkeypatch):
    from repro_torch.serving.pool import SessionPool

    step = SessionPool.step_prepared

    def altered(self, batch, active):
        logits = step(self, batch, active).clone()
        logits[0, 0] += 0.1 * float(logits[0].abs().max().clamp(min=1e-3))
        return logits

    monkeypatch.setattr(SessionPool, "step_prepared", altered)


@pytest.mark.parametrize("config", sorted(SMOKE))
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_in_the_timed_path_makes_the_run_not_correct(config, fault, monkeypatch):
    cell = cell_for(config)
    fault(monkeypatch)
    result, _ = bench.run_cell(cell, 2**31 + 3, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]


def _ring_not_reset_at_admit(monkeypatch):
    import repro_torch.serving.pool as pool

    monkeypatch.setattr(pool, "clear_slot_", lambda state, i: None)


def _only_the_last_window_stepped(monkeypatch):
    from repro_torch.serving.scheduler import ContinuousBatcher

    admit = ContinuousBatcher._admit_ready

    def skipping(self):
        before = set(self._inflight)
        admit(self)
        steps = self.pool.deployed.graph.tcn_steps
        for sid in set(self._inflight) - before:
            n = self._inflight[sid].frames.shape[0]
            self._next_frame[sid] = max(self._next_frame[sid], n - steps)

    monkeypatch.setattr(ContinuousBatcher, "_admit_ready", skipping)


@pytest.mark.parametrize("config", sorted(LONG))
@pytest.mark.parametrize("fault, caught_by", [(_ring_not_reset_at_admit, "logit_gap"),
                                              (_only_the_last_window_stepped, "frames_mismatch")],
                         ids=["ring_not_reset_at_admit", "only_the_last_window_stepped"])
def test_a_fault_that_leaves_each_clips_last_logits_right_makes_the_run_not_correct(
        config, fault, caught_by, monkeypatch):
    cell = cell_for(config, LONG[config])
    assert cell.traffic["length"]["min"] >= cell.config["tcn_steps"]
    fault(monkeypatch)
    result, _ = bench.run_cell(cell, 2**31 + 3, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]
    check_ = result["checks"][caught_by]
    assert check_["value"] > check_["limit"], result["checks"]


@pytest.mark.parametrize("mix", ["closed_small", "closed_long"])
def test_an_intact_run_is_correct_under_the_cells_limits(mix):
    result, _ = bench.run_cell(cell_for("dvs_cnn_tcn_smoke", mix), 2**31 + 3, 1.0, False,
                               device="cpu")
    assert result["correct"], result["checks"]
    assert result["info"]["probes_compared"] > 0
