"""The port's LM training launcher (`repro_torch.launch.train_lm`) on the
CPU: a run with an injected node failure resumes exactly once from the last
committed checkpoint and ends in the same bits as a run without one (the
reference's `tests/test_ckpt_ft.py` restart test, on the real LM step with
donation), and the command line prints the reference's ``[train]`` lines
and resumes a finished run.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.launch import train_lm
from repro_torch.tree import tree_leaves

ARGV = ["--smoke", "--device", "cpu", "--steps", "12", "--ckpt-every", "5",
        "--batch", "4", "--seq", "32"]
REPO = Path(__file__).resolve().parents[1]


def test_fault_resumes_exactly_once_and_matches_a_straight_run(tmp_path, capsys):
    crashed = []

    def injector(step):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    state, hist = train_lm.main(ARGV + ["--ckpt-dir", str(tmp_path / "a")],
                                fault_injector=injector)
    assert crashed == [7]
    assert hist["restarts"] == 1 and hist["resumed_from"] == [5]
    straight, hist2 = train_lm.main(ARGV + ["--ckpt-dir", str(tmp_path / "b")])
    assert hist2["restarts"] == 0 and hist2["resumed_from"] == []
    # steps 0-6, then 5-11 after the restart: the committed steps used each
    # batch exactly once, so the losses and the final state are the same bits
    assert hist["losses"][:5] + hist["losses"][7:] == hist2["losses"]
    assert len(hist2["losses"]) == 12 and hist2["losses"][-1] < hist2["losses"][0]
    for a, b in zip(tree_leaves(state), tree_leaves(straight)):
        assert torch.equal(a, b)
    out = capsys.readouterr().out
    assert "[ft] resumed from step 5" in out and "restarts=1" in out


def test_cli_prints_train_lines_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    cmd = [sys.executable, "-m", "repro_torch.launch.train_lm", "--smoke", "--device", "cpu",
           "--batch", "4", "--seq", "32", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "8"], env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "[train] gemma-2b-smoke: 8 steps" in first.stdout
    assert "[train] loss" in first.stdout and "(restarts=0)" in first.stdout
    second = subprocess.run(cmd + ["--steps", "12"], env=env, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "[ft] resumed from step 8" in second.stdout
    assert "[train] gemma-2b-smoke: 4 steps" in second.stdout
