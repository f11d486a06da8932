"""The port's quickstart (`python -m repro_torch.quickstart`) end to end on the
CPU: every deploy backend of the full-width ``cifar10_tnn`` equal, the
packed-ternary matmul against its oracle, the §4 mapping, and the silicon
report at the paper's CIFAR corner."""
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch import quickstart

ROOT = Path(__file__).resolve().parent.parent


def test_quickstart_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    assert "'fused': True, 'kernel': True, 'ref': True, 'bitsim': True" in out
    assert "(8x smaller)" in out
    assert "2.72 uJ/inf" in out and "3200 inf/s" in out
    assert "calibration consistent: True" in out


def test_quickstart_module_entry_point_and_default_device():
    """``python -m repro_torch.quickstart`` runs; without ``--device`` it
    asks for the card and, on a host without one, refuses."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.quickstart", "--help"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                              capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
        assert proc.returncode != 0 and "is_available" in proc.stderr
        assert "quickstart OK" not in proc.stdout
