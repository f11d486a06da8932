"""The port's LM serving launcher, ``python -m repro_torch.launch.serve
--arch ...``, through its entry point on the CPU: the reference's flags and
defaults, the two ``[serve]`` lines, exit 0 with finite logits, and a
refusal (never a move to the CPU) when the card is asked for and absent."""
import re

import pytest
import torch

from repro_torch.launch import serve as launch_serve


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
def test_serve_gemma_smoke_on_cpu_exits_zero(quant, capsys):
    rc = launch_serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                            "--quant", quant])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2
    # the reference's defaults: batch 4, prompt 32, 16 tokens = prefill's + 15 decodes
    assert re.match(r"\[serve\] gemma-2b-smoke: prefill\(4x32\) \d+ ms; 15 decode steps "
                    r"\d+ ms \(\d+\.\d ms/tok\)$", lines[0])
    assert lines[1].startswith("[serve] sample tokens: [")


@pytest.mark.parametrize("arch", ["mamba2-370m", "seamless-m4t-medium", "internvl2-76b"])
def test_serve_other_families_smoke_on_cpu(arch, capsys):
    rc = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--tokens", "3"])
    assert rc == 0
    assert f"[serve] {arch}-smoke: prefill(2x8)" in capsys.readouterr().out


def test_serve_exits_nonzero_on_non_finite_logits(monkeypatch, capsys):
    from repro_torch.launch import steps

    real = steps.make_decode_step

    def poisoned(cfg, **kw):
        step = real(cfg, **kw)
        return lambda p, tok, cache: (lambda lg, c: (lg * float("nan"), c))(*step(p, tok, cache))

    monkeypatch.setattr(steps, "make_decode_step", poisoned)
    rc = launch_serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                            "--tokens", "3"])
    assert rc == 1
    assert "non-finite" in capsys.readouterr().err


def test_serve_lm_refuses_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal cannot be shown")
    for argv in ([], ["--arch", "gemma-2b", "--smoke"], ["--arch", "mamba2-370m"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch_serve.main(argv)


def test_lm_flags_and_defaults_are_the_reference_launchers(capsys):
    with pytest.raises(SystemExit) as exit_info:
        launch_serve.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--arch", "--smoke", "--quant", "--batch", "--prompt-len", "--tokens"):
        assert flag in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "no-such-arch", "--device", "cpu"])
