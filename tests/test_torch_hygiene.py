"""Import hygiene of the PyTorch/CUDA port: `src/repro_torch/` and
`chip_smoke.py` import neither JAX nor anything of the reference package
`repro`, and importing every module of the port needs no CUDA toolchain
(kernels are built inside the function that launches them)."""
import importlib
import pkgutil
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|repro)(?:\.|\s|$)", re.M)
DYNAMIC = re.compile(r"""(?:import_module|__import__)\(\s*["'](jax|repro)(?:\.|["'])""")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "benchmarks").glob("*_torch.py")) + sorted(
        (ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_nothing_of_the_reference(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), f"{path}: imports {FORBIDDEN.search(text).group(1)}"
    assert not DYNAMIC.search(text), f"{path}: dynamic import of jax/repro"


def test_every_port_module_imports_without_a_cuda_toolchain():
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in ("repro_torch.kernels.ternary_conv2d", "repro_torch.artifact.format",
                 "repro_torch.artifact.loader", "repro_torch.artifact.__main__",
                 "repro_torch.obs.tracer", "repro_torch.obs.metrics",
                 "repro_torch.serving.fleet", "repro_torch.serving.gating",
                 "repro_torch.train.loop", "repro_torch.optim.adamw",
                 "repro_torch.ckpt.checkpoint", "repro_torch.launch.ft",
                 "repro_torch.launch.train", "repro_torch.obs.export",
                 "repro_torch.launch.train_lm", "repro_torch.optim.compress"):
        assert name in names
    for name in names:
        importlib.import_module(name)


def test_kernel_source_is_cuda_cpp_with_a_plain_c_interface():
    src = (PORT / "csrc" / "ternary_conv2d.cu").read_text()
    assert 'extern "C" int ternary_conv2d_launch' in src
    assert "__global__" in src and "cudaGetLastError" in src
    for banned in ("torch/extension.h", "cudnn", "cublas", "cutlass/gemm/device"):
        assert banned not in src
