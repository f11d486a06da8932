"""Build and load the hand-written CUDA kernels under `repro_torch/csrc`.

Each ``*.cu`` there has a plain ``extern "C"`` interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, at first use, from the source
in the package — never at import time, so hosts without a CUDA toolkit can
import every module.  The library file is keyed by a hash of the source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header rebuilds and an unchanged one is reused.  A failed build
raises; nothing falls back to another implementation.

The build directory is ``build/`` at the root of a source checkout (listed
in ``.gitignore``); ``REPRO_TORCH_BUILD_DIR`` moves it for installs whose
package directory is read-only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    # src/repro_torch/kernels/build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch are built from source and need the CUDA toolkit"
    )


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` lives, keyed by the
    content hash of the source, of every header ``csrc/*.cuh`` (any of them
    may be included) and of the flags, so an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def compile_command(source: str, out: Path, extra_flags=()) -> list:
    return [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(out),
            str(CSRC_DIR / source)]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library path.  Raises RuntimeError with nvcc's output when
    the compiler fails."""
    lib = library_path(source)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(
        compile_command(source, tmp), capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent process sees the whole file or none
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib: Optional[ctypes.CDLL] = _loaded.get(source)
    if lib is None:
        lib = _loaded[source] = ctypes.CDLL(str(build(source)))
    return lib
