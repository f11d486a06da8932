"""Packaging of the port: a wheel carries every file the kernel build
needs.  `repro_torch.kernels.build` compiles ``csrc/<source>.cu`` and hashes
every ``csrc/*.cuh`` header into the build key; each of those files, and
every header a ``.cu`` includes with quotes, must match a package-data glob
of ``pyproject.toml``, or a non-editable install cannot build its kernels."""
import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"]["repro_torch"]


def _shipped(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in _globs())


def _sources():
    return sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))


def test_build_reads_the_packaged_csrc_dir():
    assert build.CSRC_DIR.resolve() == (PORT / "csrc").resolve()
    assert len(_sources()) >= 2


@pytest.mark.parametrize("source", _sources())
def test_every_kernel_source_and_its_includes_are_package_data(source):
    text = (build.CSRC_DIR / source).read_text()
    assert _shipped(f"csrc/{source}")
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
        assert (build.CSRC_DIR / inc).is_file(), inc
        assert _shipped(f"csrc/{inc}"), f"{source} includes {inc}, which no wheel carries"


def test_every_header_the_build_key_hashes_is_package_data():
    headers = sorted(build.CSRC_DIR.glob("*.cuh"))
    assert headers, "the kernels share csrc/ternary_mma.cuh"
    for h in headers:
        assert _shipped(f"csrc/{h.name}"), h.name


def test_the_test_extra_carries_torch():
    with open(ROOT / "pyproject.toml", "rb") as f:
        extras = tomllib.load(f)["project"]["optional-dependencies"]
    assert any(req.replace(" ", "").startswith("torch") for req in extras["test"])
