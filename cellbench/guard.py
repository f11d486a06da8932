"""What a run sets before it imports torch, and what it checks before it reports.

* Every build and kernel cache lies at a fixed path inside the checkout:
  K1's ``nvcc`` output in ``build/`` (where `repro_torch.kernels.build` keeps
  it; set explicitly so that no outside value moves it), and PyTorch's
  extension and Triton caches beside it.  The host runs single-threaded math
  libraries, so that one process with few threads offers the load.
* ``forbidden_modules`` lists the loaded modules whose top-level name (the
  part before the first dot, compared whole) is ``jax``, ``jaxlib``,
  ``flax`` or ``repro``: ``repro_torch`` begins with ``repro`` and is allowed.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def prepare_environment(root: Path) -> None:
    build = Path(root) / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
