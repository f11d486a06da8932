"""Packed-ternary compute kernels of the port.

Each kernel has: a hand-written CUDA source under `repro_torch/csrc`, a
module here holding its ctypes wrapper AND the plain PyTorch version of the
same datapath, a public wrapper in `ops` that dispatches between them by the
tensor's device, and an oracle in `ref`.  `build` compiles the sources at
first use.
"""
from repro_torch.kernels.ops import ternary_conv2d
from repro_torch.kernels import ref

__all__ = ["ternary_conv2d", "ref"]
