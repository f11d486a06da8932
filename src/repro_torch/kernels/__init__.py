"""Packed-ternary compute kernels of the port.

Each kernel has: a hand-written CUDA source under `repro_torch/csrc`, a
module here holding its ctypes wrapper AND the plain PyTorch version of the
same datapath, a public wrapper in `ops` that dispatches between them by the
tensor's device, and an oracle in `ref`.  `build` compiles the sources at
first use.  `autotune` names each layer's plan-driven OCU tile.

    K1  ternary_conv2d   csrc/ternary_conv2d.cu   (the CUTIE layer, fused)
    K2  ternary_matmul   csrc/ternary_matmul.cu   (packed weights along K)
"""
from repro_torch.kernels.ops import ternary_conv2d, ternary_matmul
from repro_torch.kernels.autotune import (
    KernelBlock,
    block_for_layer,
    kernel_block_plan,
)
from repro_torch.kernels import ref
# The quantize -> pad -> pack path lives in repro_torch.api.quantize (one
# implementation); re-exported here for kernel-facing callers.
from repro_torch.api.quantize import (
    quantize_pack_conv_weights,
    quantize_pack_matmul_weights,
)

__all__ = [
    "ternary_matmul",
    "ternary_conv2d",
    "quantize_pack_matmul_weights",
    "quantize_pack_conv_weights",
    "KernelBlock",
    "block_for_layer",
    "kernel_block_plan",
    "ref",
]
