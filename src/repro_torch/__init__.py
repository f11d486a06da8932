"""`repro_torch` — the PyTorch/CUDA port of the TCN-CUTIE reproduction.

The JAX package `repro` beside this one is the frozen reference; this
package imports `torch` and `numpy` only and keeps the reference's
sub-package and function names so a reader finds each counterpart:

    from repro_torch.api import get_net
    prog     = get_net("dvs_cnn_tcn")
    params   = prog.init(torch.Generator().manual_seed(0))      # device="cuda"
    deployed = prog.quantize(params, calib=frames)
    logits   = deployed.forward(frames, backend="fused")        # | "ref"
    pool     = deployed.serve(pool_size=8)                      # SessionPool

Every entry point takes an explicit ``device`` (default ``"cuda"``).  A CUDA
tensor reaches the hand-written Hopper kernel under `repro_torch.csrc` or
raises; the plain PyTorch versions beside the kernels serve CPU tensors only.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
