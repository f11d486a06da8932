"""``setup_s``: seconds from process start to the window's first tick — the
imports, the CUDA context, K1's build or load, the weights and frames made
from the seed, quantization with its calibration, the pool and its capture,
and the warm-up."""


def read(run):
    return run.setup_s
