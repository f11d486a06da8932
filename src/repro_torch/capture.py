"""A fixed-shape step captured once as a CUDA graph — the port's counterpart
of the reference's ``jax.jit`` of a serving step.

The reference traces a pool tick (and a `StreamSession` step) once and
dispatches one compiled executable per call.  Run eagerly, the same step
is some 40 small kernel launches enqueued one at a time from Python, and
the card idles while the host enqueues them.  `CapturedStep` records the
step once into a `torch.cuda.CUDAGraph` and replays it: one launch from the
host per call.

The contract the caller keeps: ``fn`` reads and writes only tensors whose
addresses never change (static inputs the caller copies into, state it
updates in place) and returns one output tensor.  What ``fn`` allocates is
allocated from the graph's private memory pool at capture and reused by
every replay.

    step = CapturedStep(fn, device, capture=True)
    out = step()      # 1st call: eager warm-up (its result is real), then capture
    out = step()      # later calls: one replay, a fresh copy of the output

On a CUDA device with ``capture=True`` the first call runs ``fn`` eagerly —
which builds and loads every kernel and fills every cache — and then
captures it; each later call replays the graph and returns a new tensor
holding the graph's output, so an output kept by the caller never changes
under it.  Anywhere else (the CPU, or ``capture=False``) ``fn`` runs
eagerly on every call.  A failed capture or replay raises: no call falls
back to the eager step on the card.

Capture uses ``capture_error_mode="thread_local"``: a fleet captures one
bucket's pool while other buckets' feeder threads fill host buffers, and
only the capturing thread's own CUDA calls can break its capture.  The
cyclic garbage collector is paused during a capture, because freeing
another graph is such a call.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional, Union

import torch

from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda


class CapturedStep:
    """``fn()`` run eagerly once, then replayed from a CUDA graph.

    ``builds`` is the reference's trace count: 0 before the first call,
    then 1 — the capture on the card, the first eager run elsewhere."""

    def __init__(self, fn: Callable[[], torch.Tensor],
                 device: Union[str, torch.device], capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.builds = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        # K1 launches the graph holds, added to the launch count per replay
        self.k1_per_replay = 0

    @property
    def captured(self) -> bool:
        """True once the step is a captured CUDA graph."""
        return self.graph is not None

    def __call__(self) -> torch.Tensor:
        if self.graph is not None:
            with torch.cuda.device(self.device):
                self.graph.replay()
                out = self._out.clone()
            ternary_conv2d_cuda.launches += self.k1_per_replay
            return out
        if not self.capture:
            self.builds = max(self.builds, 1)
            return self.fn()
        launched = ternary_conv2d_cuda.launches
        out = self.fn()  # the warm-up: this call's result
        self._capture(ternary_conv2d_cuda.launches - launched)
        return out

    def _capture(self, k1_eager: int) -> None:
        recorded = ternary_conv2d_cuda.recorded
        graph = torch.cuda.CUDAGraph()
        # A graph freed while another is being captured (a dead session's,
        # reclaimed by the cyclic collector at some allocation) makes a CUDA
        # call that ends the capture: the collector pauses meanwhile.  (A
        # full collection first would cost 0.1 s or more in a large process.)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self._out = self.fn()
        finally:
            if collecting:
                gc.enable()
        k1 = ternary_conv2d_cuda.recorded - recorded
        if k1 != k1_eager:
            raise RuntimeError(
                f"the captured step recorded {k1} K1 launches, its eager run "
                f"made {k1_eager}: the step is not the same work twice"
            )
        self.graph, self.k1_per_replay = graph, k1
        self.builds += 1
