"""A fixed-shape step captured once as a CUDA graph — the port's counterpart
of the reference's ``jax.jit`` of a step, ``donate_argnums`` included.

The reference traces a step once and dispatches one compiled executable per
call: a pool tick, a `StreamSession` step, a QAT train step, the eval's two
forwards, an LM decode step.  Run eagerly, the same step is tens to
thousands of small kernel launches enqueued one at a time from Python, and
the card idles while the host enqueues them.  `CapturedStep` records the
step once into a `torch.cuda.CUDAGraph` and replays it: one launch from the
host per call.

The contract the caller keeps:

  * ``fn`` reads and writes only tensors whose addresses never change.  Its
    positional arguments are static.  An argument named in ``inputs`` (a
    batch, a token column) is copied on every call into a buffer the step
    owns — numpy arrays through a pinned host buffer — so the caller may
    keep or reuse what it passed.  Every other argument is held: adopted on
    the first call and, when a later call passes other tensors (a restored
    checkpoint, a new prefill's cache), copied into bit for bit.  A held
    argument is the state a donating step writes in place, or read-only
    weights; the caller gives it up as it does a donated ``jax.jit``
    argument.  Shapes and dtypes never change (a mismatch raises): a step of
    another shape is another `CapturedStep`.
  * ``fn`` returns a tree of tensors (or one tensor).  A leaf that is one of
    the held argument tensors — the state, written in place — is returned as
    itself.  Every other leaf was allocated from the graph's private memory
    pool at capture and is overwritten by the next replay: each call returns
    a fresh copy of it, so an output kept by the caller never changes under it.

    step = CapturedStep(train_step, device, inputs=(1,))
    state, metrics = step(state, batch)   # 1st call: eager warm-up, then capture
    state, metrics = step(state, batch)   # later calls: the batch copied in, one replay

On a CUDA device with ``capture=True`` the first call runs ``fn`` eagerly on
a side stream — which builds and loads every kernel, picks every cuDNN and
cuBLAS algorithm, starts autograd's device thread and fills every cache —
and then captures it; its result is that call's result.  Anywhere else (the
CPU, or ``capture=False``) ``fn`` runs eagerly on every call over the same
static arguments.  A failed capture or replay raises: no call falls back to
the eager step on the card.

Capture uses ``capture_error_mode="thread_local"``: a fleet captures one
bucket's pool while other buckets' feeder threads fill host buffers, and
only the capturing thread's own CUDA calls can break its capture.  The
cyclic garbage collector is paused during a capture, because freeing
another graph is such a call.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
from repro_torch.tree import tree_leaves, tree_unflatten


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


class CapturedStep:
    """``fn(*args)`` run eagerly once, then replayed from a CUDA graph.

    ``builds`` is the reference's trace count: 0 before the first call,
    then 1 — the capture on the card, the first eager run elsewhere.
    ``capture_s`` is the host seconds the capture took (`torch.cuda.graph`
    synchronising and emptying the allocator's cache, recording, and
    instantiating the graph), None until then."""

    def __init__(self, fn: Callable, device: Union[str, torch.device],
                 capture: bool = True, *, inputs: Iterable[int] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.inputs = frozenset(inputs)
        self.builds = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._args: Optional[List] = None   # the static arguments fn runs on
        self._held: set = set()             # ids of the held arguments' tensors
        # (argument, leaf) -> (pinned host buffer, event of its last copy out)
        self._staging: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.cuda.Event]] = {}
        self._out = None                    # the graph's output tree
        self._fresh: List[bool] = []        # per output leaf: copied per call
        # K1 launches the graph holds, added to the launch count per replay
        self.k1_per_replay = 0
        self.capture_s: Optional[float] = None

    @property
    def captured(self) -> bool:
        """True once the step is a captured CUDA graph."""
        return self.graph is not None

    def held(self, i: int):
        """The tree the step holds as its argument ``i`` — the state a
        donating step writes in place — or None before the first call (and
        for an input).  Write into its tensors (a restore, `launch/ft.py`);
        never replace them."""
        if self._args is None or i in self.inputs:
            return None
        return self._args[i]

    def __call__(self, *args):
        self._bind(args)
        if self.graph is not None:
            with torch.cuda.device(self.device):
                self.graph.replay()
                leaves = [x.clone() if fresh else x
                          for x, fresh in zip(tree_leaves(self._out), self._fresh)]
            ternary_conv2d_cuda.launches += self.k1_per_replay
            return tree_unflatten(self._out, leaves)
        if not self.capture:
            self.builds = max(self.builds, 1)
            return self._run()
        launched = ternary_conv2d_cuda.launches
        out = self._warm_up()  # this call's result
        t0 = time.perf_counter()
        self._capture(ternary_conv2d_cuda.launches - launched)
        self.capture_s = time.perf_counter() - t0
        return out

    def _run(self):
        return self.fn(*self._args)

    # -- static arguments ---------------------------------------------------

    def _bind(self, args) -> None:
        if self._args is None:
            self._args = [
                self._own(a) if i in self.inputs else a for i, a in enumerate(args)
            ]
            self._held = {id(t) for i, a in enumerate(self._args) if i not in self.inputs
                          for t in tree_leaves(a)}
        elif len(args) != len(self._args):
            raise TypeError(f"the step takes {len(self._args)} arguments, got {len(args)}")
        for i, (dst, src) in enumerate(zip(self._args, args)):
            self._copy_into(i, dst, src)

    def _own(self, a):
        """Buffers on the step's device shaped like input ``a``."""
        def empty(x):
            t = _as_tensor(x)
            return torch.empty(t.shape, dtype=t.dtype, device=self.device)

        return tree_unflatten(a, [empty(x) for x in tree_leaves(a)])

    def _copy_into(self, i: int, dst, src) -> None:
        dl, sl = tree_leaves(dst), tree_leaves(src)
        if len(dl) != len(sl):
            raise ValueError(f"argument {i} has {len(sl)} tensors, the step was built "
                             f"for {len(dl)}")
        for j, (d, s) in enumerate(zip(dl, sl)):
            if s is d:
                continue
            t = _as_tensor(s)
            if t.shape != d.shape or t.dtype != d.dtype:
                raise ValueError(
                    f"argument {i}, tensor {j}: {tuple(t.shape)} {t.dtype}, the step was "
                    f"built for {tuple(d.shape)} {d.dtype}")
            if isinstance(s, torch.Tensor) or d.device.type != "cuda":
                d.copy_(t)
                continue
            # numpy to the card: through a pinned buffer, without blocking
            if (i, j) not in self._staging:
                self._staging[i, j] = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
                                       torch.cuda.Event())
            pinned, copied = self._staging[i, j]
            copied.synchronize()  # the previous copy out of the buffer is done
            pinned.copy_(t)
            d.copy_(pinned, non_blocking=True)
            copied.record(torch.cuda.current_stream(d.device))

    # -- warm-up and capture --------------------------------------------------

    def _warm_up(self):
        """The eager first call, on a side stream (as PyTorch's whole-network
        capture wants it); the current stream then waits for it."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._run()
        current.wait_stream(side)
        for x in tree_leaves(out):
            if isinstance(x, DTensor):
                x = x.to_local()  # a DTensor's storage is its block's
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                x.record_stream(current)  # the caller reads it there
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
                    out = self._run()
        finally:
            if collecting:
                gc.enable()
        k1 = ternary_conv2d_cuda.recorded - recorded
        if k1 != k1_eager:
            raise RuntimeError(
                f"the captured step recorded {k1} K1 launches, its eager run "
                f"made {k1_eager}: the step is not the same work twice"
            )
        self._out = out
        self._fresh = [id(x) not in self._held for x in tree_leaves(out)]
        self.graph, self.k1_per_replay = graph, k1
        self.builds += 1
