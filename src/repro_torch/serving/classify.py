"""`BatchClassifier` — a spatial CUTIE net (no TCN memory) served as a
fixed-batch image classifier.  The port's own: the reference has no
counterpart.

    clf = deployed.classify(batch=256)          # DeployedProgram.classify
    clf.submit("job-0", images_a)               # [n, H, W, C] float32
    clf.submit("job-1", images_b)
    answers = clf.run()                         # [(id, logits [n, classes])]

A FIFO of requests, each a stack of images.  Every `tick` takes the next
``batch`` images in submission order, across request boundaries, and:

  1. **assemble** — copies them (numpy) into a host `pool.HostBatch`,
     pinned on a card, and zeroes the rows the last tick filled that get no
     image now: a short batch is padded with zero images;
  2. **upload** — copies the batch into the classifier's static device
     input, without blocking from pinned memory;
  3. **replay** — runs the one step, ``spatial_forward(x, backend)`` over
     that input (`repro_torch.capture.CapturedStep`: eagerly once, then a
     CUDA graph replayed every tick on the card; eager every tick on the
     CPU), on ``fused`` one K1 launch per conv layer;
  4. **flush** — ONE device-to-host copy of the ``[batch, n_classes]``
     logits, into pinned memory on a card, and its wait for the replay;
     each taken image's row goes to its request's answer.

A request departs on the tick its last image got its logits; its answer is
a ``[n_images, n_classes]`` float32 array, rows in its images' order.
Padding rows are never answered nor counted in `images_stepped`.  The
flush waits for the whole tick, so the next tick finds the host batch free:
one host batch is enough.  Every answered row is bit-equal to
``deployed.forward(images, backend)`` (all arithmetic is exact on ternary
and dyadic values, in any batch).

**Tracing.**  ``classify.tick`` (arg ``images``: rows stepped, 0 when the
queue was empty) holds, on a stepping tick, ``classify.assemble``,
``classify.upload`` (args ``bytes``, ``pinned``), ``classify.replay``
(arg ``k1``: the K1 launches a replay holds, 0 on the tick that builds the
step) and ``classify.flush`` (arg ``rows``); a ``classify.queue_depth``
counter samples the images waiting at each tick's start; an instant
``classify.build`` (arg ``capture_s``) marks the step's build.  All on the
lane ``track`` (the graph's name).  An enabled wall-clock tracer on a card
also gets ``dev.upload`` / ``dev.replay`` on ``<track>.device``
(`repro_torch.obs.device.DeviceSpans`, as `SessionPool` records them).
Untraced, the classifier holds `NULL_TRACER` and `NULL_DEVICE_SPANS`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.capture import CapturedStep
from repro_torch.obs.device import NULL_DEVICE_SPANS, DeviceSpans, records_device_time
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.pool import HostBatch, host_frame


class _Request:
    """One request in the FIFO: its images, its answer, how many of its
    images a tick has taken and how many have their logits."""

    __slots__ = ("rid", "images", "logits", "taken", "answered")

    def __init__(self, rid: str, images: np.ndarray, n_classes: int):
        self.rid = rid
        self.images = images
        self.logits = np.empty((len(images), n_classes), np.float32)
        self.taken = 0
        self.answered = 0


class BatchClassifier:
    """Fixed-batch classification over one spatial `DeployedProgram` (see
    the module docstring)."""

    def __init__(self, deployed, batch: int, backend: str = "fused", tracer=None):
        from repro_torch.api.program import check_backend

        check_backend(backend)
        g = deployed.graph
        if g.is_temporal:
            raise ValueError(f"{g.name} has a TCN memory: serve its streams with "
                             "DeployedProgram.serve()")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.deployed = deployed
        self.batch = batch
        self.backend = backend
        self.device = deployed.device
        self.image_shape: Tuple[int, ...] = (*g.input_hw, g.input_ch)
        self.n_classes = g.n_classes
        self.pinned = self.device.type == "cuda"
        self.x = torch.zeros((batch, *self.image_shape), dtype=torch.float32,
                             device=self.device)
        self.step = CapturedStep(self._run_step, self.device)
        self._host = HostBatch(batch, self.image_shape, self.pinned)
        self._filled = 0  # rows of the host batch the last tick wrote
        self._logits = torch.empty((batch, self.n_classes), dtype=torch.float32,
                                   pin_memory=self.pinned)
        self._flushed = torch.cuda.Event() if self.pinned else None
        self._queue: Deque[_Request] = deque()
        self._ids: Dict[str, _Request] = {}
        self.queue_depth = 0      # images submitted and not yet taken
        self.images_stepped = 0   # images that got logits, padding excluded
        self.tick_index = 0
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.track = g.name
        self._device_spans = NULL_DEVICE_SPANS
        if records_device_time(self.tracer, self.device):
            self._device_spans = DeviceSpans(self.tracer, [self.device],
                                             [f"{self.track}.device"],
                                             ("dev.upload", "dev.replay"), track=self.track)

    def _run_step(self) -> torch.Tensor:
        return self.deployed.spatial_forward(self.x, self.backend)

    # -- requests ------------------------------------------------------------

    def submit(self, request_id: str, images) -> None:
        """Queue ``images`` (``[n, H, W, C]``, a numpy array or a tensor,
        n >= 1) under ``request_id``, which no request in the queue holds.
        The classifier reads them at the ticks that take them: keep them
        unchanged until the request departs."""
        images = host_frame(images)
        if images.ndim != 4 or images.shape[1:] != self.image_shape or len(images) < 1:
            raise ValueError(f"request {request_id!r}: images {images.shape} are not "
                             f"[n >= 1, {', '.join(map(str, self.image_shape))}]")
        if request_id in self._ids:
            raise ValueError(f"request {request_id!r} is already queued")
        req = _Request(request_id, images, self.n_classes)
        self._queue.append(req)
        self._ids[request_id] = req
        self.queue_depth += len(images)

    @property
    def pending(self) -> bool:
        """Whether a request waits for its answer."""
        return bool(self._queue)

    # -- the tick ------------------------------------------------------------

    def tick(self) -> Tuple[int, List[Tuple[str, np.ndarray]]]:
        """One batch (module docstring).  Returns the images it stepped and
        the requests that departed, in submission order, each with its
        ``[n_images, n_classes]`` answer.  With nothing queued it only
        advances `tick_index`."""
        tr, track = self.tracer, self.track
        with tr.span("classify.tick", track=track) as span:
            tr.counter("classify.queue_depth", self.queue_depth, track=track)
            self.tick_index += 1
            if not self._queue:
                span.set_args(images=0)
                return 0, []
            self._device_spans.resolve()
            with tr.span("classify.assemble", track=track):
                taken = self._assemble()
            n = sum(k for _, _, k in taken)
            span.set_args(images=n)
            self._upload()
            with tr.span("classify.replay", track=track, k1=self.step.k1_per_replay):
                self._device_spans.mark(1)
                builds = self.step.builds
                logits = self.step()
                if self.step.builds != builds:
                    tr.instant("classify.build", track=track, capture_s=self.step.capture_s)
                self._device_spans.mark(2)
                self._device_spans.close([{"dev.replay": {"k1": self.step.k1_per_replay}}])
            with tr.span("classify.flush", track=track, rows=n):
                host = self._flush(logits)
                departed = []
                for req, row, k in taken:
                    req.logits[req.answered:req.answered + k] = host[row:row + k]
                    req.answered += k
                while self._queue and self._queue[0].answered == len(self._queue[0].images):
                    req = self._queue.popleft()
                    del self._ids[req.rid]
                    departed.append((req.rid, req.logits))
            self.images_stepped += n
            return n, departed

    def _assemble(self) -> List[Tuple[_Request, int, int]]:
        """The next ``batch`` images into the host batch: ``[(request, first
        row, images)]``; rows past them are zero."""
        batch, n, taken = self._host.batch, 0, []
        for req in self._queue:
            if n == self.batch:
                break
            k = min(len(req.images) - req.taken, self.batch - n)
            batch[n:n + k] = req.images[req.taken:req.taken + k]
            taken.append((req, n, k))
            req.taken += k
            n += k
        if n < self._filled:
            batch[n:self._filled] = 0.0
        self._filled = n
        self.queue_depth -= n
        return taken

    def _upload(self) -> None:
        """The host batch into the static device input, without blocking
        from pinned memory (the flush's wait covers it)."""
        src = self._host.tensors[0]
        with self.tracer.span("classify.upload", track=self.track, bytes=src.nbytes,
                              pinned=self.pinned):
            self._device_spans.mark(0)
            self.x.copy_(src, non_blocking=self.pinned)

    def _flush(self, logits: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host copy of the logits, and its wait."""
        self._logits.copy_(logits, non_blocking=self.pinned)
        if self._flushed is not None:
            self._flushed.record(torch.cuda.current_stream(self.device))
            self._flushed.synchronize()
        return self._logits.numpy()

    def run(self) -> List[Tuple[str, np.ndarray]]:
        """Tick until every queued request has departed; the answers in
        departure (= submission) order."""
        out: List[Tuple[str, np.ndarray]] = []
        while self._queue:
            out.extend(self.tick()[1])
        return out

    # -- introspection ---------------------------------------------------------

    @property
    def trace_count(self) -> int:
        """Builds of the step: 0 before the first tick, then 1 for good (a
        capture on the card, the first eager run elsewhere)."""
        return self.step.builds

    @property
    def captured(self) -> bool:
        """True once the step is a captured CUDA graph."""
        return self.step.captured
