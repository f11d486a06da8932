"""`BatchClassifier` — a spatial CUTIE net (no TCN memory) served as a
fixed-batch image classifier.  The port's own: the reference has no
counterpart.

    clf = deployed.classify(batch=256)          # DeployedProgram.classify
    clf.submit("job-0", images_a)               # [n, H, W, C] float32
    clf.submit("job-1", images_b)
    answers = clf.run()                         # [(id, logits [n, classes])]

A FIFO of requests, each a stack of images.  Every `tick` steps one batch
k: it takes the next ``batch`` images in submission order, across request
boundaries, and:

  1. **assemble** — copies them (numpy) into host batch ``k % 2``, one of
     two ``[batch, H, W, C]`` float32 host tensors, pinned on a card, and
     zeroes the rows the last batch in it filled that get no image now: a
     short batch is padded with zero images;
  2. **upload** — copies that host batch into the classifier's static
     device input, without blocking from pinned memory;
  3. **replay** — runs the one step, ``spatial_forward(x, backend)`` over
     that input (`repro_torch.capture.CapturedStep`: eagerly once, then a
     CUDA graph replayed every tick on the card; eager every tick on the
     CPU), on ``fused`` one K1 launch per conv layer, and enqueues ONE
     device-to-host copy of its ``[batch, n_classes]`` logits into logits
     buffer ``k % 2`` (pinned on a card), then records that buffer's event;
  4. **flush** — batch k-1's: waits for its event, and hands each of its
     images' rows to the image's request.

So the host assembles batch k+1, and its caller submits and books, while
the card runs batch k: a software pipeline one batch deep.  The flush is
deferred only while the queue holds images that no tick has taken.  The
tick that takes the last of them flushes its own batch k too, after k-1:
a light or draining queue gets its answers in the tick that steps them,
and the ticks still equal the batches stepped.  Nothing else decides it.

Stream order keeps the buffers safe, with no further wait:

  * host batch ``k % 2`` is rewritten only at tick k+2; flush k, at tick
    k+1 at the latest, waited for the copy of logits k, which follows
    upload k on the same stream, so upload k has read the host batch;
  * the graph's output and the static input are overwritten by replay and
    upload k+1 only after the copy of logits k, in stream order;
  * the host reads logits buffer ``k % 2`` at flush k, before the copy of
    logits k+2 into it is enqueued (tick k+2).

A request departs on the tick its last image's logits reach the host; its
answer is a ``[n_images, n_classes]`` float32 array, rows in its images'
order.  `tick` returns the images whose logits reached the host in it,
padding excluded, and `images_stepped` counts the same images.  A request
stays queued, and `pending` true, while its batch is on the card.  Every
answered row is bit-equal to ``deployed.forward(images, backend)`` (all
arithmetic is exact on ternary and dyadic values, in any batch).

**Tracing.**  ``classify.tick`` (args ``images``: the rows it enqueued, 0
when the queue was empty; ``inflight``: 1 when it returned with its batch
still on the card, else 0) holds, on a stepping tick,
``classify.assemble``, ``classify.upload`` (args ``bytes``, ``pinned``),
``classify.replay`` (arg ``k1``: the K1 launches a replay holds, 0 on the
tick that builds the step; the logits' copy out is enqueued in it) and, on
a tick that flushes, one ``classify.flush`` (args ``rows``: the rows it
handed out; ``waited_us``: the host's wait on the logits' events, near 0
where the host sets the pace); a ``classify.queue_depth`` counter samples
the untaken images at each tick's start; an instant ``classify.build``
(arg ``capture_s``) marks the step's build.  All on the lane ``track``
(the graph's name).  An enabled wall-clock tracer on a card also gets
``dev.upload`` / ``dev.replay`` on ``<track>.device``
(`repro_torch.obs.device.DeviceSpans`, as `SessionPool` records them).
Untraced, the classifier holds `NULL_TRACER` and `NULL_DEVICE_SPANS`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.capture import CapturedStep
from repro_torch.obs.device import NULL_DEVICE_SPANS, DeviceSpans, records_device_time
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.pool import host_frame


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


class _Batch:
    """One stepped batch until its flush: ``[(request, first row, images)]``,
    its rows, and the slot (host batch and logits buffer) it uses."""

    __slots__ = ("taken", "rows", "slot")

    def __init__(self, taken: List[Tuple[_Request, int, int]], rows: int, slot: int):
        self.taken, self.rows, self.slot = taken, rows, slot


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
        # per slot (batch k uses slot k % 2): host batch and its numpy view, rows
        # its last batch filled, logits buffer and its numpy view, event after
        # the copy into it
        self._images = [torch.zeros((batch, *self.image_shape), dtype=torch.float32,
                                    pin_memory=self.pinned) for _ in range(2)]
        self._images_np = [t.numpy() for t in self._images]
        self._filled = [0, 0]
        self._logits = [torch.empty((batch, self.n_classes), dtype=torch.float32,
                                    pin_memory=self.pinned) for _ in range(2)]
        self._logits_np = [t.numpy() for t in self._logits]
        self._fetched = [torch.cuda.Event() for _ in range(2)] if self.pinned else None
        self._inflight: Optional[_Batch] = None  # stepped, not yet flushed
        self._batches = 0                        # batches stepped
        self._queue: Deque[_Request] = deque()
        self._ids: Dict[str, _Request] = {}
        self.queue_depth = 0      # images submitted and not yet taken
        self.images_stepped = 0   # images whose logits reached the host, padding excluded
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
        """Whether a request waits for its answer (a batch on the card
        included)."""
        return bool(self._queue)

    @property
    def inflight(self) -> bool:
        """Whether a stepped batch is on the card, its flush deferred to
        the next tick."""
        return self._inflight is not None

    # -- the tick ------------------------------------------------------------

    def tick(self) -> Tuple[int, List[Tuple[str, np.ndarray]]]:
        """One batch (module docstring).  Returns the images whose logits
        reached the host in it and the requests that departed, in
        submission order, each with its ``[n_images, n_classes]`` answer.
        With nothing queued it only advances `tick_index`."""
        tr, track = self.tracer, self.track
        with tr.span("classify.tick", track=track) as span:
            tr.counter("classify.queue_depth", self.queue_depth, track=track)
            self.tick_index += 1
            if not self._queue:  # a batch on the card keeps its requests queued
                span.set_args(images=0, inflight=0)
                return 0, []
            self._device_spans.resolve()
            slot = self._batches % 2
            self._batches += 1
            with tr.span("classify.assemble", track=track):
                taken = self._assemble(slot)
            stepped = _Batch(taken, sum(k for _, _, k in taken), slot)
            self._upload(slot)
            with tr.span("classify.replay", track=track, k1=self.step.k1_per_replay):
                self._device_spans.mark(1)
                builds = self.step.builds
                logits = self.step()
                if self.step.builds != builds:
                    tr.instant("classify.build", track=track, capture_s=self.step.capture_s)
                self._device_spans.mark(2)
                self._device_spans.close([{"dev.replay": {"k1": self.step.k1_per_replay}}])
                self._fetch(logits, slot)
            due = [] if self._inflight is None else [self._inflight]
            if self.queue_depth:  # untaken images remain: flush this batch next tick
                self._inflight = stepped
            else:
                due.append(stepped)
                self._inflight = None
            span.set_args(images=stepped.rows, inflight=int(self._inflight is not None))
            if not due:
                return 0, []
            with tr.span("classify.flush", track=track) as flush:
                n, waited_ns, departed = self._flush(due)
                flush.set_args(rows=n, waited_us=waited_ns / 1e3)
            return n, departed

    def _assemble(self, slot: int) -> List[Tuple[_Request, int, int]]:
        """The next ``batch`` images into host batch ``slot``: ``[(request,
        first row, images)]``; rows past them are zero.  The batch that
        last used the slot was flushed at the tick after it, which waited
        for the copy of its logits and so for its upload before it: the
        host batch is free."""
        batch, n, taken = self._images_np[slot], 0, []
        for req in self._queue:
            if n == self.batch:
                break
            k = min(len(req.images) - req.taken, self.batch - n)
            if k == 0:  # every image of it is in the batch on the card
                continue
            batch[n:n + k] = req.images[req.taken:req.taken + k]
            taken.append((req, n, k))
            req.taken += k
            n += k
        if n < self._filled[slot]:
            batch[n:self._filled[slot]] = 0.0
        self._filled[slot] = n
        self.queue_depth -= n
        return taken

    def _upload(self, slot: int) -> None:
        """Host batch ``slot`` into the static device input, without
        blocking from pinned memory (stream order puts it after the last
        replay, which read the input)."""
        src = self._images[slot]
        with self.tracer.span("classify.upload", track=self.track, bytes=src.nbytes,
                              pinned=self.pinned):
            self._device_spans.mark(0)
            self.x.copy_(src, non_blocking=self.pinned)

    def _fetch(self, logits: torch.Tensor, slot: int) -> None:
        """Enqueue the batch's one device-to-host copy of its logits into
        buffer ``slot``, and record the slot's event after it."""
        self._logits[slot].copy_(logits, non_blocking=self.pinned)
        if self._fetched is not None:
            self._fetched[slot].record(torch.cuda.current_stream(self.device))

    def _flush(self, due: List[_Batch]) -> Tuple[int, int, List[Tuple[str, np.ndarray]]]:
        """Wait for each batch's logits, oldest first, and hand its rows to
        their requests.  Returns the rows handed out, the host's wait (ns)
        and the requests that departed."""
        n = waited = 0
        for b in due:
            if self._fetched is not None:
                t0 = time.perf_counter_ns()
                self._fetched[b.slot].synchronize()
                waited += time.perf_counter_ns() - t0
            host = self._logits_np[b.slot]
            for req, row, k in b.taken:
                req.logits[req.answered:req.answered + k] = host[row:row + k]
                req.answered += k
            n += b.rows
        departed = []
        while self._queue and self._queue[0].answered == len(self._queue[0].images):
            req = self._queue.popleft()
            del self._ids[req.rid]
            departed.append((req.rid, req.logits))
        self.images_stepped += n
        return n, waited, departed

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
