"""`load(path) -> LoadedProgram` — execute a ``.cutie`` artifact, no graph.
Counterpart of `repro.artifact.loader`.

The loader reconstructs exactly what the container holds — `ProgramInfo`
metadata, the compiled `ExecutionPlan`, and the trit-packed `WeightMemory`
images (host numpy) — and wraps them in a `LoadedProgram` with the same
execution surface as `api.program.DeployedProgram`: ``forward``/
``spatial_forward``/``temporal_forward`` on any backend, ``stream()``
sessions, ``serve()`` pools, ``serve_fleet()`` routers and
``silicon_report()``.  There is NO `CutieGraph` on this path: serving
duck-types against `ProgramInfo`, and every backend executes the plan via
`sim.execute.PlanExecutor` — "fused" and "kernel" launch the hand-written
K1 once per conv/TCN layer on the card, "bitsim" walks the plan's tiles,
"ref" runs the oracle.

The program lives on one device (``loads(data, device=...)``, default
``cuda``; asking for CUDA without a card raises).  It keeps one executor per
backend, and each executor copies a layer's images to the device on first
use and reuses them, so every pool, session and forward of the program —
all pools of a fleet bucket included — shares one device copy of the
weights per backend.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

from repro_torch.artifact.format import ProgramInfo, assemble_parts, parse
from repro_torch.device import resolve_device


class LoadedProgram:
    """An executable program reconstructed from a ``.cutie`` artifact.

    Drop-in for `DeployedProgram` everywhere serving cares: `StreamSession`
    and `SessionPool` read ``.graph`` metadata attributes and ``.device``
    and call the forward/stream methods — all satisfied here from the
    artifact alone."""

    def __init__(self, info: ProgramInfo, plan, memory,
                 device: Union[str, torch.device, None] = None):
        self.info = info
        self.plan = plan
        self.memory = memory
        self.device = resolve_device(device)
        self._executors: Dict[str, object] = {}

    # -- metadata ----------------------------------------------------------

    @property
    def graph(self) -> ProgramInfo:
        """Serving metadata (`ProgramInfo`) under the attribute name the
        serving stack duck-types — NOT a `CutieGraph`."""
        return self.info

    @property
    def nbytes(self) -> int:
        """Total packed weight-image bytes (the device's weight SCM load)."""
        return self.memory.nbytes

    def to(self, device) -> "LoadedProgram":
        """This program on ``device`` (itself when it lies there already):
        the same artifact, its images copied there on first use."""
        device = resolve_device(device)
        if device == self.device:
            return self
        return LoadedProgram(self.info, self.plan, self.memory, device=device)

    # -- execution ---------------------------------------------------------

    def _executor(self, backend: str):
        """The one `PlanExecutor` of ``backend`` (built on first use): its
        device copies of the images are shared by every caller."""
        ex = self._executors.get(backend)
        if ex is None:
            from repro_torch.sim.execute import PlanExecutor

            ex = self._executors[backend] = PlanExecutor(
                self.plan, self.memory, backend=backend
            )
        return ex

    def spatial_forward(self, x: torch.Tensor, backend: str = "bitsim") -> torch.Tensor:
        """Frontend (or whole spatial net): [B, H, W, C] -> features/logits."""
        return self._executor(backend).spatial_forward(x)

    def temporal_forward(self, feats: torch.Tensor, backend: str = "bitsim") -> torch.Tensor:
        """TCN head + classifier over the ordered window [B, T, C]."""
        return self._executor(backend).temporal_forward(feats)

    def forward(self, x: torch.Tensor, backend: str = "bitsim") -> torch.Tensor:
        """Whole-program inference, `DeployedProgram.forward` semantics:
        spatial [B,H,W,C] -> logits; temporal frames [B,T,H,W,C] -> logits
        over the ring window.  The time axis is folded into the batch for
        the frontend (the reference maps over it)."""
        from repro_torch.api.program import _ring_window, check_backend

        check_backend(backend)
        if not self.info.is_temporal:
            return self.spatial_forward(x, backend)
        b, t = x.shape[:2]
        feats = self.spatial_forward(x.reshape(b * t, *x.shape[2:]), backend)
        feats = feats.reshape(b, t, -1)
        return self.temporal_forward(_ring_window(feats, self.info.tcn_steps), backend)

    # -- streaming / serving ----------------------------------------------

    def stream_step(self, stream, frame: torch.Tensor, backend: str = "bitsim"):
        """One sensor frame -> (logits, new ring) — `DeployedProgram
        .stream_step`'s pure-functional contract over the loaded plan."""
        from repro_torch.api.program import check_backend

        check_backend(backend)
        feat = self.spatial_forward(frame, backend)
        stream = stream.push(feat.to(stream.buf.dtype))
        window = stream.ordered()
        if window.ndim == 2:
            window = window[None]
        return self.temporal_forward(window, backend), stream

    def stream(self, batch: Optional[int] = None, backend: str = "bitsim",
               jit: bool = True):
        """A `StreamSession` over the artifact's TCN ring (temporal only);
        ``jit`` as in `StreamSession`."""
        from repro_torch.api.program import StreamSession

        if not self.info.is_temporal:
            raise ValueError(f"{self.info.name} has no TCN memory to stream into")
        return StreamSession(self, batch=batch, backend=backend, jit=jit)

    def serve(self, pool_size: int, backend: str = "bitsim", **kwargs):
        """A `repro_torch.serving.SessionPool` over this loaded program —
        ship one ``.cutie``, serve many sensors."""
        from repro_torch.serving import SessionPool

        return SessionPool(self, pool_size, backend=backend, **kwargs)

    def serve_fleet(self, name: Optional[str] = None, backend: str = "bitsim",
                    **kwargs):
        """A `repro_torch.serving.FleetRouter` with this artifact registered
        under ``name`` (the artifact's program name by default).  Register
        further programs on the returned router to mix tenants."""
        from repro_torch.serving import FleetRouter

        router = FleetRouter(backend=backend, **kwargs)
        router.register(name or self.graph.name, self)
        return router

    # -- silicon model -----------------------------------------------------

    def silicon_report(self, v: float = 0.5, hw=None, source: str = "sim"):
        """Cycles/energy of THIS artifact on the CUTIE silicon model.
        Defaults to ``source="sim"``: the stall-aware counters walk the
        loaded plan and the sparsity of the loaded images prices the dynamic
        energy.  Calibration uses the paper corner carried in the header."""
        from repro_torch.api.program import silicon_report_from_plan

        return silicon_report_from_plan(
            self.plan, v=v, hw=hw, source=source, memory=self.memory,
            paper_energy_uj=self.info.paper_energy_uj,
            paper_inf_per_s=self.info.paper_inf_per_s,
        )

    # -- round trip --------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Re-assemble — byte-identical to the artifact this was loaded
        from (the loader is lossless)."""
        return assemble_parts(self.info, self.plan, self.memory)

    def __repr__(self) -> str:
        return (f"LoadedProgram({self.info.name!r}, {len(self.memory.images)} "
                f"images, {self.nbytes} packed bytes, device={str(self.device)!r})")


def loads(data: bytes, device: Union[str, torch.device, None] = None) -> LoadedProgram:
    """``.cutie`` bytes -> `LoadedProgram` on ``device`` (default ``cuda``;
    raises without a card).  Malformed input raises `ArtifactError` and its
    typed subclasses — never a garbage decode."""
    dev = resolve_device(device)
    info, plan, memory = parse(data)
    return LoadedProgram(info, plan, memory, device=dev)


def load(path: Union[str, os.PathLike],
         device: Union[str, torch.device, None] = None) -> LoadedProgram:
    """Read a ``.cutie`` file and return its executable `LoadedProgram`."""
    with open(path, "rb") as f:
        return loads(f.read(), device=device)


def save(program, path: Union[str, os.PathLike]) -> int:
    """Assemble ``program`` (a `DeployedProgram` or `LoadedProgram`) and
    write it to ``path``; returns the byte count."""
    from repro_torch.artifact.format import assemble

    data = assemble(program)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
