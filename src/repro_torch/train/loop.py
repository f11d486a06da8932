"""The QAT training loop: `CutieProgram.forward_qat` -> the paper's recipe.
Counterpart of `repro.train.loop`.

`train()` takes any registry net from data to a deployed program:

    from repro_torch.train import train
    report = train("cifar10_tnn", steps=200, batch=32, lr=3e-3)   # device="cuda"
    print(report.final_eval.summary())          # qat vs deployed(fused) + gap
    print(report.deployed.silicon_report().summary())

Recipe (CUTIE / TWN lineage), the reference's:

  * STE fake-quant forward (`forward_qat`): TWN weight quantizer with
    threshold factor nu, scale-only BN, ternary activations; the backward
    is the reference's straight-through estimators (`core.ternary`), the
    convolutions' gradients PyTorch's autograd.
  * AdamW on the float shadow weights (`repro_torch.optim`, weight decay
    off by default), linear-warmup + cosine LR.
  * nu and (optionally) the activation threshold follow piecewise-constant
    schedules (`schedules`); with ``thresholds="learned"`` each conv/tcn
    layer trains its own threshold through the STE threshold gradient.
  * Fault tolerance: atomic committed checkpoints (`repro_torch.ckpt`),
    exactly-once data cursor, loss guard + restart supervision
    (`repro_torch.launch.ft.run_with_restarts`) — a restore resumes the run
    bit-identically, on the CPU and on the card.
  * Eval always reports BOTH the QAT accuracy and the deployed accuracy on
    the packed tables (default ``backend="fused"``: the fused ternary conv
    kernel on the card), so the float->ternary gap is measured.

Numerics: every step, the calibration and the eval run under
`kernels.ref.deterministic_float32` — float32 without TF32, cuDNN's
deterministic algorithms, no autotuning — so two runs from one seed give
the same bits and a resumed run equals an uninterrupted one.

Where the reference runs ``jax.jit(step, donate_argnums=(0,))``, re-jitted
per schedule segment, `train` builds one ``make_qat_step(..., donate=True)``
per segment and wraps it in a `repro_torch.capture.CapturedStep`: on the
card the first step runs eagerly and is captured as a CUDA graph, every
later step is one replay.  The state is written in place; each numpy batch
is copied into the step's static, pinned-staged device buffers; a restore
after a fault is copied into the step's state (`launch.ft`).
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.api.program import CutieProgram, check_backend
from repro_torch.api.registry import get_graph
from repro_torch.data.pipeline import pipeline_for_net
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import deterministic_float32
from repro_torch.launch.ft import run_with_restarts
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.capture import CapturedStep
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, distinct_grads
from repro_torch.train import schedules
from repro_torch.train.evaluate import EvalReport, evaluate
from repro_torch.tree import tree_leaves, tree_unflatten

THRESHOLD_MODES = ("fixed", "learned", "anneal")


def default_ckpt_dir() -> Path:
    """Where `train` and the launcher keep checkpoints unless told: under
    the process's temp directory (``TMPDIR``)."""
    return Path(tempfile.gettempdir()) / "repro_torch_qat_ckpt"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def make_qat_step(
    prog: CutieProgram,
    opt_cfg: AdamWConfig,
    *,
    nu: Optional[float] = None,
    donate: bool = False,
):
    """One QAT train step: ``(state, (x, y)) -> (state, metrics)``.

    ``state`` is the ``{"params", "opt"}`` dict from `init_train_state`;
    the batch is tensors on the params' device (numpy arrays are taken as
    CPU tensors).  Metrics are 0-d tensors: ``loss``, ``accuracy`` (train
    batch), ``grad_norm`` and ``lr``.  ``nu`` is fixed per step closure —
    the loop builds one per schedule segment.  With ``donate=False`` the
    step returns a new state and leaves the one it was given untouched;
    ``donate=True`` is the counterpart of ``donate_argnums=(0,)``: params,
    m, v and the step counter are written in place, bit-equal to
    ``donate=False``, and the returned state holds the given tensors."""

    def step(state: Dict, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        x, y = torch.as_tensor(batch[0]), torch.as_tensor(batch[1])
        diff = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        with deterministic_float32():
            logits = prog.forward_qat(tree_unflatten(params, diff), x, nu=nu)
            loss = cross_entropy(logits, y)
            wrt = [p for p in diff if p.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
            grads = []
            for p in diff:
                g = next(got) if p.requires_grad else None
                grads.append(torch.zeros_like(p) if g is None else g)
            with torch.no_grad():
                new_params, opt, info = adamw_update(
                    opt_cfg, params, tree_unflatten(params, distinct_grads(grads)),
                    state["opt"], donate=donate)
                acc = (logits.argmax(-1) == y.long()).to(torch.float32).mean()
        metrics = {"loss": loss.detach(), "accuracy": acc, **info}
        return {"params": new_params, "opt": opt}, metrics

    return step


def init_train_state(
    prog: CutieProgram, generator: torch.Generator, *, learn_thresholds=False,
    device="cuda",
) -> Dict:
    """Fresh ``{"params", "opt"}`` train state on ``device`` (checkpointable
    as-is through `repro_torch.ckpt` — every leaf is a tensor)."""
    params = prog.init(generator, learn_thresholds=learn_thresholds, device=device)
    return {"params": params, "opt": adamw_init(params)}


@dataclasses.dataclass
class TrainReport:
    """Everything `train()` measured, plus the deployable artifacts."""

    net: str
    steps: int
    losses: List[float]
    evals: List[Tuple[int, EvalReport]]     # (step, report) at segment ends
    final_eval: EvalReport
    restarts: int
    wall_s: float
    nu_final: float
    thresholds_mode: str
    learned_thresholds: Optional[Dict]      # {"conv": [...], "tcn": [...]} or None
    params: Dict                            # trained float params
    deployed: object                        # DeployedProgram (packed tables)
    step_builds: int = 0                    # step captures (one per segment that ran)

    @property
    def ms_per_step(self) -> float:
        return self.wall_s / max(len(self.losses), 1) * 1e3

    @property
    def loss_decreased(self) -> bool:
        """Robust 'training worked' predicate: the last quarter's mean loss
        is below the first quarter's (single-step noise is not a signal).
        True when no new steps ran (a resume at completion is not a
        regression)."""
        n = len(self.losses)
        if n == 0:
            return True
        if n < 4:
            return self.losses[-1] < self.losses[0]
        q = max(n // 4, 1)
        first = sum(self.losses[:q]) / q
        last = sum(self.losses[-q:]) / q
        return last < first

    def gate(self, gap_bound: float) -> List[str]:
        """The train-smoke gate, shared by the CLI launcher and
        benchmarks/train_bench_torch.py so the two cannot drift: empty list
        = ok, else human-readable failure lines (loss decrease + |gap|
        bound)."""
        failures = []
        if not self.loss_decreased:
            n = len(self.losses)
            q = max(n // 4, 1)
            failures.append(
                f"{self.net}: loss did not decrease "
                f"(first-quarter mean {sum(self.losses[:q]) / q:.4f} -> "
                f"last-quarter mean {sum(self.losses[-q:]) / q:.4f})"
            )
        if abs(self.final_eval.gap) > gap_bound:
            failures.append(
                f"{self.net}: |qat-deployed| accuracy gap "
                f"{self.final_eval.gap:+.3f} exceeds bound {gap_bound}"
            )
        return failures

    def summary(self) -> str:
        e = self.final_eval
        curve = (
            f"loss {self.losses[0]:.4f} -> {self.losses[-1]:.4f} "
            f"(decreased={self.loss_decreased})"
            if self.losses else
            "no new steps (checkpoint already at/past the requested step)"
        )
        return (
            f"[{self.net}] {len(self.losses)} steps in {self.wall_s:.1f}s "
            f"({self.ms_per_step:.0f} ms/step, restarts={self.restarts})\n"
            f"  {curve}\n"
            f"  eval: {e.summary()}"
        )


def train(
    net: str,
    *,
    steps: int = 200,
    batch: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    ckpt_dir=None,
    ckpt_every: int = 50,
    nu_schedule: str = "const",
    thresholds: str = "fixed",
    per_channel: bool = True,
    eval_batches: int = 4,
    backend: str = "fused",
    weight_decay: float = 0.0,
    warmup_steps: int = 10,
    noise: float = 0.5,
    log=print,
    tracer=None,
    device="cuda",
) -> TrainReport:
    """Train a registry net end-to-end: data -> QAT -> quantize -> eval.

    ``net``            registry name (``cifar10_tnn``, ``dvs_cnn_tcn``, or
                       their ``_smoke`` variants; any `register_net` entry).
    ``ckpt_dir``       committed checkpoints (default `default_ckpt_dir`);
                       a run resumes from the newest one it finds there.
    ``nu_schedule``    "const" | "anneal" | a float (see `schedules.resolve`).
    ``thresholds``     "fixed" (graph's act_threshold), "anneal" (scheduled
                       static), or "learned" (per-layer trainable scalars).
    ``per_channel``    train on the per-OCU quantization grid deployment
                       packs (recommended; keeps the QAT->deployed gap ~0).
    ``backend``        deploy backend the final eval measures (``fused``:
                       the fused ternary conv kernel on the card).
    ``tracer``         an optional `repro_torch.obs.Tracer`: the loop emits
                       per-segment ``train.segment``/``train.steps``/
                       ``train.eval`` spans and the final ``train.quantize``/
                       ``train.eval`` spans on a lane named after the net.
    ``device``         ``"cuda"`` (default; an error without a CUDA device)
                       or ``"cpu"``: params, optimizer state and batches
                       live there.

    Returns a `TrainReport`; the final checkpoint stays committed under
    ``ckpt_dir`` and ``report.deployed`` is ready for `.stream()`/
    `.serve()`/`.silicon_report()`.
    """
    if thresholds not in THRESHOLD_MODES:
        raise ValueError(f"thresholds must be one of {THRESHOLD_MODES}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    check_backend(backend)  # fail a typo now, not after the whole run
    dev = resolve_device(device)
    ckpt_dir = default_ckpt_dir() if ckpt_dir is None else ckpt_dir
    graph = get_graph(net)
    if per_channel:
        graph = dataclasses.replace(graph, qat_per_channel=True)
    prog = CutieProgram(graph)
    pipe = pipeline_for_net(graph, batch, seed=seed, noise=noise)
    opt_cfg = AdamWConfig(
        lr=lr, warmup_steps=warmup_steps, total_steps=steps,
        weight_decay=weight_decay,
    )
    nu_sched = schedules.resolve(nu_schedule, graph.weight_nu, steps)
    th_sched = (
        schedules.anneal(graph.act_threshold, steps, start_frac=0.6)
        if thresholds == "anneal" else schedules.constant(graph.act_threshold)
    )

    def init_state():
        return init_train_state(prog, torch.Generator().manual_seed(seed),
                                learn_thresholds=thresholds == "learned", device=dev)

    tr = tracer if tracer is not None else NULL_TRACER
    losses: List[float] = []
    evals: List[Tuple[int, EvalReport]] = []
    restarts = step_builds = 0
    state = None
    t0 = time.time()
    segs = schedules.merged_segments(steps, nu_sched, th_sched)
    for si, (a, b, (nu_v, th_v)) in enumerate(segs):
        # a scheduled static threshold is a graph property; learned
        # thresholds live in the params and ignore th_v
        seg_graph = (
            graph if thresholds == "learned"
            else dataclasses.replace(graph, act_threshold=th_v)
        )
        seg_prog = CutieProgram(seg_graph)
        step_fn = CapturedStep(make_qat_step(seg_prog, opt_cfg, nu=nu_v, donate=True),
                               dev, inputs=(1,))
        if len(segs) > 1:
            log(f"[train] segment {si + 1}/{len(segs)}: steps [{a}, {b}) "
                f"nu={nu_v:.3f} threshold="
                f"{'learned' if thresholds == 'learned' else f'{th_v:.3f}'}")
        with tr.span("train.segment", track=net, segment=si,
                     steps_from=a, steps_to=b, nu=nu_v):
            with tr.span("train.steps", track=net, segment=si):
                state, hist = run_with_restarts(
                    lambda: step_fn, init_state, pipe,
                    ckpt_dir=ckpt_dir, n_steps=b, ckpt_every=ckpt_every,
                    log=log,
                )
            losses += hist["losses"]
            restarts += hist["restarts"]
            step_builds += step_fn.builds
            # segment-boundary eval (the final eval follows below);
            # skipped when the segment ran no new steps
            if b < steps and hist["losses"]:
                with tr.span("train.eval", track=net, segment=si, step=b):
                    evals.append((b, evaluate(
                        seg_prog, state["params"], pipe,
                        n_batches=max(eval_batches // 2, 1), backend=backend,
                        nu=nu_v,
                    )))
    wall = time.time() - t0

    # final: quantize on the grid the last segment trained — nu_sched.final,
    # with learned thresholds folding in via quantize() — and measure both
    final_graph = (
        graph if thresholds == "learned"
        else dataclasses.replace(graph, act_threshold=th_sched.final)
    )
    final_prog = CutieProgram(final_graph)
    calib = torch.from_numpy(pipe.batch_at(0)[0]).to(dev)
    with tr.span("train.quantize", track=net, nu=nu_sched.final):
        deployed = final_prog.quantize(
            state["params"], calib=calib, nu=nu_sched.final)
    with tr.span("train.eval", track=net, step=steps, final=True):
        final_eval = evaluate(
            final_prog, state["params"], pipe, deployed=deployed,
            n_batches=eval_batches, backend=backend, nu=nu_sched.final,
        )
    learned = state["params"].get("thresh") if thresholds == "learned" else None
    return TrainReport(
        net=net, steps=steps, losses=losses, evals=evals, final_eval=final_eval,
        restarts=restarts, wall_s=wall, nu_final=nu_sched.final,
        thresholds_mode=thresholds, learned_thresholds=learned,
        params=state["params"], deployed=deployed, step_builds=step_builds,
    )
