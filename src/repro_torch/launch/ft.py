"""Fault tolerance and straggler mitigation for the training launcher.
Counterpart of `repro.launch.ft` (plain Python over the port's `ckpt`).

At 1000+ nodes, the relevant failure modes and this framework's answers:

  node crash        -> atomic committed checkpoints (ckpt/) + supervised
                       retry loop (``run_with_restarts``): the job restarts
                       from the newest COMMIT with an exactly-once data
                       cursor.  MTBF math: at 50k steps/day and ckpt every
                       N steps, expected lost work per failure is N/2 steps.
  degraded restart  -> elastic restore: checkpoints store *logical* arrays;
                       the restore places them on whatever device the
                       restarted job's state lies on.
  straggler hosts   -> per-step wall-time EWMA + percentile detector
                       (``StragglerDetector``): hosts slower than
                       k * p50 for w consecutive windows are reported for
                       exclusion at the next restart boundary.  (Detection is
                       what we can exercise on one host; the eviction RPC is
                       a deployment concern.)
  silent data corr. -> loss-spike guard (``LossGuard``): a step whose loss
                       is > z sigmas above the EWMA is retried from the last
                       checkpoint rather than committed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch.distributed as dist

from repro_torch.capture import CapturedStep
from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.launch.mesh import rank


def _from_rank0(value):
    """``value`` as rank 0 holds it, on every rank of a process group."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass
class StragglerDetector:
    """EWMA per-host step-time tracker with percentile-based flagging."""

    threshold: float = 1.5        # flag if host_time > threshold * median
    window: int = 8               # consecutive slow windows before flagging
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _slow_count: Dict[int, int] = dataclasses.field(default_factory=dict)

    def observe(self, host_times: Dict[int, float]) -> list:
        """host_times: host_id -> seconds for this step.  Returns flagged ids."""
        for h, t in host_times.items():
            prev = self._ewma.get(h, t)
            self._ewma[h] = 0.9 * prev + 0.1 * t
        med = sorted(self._ewma.values())[len(self._ewma) // 2]
        flagged = []
        for h, e in self._ewma.items():
            if e > self.threshold * med:
                self._slow_count[h] = self._slow_count.get(h, 0) + 1
                if self._slow_count[h] >= self.window:
                    flagged.append(h)
            else:
                self._slow_count[h] = 0
        return flagged


@dataclasses.dataclass
class LossGuard:
    """Flags loss spikes (z-score over an EWMA) as suspect steps."""

    z: float = 6.0
    _mean: Optional[float] = None
    _var: float = 1.0

    def ok(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return False
        if self._mean is None:
            self._mean = loss
            return True
        sd = max(self._var ** 0.5, 1e-3)
        is_ok = loss < self._mean + self.z * sd
        # update stats only with accepted steps
        if is_ok:
            d = loss - self._mean
            self._mean += 0.1 * d
            self._var = 0.9 * self._var + 0.1 * d * d
        return is_ok


def run_with_restarts(
    make_step: Callable[[], Callable],
    init_state: Callable[[], object],
    data_pipeline,
    *,
    ckpt_dir,
    n_steps: int,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    fault_injector: Optional[Callable[[int], None]] = None,
    log: Optional[Callable[[str], None]] = None,
):
    """Supervised training loop: checkpoint/restart with exactly-once data.

    ``fault_injector(step)`` raises to simulate node failure (tests use this
    to verify the restart path end-to-end on one host).  A restore into a
    step that holds its state already (a `repro_torch.capture.CapturedStep`
    after its first call, whose graph reads that state's addresses) copies
    the checkpoint into the held tensors leaf by leaf, each rank into its
    own blocks: no second state is allocated.  Before a step's first call
    the checkpoint is restored into a fresh ``init_state()``, and so is a
    start without a checkpoint (a restart before the first one makes a
    fresh state, which a held step copies in).
    In a process group every rank runs the loop over its blocks of the
    state: the step to start from is rank 0's reading of the checkpoint
    directory, so every rank restarts at the same step, and ``log``
    (default: print) speaks on rank 0 only.
    Returns (final_state, history dict).
    """
    if log is None:
        log = print if rank() == 0 else (lambda msg: None)
    restarts = 0
    history = {"losses": [], "restarts": 0, "resumed_from": []}
    guard = LossGuard()
    while True:
        try:
            step_fn = make_step()
            start = _from_rank0(latest_step(ckpt_dir))
            if start is not None:
                held = step_fn.held(0) if isinstance(step_fn, CapturedStep) else None
                if held is not None:
                    state, meta = restore_checkpoint(ckpt_dir, held, in_place=True)
                else:
                    state, meta = restore_checkpoint(ckpt_dir, init_state())
                data_pipeline.state.step = int(meta["pipeline_cursor"].get("step", 0))
                step0 = start
                history["resumed_from"].append(start)
                log(f"[ft] resumed from step {start}")
            else:
                state = init_state()
                step0 = 0
            for step in range(step0, n_steps):
                if fault_injector is not None:
                    fault_injector(step)
                batch = data_pipeline.next_batch()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if not guard.ok(loss):
                    raise RuntimeError(f"loss guard tripped at step {step}: {loss}")
                history["losses"].append(loss)
                if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
                    save_checkpoint(
                        ckpt_dir, step + 1, state,
                        pipeline_cursor=data_pipeline.state.to_dict(),
                    )
            return state, history
        except (RuntimeError, FloatingPointError) as e:
            restarts += 1
            history["restarts"] = restarts
            log(f"[ft] failure: {e}; restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise
