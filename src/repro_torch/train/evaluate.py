"""Eval for the QAT loop: the float->ternary gap, measured, every time.
Counterpart of `repro.train.evaluate`.

The paper's headline claims are accuracies of the DEPLOYED ternary network
(86% CIFAR-10, 94.5% DVS), not of the float QAT model — so this module
always reports both sides and their difference:

  * ``qat``       accuracy of `CutieProgram.forward_qat` (STE fake-quant),
                  run under `torch.no_grad`
  * ``deployed``  accuracy of `DeployedProgram.forward` on the packed 2-bit
                  tables, default ``backend="fused"`` — the fused ternary
                  conv kernel per layer on the card (its plain version for
                  tensors on the CPU), int8 trits between layers
  * ``gap``       qat - deployed, the quantization/folding loss the
                  train-smoke gate bounds

Eval batches come from the same deterministic pipeline as training but at a
disjoint step range (`EVAL_STEP_BASE`), so they are unseen samples from the
same distribution — the synthetic stand-in for a held-out split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.capture import CapturedStep
from repro_torch.kernels.ref import deterministic_float32
from repro_torch.tree import tree_leaves

EVAL_STEP_BASE = 1_000_000  # pipeline steps reserved for eval batches


def batch_accuracy(logits, labels) -> float:
    """Top-1 accuracy of one logits batch (tensors or arrays)."""
    logits = logits.detach().cpu().numpy() if isinstance(logits, torch.Tensor) else logits
    labels = labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor) else labels
    return float(np.mean(np.asarray(logits).argmax(-1) == np.asarray(labels)))


def eval_batches(pipeline, n_batches: int):
    """Deterministic held-out batches: the pipeline evaluated at the
    reserved step range, without touching its training cursor."""
    return [pipeline.batch_at(EVAL_STEP_BASE + i) for i in range(n_batches)]


@dataclasses.dataclass(frozen=True)
class EvalReport:
    """Accuracy of both execution paths on the same batches."""

    qat_accuracy: float
    deployed_accuracy: float
    backend: str
    n_examples: int

    @property
    def gap(self) -> float:
        """QAT-minus-deployed accuracy: positive = deployment lost accuracy
        to the packed grid / BN folding; ~0 on a calibrated per-channel
        quantize of a converged run."""
        return self.qat_accuracy - self.deployed_accuracy

    def summary(self) -> str:
        return (
            f"qat {self.qat_accuracy:.3f} | deployed[{self.backend}] "
            f"{self.deployed_accuracy:.3f} | gap {self.gap:+.3f} "
            f"({self.n_examples} examples)"
        )


def evaluate(
    prog,
    params: Dict,
    pipeline,
    *,
    deployed=None,
    n_batches: int = 4,
    backend: str = "fused",
    nu: Optional[float] = None,
) -> EvalReport:
    """Run both the QAT forward and the deployed forward over ``n_batches``
    held-out batches on the params' device, in the training numerics
    (`kernels.ref.deterministic_float32`).  ``deployed`` defaults to
    quantizing ``params`` fresh, calibrated on the first eval batch (the
    recommended deploy recipe).  Where the reference jits both forwards per
    call, each is a `repro_torch.capture.CapturedStep` here: on the card the
    first batch runs eagerly and is captured, the others replay, each batch
    copied into the forward's one static input."""
    dev = tree_leaves(params)[0].device
    batches = [(torch.from_numpy(np.asarray(x)).to(dev), np.asarray(y))
               for x, y in eval_batches(pipeline, n_batches)]
    if deployed is None:
        deployed = prog.quantize(params, calib=batches[0][0], nu=nu)
    qat_fwd = CapturedStep(lambda x: prog.forward_qat(params, x, nu=nu), dev, inputs=(0,))
    dep_fwd = CapturedStep(lambda x: deployed.forward(x, backend=backend), dev, inputs=(0,))
    hits_q = hits_d = total = 0
    with torch.no_grad(), deterministic_float32():
        for x, y in batches:
            yq = qat_fwd(x).argmax(-1).cpu().numpy()
            yd = dep_fwd(x).argmax(-1).cpu().numpy()
            hits_q += int((yq == y).sum())
            hits_d += int((yd == y).sum())
            total += y.shape[0]
    return EvalReport(
        qat_accuracy=hits_q / total,
        deployed_accuracy=hits_d / total,
        backend=backend,
        n_examples=total,
    )
