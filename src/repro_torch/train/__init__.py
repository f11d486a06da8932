"""`repro_torch.train` — the QAT training subsystem of the port.
Counterpart of `repro.train`.

    from repro_torch.train import train
    report = train("cifar10_tnn_smoke", steps=200, batch=32)   # device="cuda"
    print(report.summary())                              # loss + qat/deployed gap
    report.deployed.forward(x, backend="fused")          # packed 2-bit inference

Layering: `schedules` (piecewise-constant nu/threshold values) <- `loop`
(STE train step, segment runner over the ckpt/FT stack, `TrainReport`) <-
`evaluate` (QAT vs deployed accuracy, the measured float->ternary gap).
Command line: ``python -m repro_torch.launch.train``.
"""

from repro_torch.train import schedules
from repro_torch.train.evaluate import (
    EVAL_STEP_BASE,
    EvalReport,
    batch_accuracy,
    eval_batches,
    evaluate,
)
from repro_torch.train.loop import (
    THRESHOLD_MODES,
    TrainReport,
    cross_entropy,
    init_train_state,
    make_qat_step,
    train,
)

__all__ = [
    "EVAL_STEP_BASE",
    "EvalReport",
    "THRESHOLD_MODES",
    "TrainReport",
    "batch_accuracy",
    "cross_entropy",
    "eval_batches",
    "evaluate",
    "init_train_state",
    "make_qat_step",
    "schedules",
    "train",
]
