"""LM-scaffold training launcher (not the paper's loop).  Counterpart of
`repro.launch.train_lm`.

Resolve ``--arch`` -> a float32 `TrainState` on ``--device`` -> a donating
train step (`launch/steps.py` ``make_train_step(..., donate=True)``)
wrapped in a `repro_torch.capture.CapturedStep`, the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``: on the card the first
step runs eagerly and is captured as one CUDA graph, and every later step,
across restarts too, is a replay of it over the state it holds (a failed
capture raises); on the CPU the step runs eagerly over the same static
arguments -> the supervised loop of `launch/ft.py` (atomic checkpoints,
exactly-once data cursor, loss guard, restarts; a restart restores the
checkpoint into the held state in place).  As in the reference, the step takes
the shard function of ``ShardingRules`` over the local ``(n, 1)`` (data,
model) mesh: the identity on one device.  On a host with several cards
``--device cuda`` names them all: the launcher starts one rank per card
(NCCL, `launch.mesh.run_ranks`), lays the train state out as DTensors by
the plan (the FSDP shards of `ShardingRules.param_shardings`), splits each
batch over the cards and reduces the gradients; rank 0 prints and writes
the checkpoints.  Started by ``torchrun`` (or inside a rank) it uses that
group's ``(world, 1)`` mesh.

The paper's training loop — ternary QAT on `CutieProgram.forward_qat` —
is `repro_torch.train`, driven by ``python -m repro_torch.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch gemma-2b --smoke \\
        --steps 30 --ckpt-dir /tmp/ckpt [--quant ternary] [--compress-grads] \\
        [--device cpu]

``--device`` defaults to ``cuda``; without a CUDA device that is an error,
not a move to the CPU.  Prints the reference's two ``[train]`` lines and
raises when the loss did not fall.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.capture import CapturedStep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.ft import run_with_restarts
from repro_torch.launch.mesh import (
    in_group,
    launcher_ranks,
    local_device,
    make_local_mesh,
    rank,
    run_ranks,
    world_mesh,
)
from repro_torch.launch.sharding import ShardingRules, distribute
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.optim.adamw import AdamWConfig


def main(argv=None, *, fault_injector=None):
    """Run the launcher; returns ``(state, history)``, the history with
    ``step_builds`` (1: one capture, or one first eager run off the card).
    ``fault_injector(step)`` is handed to `run_with_restarts` (tests raise
    from it to simulate a node failure).  Where the launcher starts one
    rank per card, it returns ``(None, rank 0's history)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--quant", default="none", choices=["none", "ternary"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: every visible card; cpu runs the "
                         "plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ranks = launcher_ranks(device)
    if ranks > 1 and not in_group(device.type):
        return run_ranks(_spawned, ranks, "cuda", args=(args,))[0]
    return _train(args, fault_injector)


def _spawned(args):
    """One card's rank of a launcher that started a rank per card."""
    return None, _train(args)[1]


def _train(args, fault_injector=None):
    device = local_device(resolve_device(args.device))
    cfg = get_config(args.arch, quant=args.quant, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    pipe = LMTokenPipeline(
        cfg.vocab_size, args.seq, args.batch, seed=args.seed,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model,
        enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0,
    )
    mesh = world_mesh() if dist.is_initialized() else make_local_mesh(device)
    rules = ShardingRules(mesh)
    step = CapturedStep(make_train_step(cfg, opt_cfg, shard=rules.make_shard_fn(),
                                        compress_grads=args.compress_grads, donate=True),
                        device, inputs=(1,))

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = make_train_state(cfg, gen, compress=args.compress_grads, device=device)
        if mesh.device_mesh is not None:
            state = distribute(state, rules.param_shardings(state))
        return state

    t0 = time.time()
    state, hist = run_with_restarts(
        lambda: step, init_state, pipe,
        ckpt_dir=Path(args.ckpt_dir), n_steps=args.steps,
        ckpt_every=args.ckpt_every, fault_injector=fault_injector,
    )
    dt = time.time() - t0
    hist["step_builds"] = step.builds
    losses = hist["losses"]
    if rank() == 0:
        print(f"[train] {cfg.name}: {len(losses)} steps in {dt:.1f}s "
              f"({dt/max(len(losses),1)*1e3:.0f} ms/step)")
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(restarts={hist['restarts']})")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce loss")
    return state, hist


if __name__ == "__main__":
    main()
