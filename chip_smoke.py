#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's paths on the card, each through the entry points a
user calls, and holds every hand-written kernel against its plain PyTorch
version.  It imports `repro_torch` only.

  * the serving path — the full-width ``dvs_cnn_tcn`` net (96 channels,
    64x64x2 event frames, 24-step TCN ring) through an 8-slot `SessionPool`
    under a `ContinuousBatcher` on the ``fused`` backend (kernel K1);
    and the full-width ``cifar10_tnn`` (the paper's CIFAR-10 network) through
    a 256-image `BatchClassifier` (`DeployedProgram.classify`, kernel K1);
  * the quickstart path — `python -m repro_torch.quickstart`: the
    full-width ``cifar10_tnn`` on every deploy backend, the packed-ternary
    matmul (kernel K2) and the silicon model;
  * the deployment path — two full-width programs (``dvs_cnn_tcn`` and
    ``kws_tcn``) shipped as ``.cutie`` bytes, loaded on the card with no
    graph, and served together through one `FleetRouter` on ``fused``
    (kernel K1 through the plan executor), ungated and activity-gated,
    then through the launcher's ``--dvs --program`` and ``--fleet --gate``;
  * the training path — `repro_torch.train.train` (STE QAT, AdamW,
    checkpoints; the donated step captured once per schedule segment as a
    CUDA graph) at full width on ``cifar10_tnn`` and ``dvs_cnn_tcn``,
    ending in the captured deployed eval on ``fused`` (kernel K1), a resume
    on the card, and the training launcher with its trace;
  * the LM serving path — ``python -m repro_torch.launch.serve --arch
    gemma-2b`` at full published width (plain and 2-bit packed weights),
    full-width ``gemma-2b`` and ``mamba2-370m`` prefill and decode (the
    decode step donating its cache, captured once as a CUDA graph), and
    the ten architectures' SMOKE configs on the card against the CPU.  It
    reaches no TPU kernel in the reference and launches neither K1 nor K2;
  * the LM training path — `make_train_step(..., donate=True)` on
    full-width ``gemma-2b`` under the ternary STE at 1 x 4096 tokens (the
    flash backward, the chunked CE, the layer remat, AdamW in place), the
    SMOKE configs' train steps on the card against the CPU, and ``python -m
    repro_torch.launch.train_lm`` with a resume.  It launches neither K1
    nor K2 either;
  * the dry-run — `repro_torch.launch.dryrun.run_cell` on full-width cells of
    the (16, 16) production mesh (FLOPs and bytes per device from meta
    tensors, held to this card's memory), and two cells held against the
    card itself on a (1, 1) mesh.  No K1, no K2;
  * the pool laid across devices — full-width ``dvs_cnn_tcn`` served through
    a `SessionPool` split into two blocks on this card (`PoolSharding`),
    each block its own captured step (kernel K1), and the launcher's
    ``--dvs --shard``;
  * the benches — `benchmarks/{kernel,backend,serving}_bench_torch.py` at
    their full cells and nets, `paper_tables_torch.py --silicon` and
    ``--bitsim-check``, each through its ``main`` in this process (kernels
    K1 and K2);
  * the LM on a real device mesh — full-width ``gemma-2b`` served (captured
    decode) and trained (one ternary step) through DTensors on an NCCL
    process group of world size 1, against the plain steps.  One card
    measures the path at world size 1 only; several ranks are held on the
    CPU (gloo) by ``tests/test_torch_spmd_*.py``.  No K1, no K2.

Phases (any failure ends the run with a non-zero exit code and no result
line):

  1. device     a CUDA device is required; prints its name and power limit
  2. build      compiles every CUDA source of the checkout with nvcc, all
                started together
  3. kernels    K1, the fused ternary conv == its plain version (`torch.equal`,
                tolerance 0: ternary/dyadic data sums exactly in float32) at
                every launch shape of the serving path for pool size 8 and
                batch 1, all variants and both input types, plus 1x1, 5x5,
                ragged C_out and odd H, W; and within rtol=atol=1e-4 on
                Gaussian float32 x (all three bf16 terms in use) at conv0,
                tcn_d1 and the 5x5 stem; K2, the packed-ternary matmul ==
                its plain version == `ternary_matmul_ref` (`torch.equal`) on
                dyadic x at the eight shapes of the reference's tests, the
                quickstart and the kernel bench, plus a K that needs padding,
                in float32 and bf16, and within rtol=atol=1e-4 (float32) /
                2e-2 (bf16) on Gaussian x (summation order), including
                K-split boundaries inside a chunk and ragged last splits;
                both kernels launched 8 times on the same Gaussian inputs
                give the same bits (no atomics, fixed reduction order).
                Then times each kernel, its plain version and a library
                yardstick
  4. serve      init -> quantize(calib) -> 16 streams x 8 frames, staggered
                arrivals, through the pool, whose step is captured once as a
                CUDA graph and replayed every later tick; gates: finite
                logits, all streams completed, the pool's `trace_count` 1
                (one capture), 9 K1 launches per pool tick (the eager first
                tick's and the graph's on every replay), the same run with
                ``jit=False`` bit-equal per stream, pooled == lone
                `StreamSession` (captured) == lone `StreamSession` (eager)
                bit for bit, fused == ref on the card.  On
                ``dvs_cnn_tcn_smoke``, captured == eager on every backend
                (one capture each; 9 / 0 K1 launches per tick).  Then a full
                pool-8 tick captured and eager, timed in turns (captured,
                eager, eager, captured; 3 rounds of 40 ticks): host ms/tick,
                frames/s, and a `torch.profiler` window of each for device
                ms/tick and the busy share.  Then ``cifar10_tnn`` at full
                width through ``classify(256)``: 12 seeded requests of 1-512
                images; gates: every request answered with one row per
                image, each row == the eager fused forward and the plain
                (``ref``) forward of its image bit for bit, one capture,
                8 K1 launches in each replay
  5. quickstart `repro_torch.quickstart` on the card (exit 0, >= 1 K2 launch);
                fused == kernel == ref == bitsim on two full-width
                ``dvs_cnn_tcn`` clips and a bitsim stream == its batch
                forward; every ``BENCH_silicon.json`` row (the reference's
                silicon model output) reproduced exactly by the port
  6. fleet      build + quantize ``dvs_cnn_tcn`` and ``kws_tcn`` (seed 0,
                calibrated on their own frames), assemble each to ``.cutie``
                bytes and ``loads`` them on the card; gates: ``to_bytes()``
                and dis -> asm give the same bytes, fused == ref == bitsim on
                the loaded program == the `DeployedProgram` on an 8-frame
                clip.  Ungated fleet (ladder cap 8, feeder thread; 16 sensors
                per net in two waves): every stream completes, logits finite
                and == a lone `StreamSession` on the loaded program, a grow
                and a shrink in each bucket, each rung's pool constructed
                once (count and object identity), every pool that stepped
                captured once, 9 / 7 K1 launches per bucket tick (the
                feeder thread fills each pool's pinned staging ring, copies
                without blocking), the same run with ``ingest="sync"``
                bit-identical.
                Gated fleet (``ActivityGate(16, 4, 2)``, 8 sensors per net at
                duty 0.4): processed frames == ``ActivityGate.plan``, each
                stream == a lone session fed exactly those frames, a positive
                silicon-model energy saving.  Then `repro_torch.launch.serve`
                ``--dvs --program`` and ``--fleet --gate`` exit 0.  Prints
                the ``fleet`` JSON line
  7. train      the launcher's smoke recipe on full-width ``cifar10_tnn``
                (96 channels, 32x32x3, 8 conv + FC; 200 steps, batch 32,
                lr 3e-3, seed-0 synthetic data, eval on ``fused``): every
                loss finite, the smoke gate (loss decreased, |QAT -
                deployed| <= 0.15), the trained program's fused == ref on
                an eval batch, 8 K1 launches per eval batch.  Full-width
                ``dvs_cnn_tcn`` (96 channels, 64x64x2, 5 conv + 4 TCN; 10
                steps, batch 8, lr 5e-3): finite losses, finite non-zero
                gradients on every layer at step 1, 9 K1 launches per
                deployed eval forward.  On ``cifar10_tnn_smoke``: 8 steps
                straight == 4 + restore + 4 (losses and params
                `torch.equal`).  ``python -m repro_torch.launch.train --net
                cifar10_tnn_smoke --smoke --trace`` and ``python -m
                repro_torch.obs summarize`` exit 0 and the trace nests.
                `train` captures its donated step: one capture
                per run of one segment, and per segment of an annealed
                ``cifar10_tnn_smoke`` run (5 segments); the final eval's
                forwards are captured too (K1 counted on the replays, the
                capture recorded 8 / 9) and its hits == the plain forwards'.
                A fault at step 5 under capture == an uninterrupted eager
                run.  At full width (``cifar10_tnn`` batch 32,
                ``dvs_cnn_tcn`` batch 8) the captured step == the raw eager
                step over 20 steps bit for bit (every metric, param, m, v
                and the step counter), then host ms per step (numpy batch
                in, loss read) captured and eager in turns (3 rounds of
                captured, eager, eager, captured; 20 steps each) and a
                `torch.profiler` window of 5 steps each (device ms, kernels,
                busy share); the captured ``cifar10_tnn`` step's device ms
                with deterministic and with autotuned cuDNN, in turns.
                Prints the ``train`` JSON line
  8. lm         ``python -m repro_torch.launch.serve --arch gemma-2b`` at the
                reference's defaults (batch 4, prompt 32, 16 tokens), with
                and without ``--quant ternary_packed``, exit 0 (finite
                logits).  In-process at full width, float32 params:
                ``gemma-2b`` (18 layers, d 2048, MQA, GeGLU 16384, vocab
                256000, bf16 activations) prefill 4 x 32 + 16 decode steps
                and one batch-1 4096-token prefill (the flash route);
                ``mamba2-370m`` (48 SSD layers) one 4096-token prefill + 16
                decode steps; ``gemma-2b`` with ``ternary_packed`` weights,
                4 x 32 + 16; each with prefill ms, decode ms per token,
                device kernels per decode step (`torch.profiler`), peak
                memory and the bound (params and cache bytes over HBM's
                rate against the FLOPs at the card's peaks).  The
                decode step is `serve_lm`'s captured, donated one: ==
                the raw eager step bit for bit over 16 tokens (logits and
                cache), one capture, and host ms per token captured and
                eager in turns (eager, captured, captured, eager; each
                window a fresh prefill, then 16 tokens).  Gates: finite
                logits; for both, in float32, decode(prefill(S-1), token S)
                == the full forward's last logits (rtol=atol=2e-3, the
                reference's own); the ten SMOKE configs give on the card
                the logits and caches the CPU gives from the same params
                (rtol=atol=1e-3); K1 and K2 launch 0 times.  Prints the
                ``lm`` JSON line
  9. lm_train   three donating train steps of full-width ``gemma-2b``
                ``quant="ternary"`` (bf16 activations, float32 params and
                AdamW state, 30.07 GB) on batch 1 x 4096 tokens of
                `LMTokenPipeline`: host ms per step, the last step's device
                ms and kernels (`torch.profiler`), busy share, peak memory,
                the bound (the state read and written once against four
                forward passes' operations at bf16 peak).  Gates: finite
                losses and grad norms, every param leaf moved.  One float32
                step of each of the ten SMOKE configs, and of ``gemma-2b``
                with ``accum_steps=2`` and with ``compress_grads``, on the
                card == on the CPU from the same state (loss, aux, lr
                within 1e-5, grad norm 1e-4, the first moment rtol 1e-3,
                atol 1e-5, as the CPU tests).  ``python -m
                repro_torch.launch.train_lm --arch mamba2-370m`` at full
                width for 20 steps (checkpoints every 10 under
                ``build/lm_train_ckpt``, free disk checked first, removed
                after) and again to 30 steps: exit 0, the ``[train]`` lines,
                "resumed from step 20".  K1 and K2 launch 0 times.  Prints
                the ``lm_train`` JSON line
  10. dryrun    `run_cell` (``force``, artifacts under ``build/dryrun_torch``)
                for ``gemma-2b`` x {``train_4k``, ``decode_32k``},
                ``deepseek-v2-lite-16b`` x ``decode_32k`` and ``mamba2-370m``
                x ``long_500k`` on ``pod16x16``: status ok; prints FLOPs,
                argument and temp bytes per device, fits on this card's
                memory, trace seconds.  On a (1, 1) mesh of this card,
                full-width ``gemma-2b`` decode (batch 4, 2048-token cache)
                and a ``gemma-2b`` SMOKE train step (4 x 64): the dry-run's
                argument bytes == the allocation's growth up to the caching
                allocator's rounding (512-byte blocks, and up to 1 MiB more
                for each argument over 1 MiB), its FLOPs == `FlopCounterMode`
                on the card's tensors exactly, its temp bytes >= the peak
                growth over one real step after a warm-up one (an upper
                bound; the ratio is printed).  K1 and K2 launch 0 times.
                Prints the ``dryrun`` JSON line
  11. shard     full-width ``dvs_cnn_tcn``, pool 8, ``fused``, captured, in
                two blocks on this card (`PoolSharding([cuda:0, cuda:0])`,
                the code two cards run) against the plain captured pool over
                12 ticks of admissions, evictions across the block boundary
                and partial ticks: logits and evicted states bit-equal,
                `trace_count` 2 (one capture per block) after every tick, 18
                K1 launches per tick (9 per block, counted on the replays).
                Host ms/tick of both pools, every slot busy, in turns (plain,
                split, split, plain; 3 rounds of 40 ticks).  ``python -m
                repro_torch.launch.serve --dvs --shard`` exits 0 and prints
                ``shard=False`` (one card).  Prints the ``shard`` JSON line
  12. spmd      the LM on a real device mesh: an NCCL process group of
                world size 1 on this card and a real (1, 1) ``DeviceMesh
                ("cuda")`` (`launch.mesh.world_mesh`), the params, caches and
                train state laid out as DTensors by the plan
                (`launch.sharding.distribute`).  Full-width ``gemma-2b``
                at the launcher's defaults (4 x 32 prompts, 15 greedy
                decodes): prefill, then the captured, donated decode step
                on DTensors beside the plain step's; gates: every step's
                logits within 2e-3 of the plain (the max difference
                printed; bit-equal expected at (1, 1)), greedy tokens
                equal, one capture; host ms per decode token of both in
                turns (plain, dtensor, dtensor, plain; 2 rounds).  One
                full-width ``gemma-2b`` ``quant="ternary"`` train step at 1
                x 4096 tokens on DTensors against the plain step from the
                same seed (run first, its params kept on the host): the
                loss within rel 1e-5, every param rtol 1e-3, atol 1e-5;
                both steps' peak memory.  Prints the group's backend and
                world size; K1 and K2 launch 0 times.  The group is
                destroyed at the end of the phase.  Prints the ``spmd``
                JSON line
  13. benches   the repo's benches through their ``main(argv)``, in process,
                each writing its JSON into a temporary directory: the kernel
                bench at its full cells (K1 and K2 against the dense
                unpacked path and their plain versions), the backend bench
                at its full nets (every backend's forward captured, fused ==
                kernel == bitsim == ref), the serving bench at full width
                (pools 2, 4 and 8 on fused and ref, fleet, gated and phases),
                ``paper_tables_torch --silicon`` (its rows ==
                ``BENCH_silicon.json`` row for row) and ``--bitsim-check``;
                any non-zero exit fails the run.  K1 and K2 launches are
                counted over the phase (``launches_bench``; both must be >
                0).  Prints the ``benches`` JSON line with each bench's
                seconds
  14. result    the ``kernels`` JSON line (each kernel's time beside its
                bound, plain version and library yardstick, all from this
                run), the card line, and the last line
                ``{"ok": true, "device": {...}}``

Bounds: the larger of the bytes over HBM's rate and the operations over
the tensor cores' rate for the route the kernels take — int8 mmas for int8
x, bf16 mmas otherwise, three per product for float32 x (hi + mid + lo)
unless every value of x is bf16-exact, where one does.

Each path is driven with the launch counts set to 0 just before it and read
just after (the fleet per bucket tick, the trainer per `train` call);
launches made to compare a kernel with its plain version fall outside
those windows.  A captured step's K1 launches are counted on every replay
(the wrapper counts nothing while a graph is being captured).

Timing: CUDA events around a run of launches that were enqueued behind a
spin kernel, after a warm-up, so the figures are device time and not the
host's enqueue rate.  The L2 cache is not flushed between launches: in a
pool tick every layer's input was written by the layer before it and is
found in L2, which is what the timed loop reproduces.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense): HBM3 bytes/s, and the tensor
# cores' int8 and bf16 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.int8: 1979e12, torch.bfloat16: 989e12}

POOL = 8
REPEAT_LAUNCHES = 8  # launches on the same inputs that must give the same bits
# K1 shapes whose float32 route is held on Gaussian x, where every bf16 term counts
K1_GAUSSIAN = ("conv0", "tcn_d1", "5x5_stem")
N_STREAMS = 16
N_FRAMES = 8
TIMED_TICKS = 40    # pool ticks per timed window (phase 4c)
TIMING_ROUNDS = 3   # rounds of captured, eager, eager, captured
SEED = 0
CLASSIFY_BATCH = 256  # images per tick of the classifier (phase 4d)
K1_REPLACES = "src/repro/kernels/ternary_conv2d.py:91"
K1_SOURCE = "src/repro_torch/csrc/ternary_conv2d.cu"
K2_REPLACES = "src/repro/kernels/ternary_matmul.py:62"
K2_SOURCE = "src/repro_torch/csrc/ternary_matmul.cu"
REPO = Path(__file__).resolve().parent

# the deployment path: (net, K1 launches per tick, channels, input, ring)
FLEET_NETS = (("dvs_cnn_tcn", 9, 96, (64, 64), 2, 24),
              ("kws_tcn", 7, 96, (32, 32), 1, 16))
FLEET_CAP = 8
FLEET_SENSORS = 16       # per net: sensors 0-11 in the first wave, 12-15 later
FLEET_WAVE2_TICK = 30    # after the first wave has drained (about tick 20)
GATED_SENSORS = 8        # per net
GATED_DUTY = 0.4

# the training path: (net, K1 launches per deployed eval forward, channels,
# input, input channels, conv layers, tcn layers)
TRAIN_SPATIAL = ("cifar10_tnn", 8, 96, (32, 32), 3, 8, 0)
TRAIN_TEMPORAL = ("dvs_cnn_tcn", 9, 96, (64, 64), 2, 5, 4)
TRAIN_TEMPORAL_RECIPE = {"steps": 10, "batch": 8, "lr": 5e-3}
TRAIN_EVAL_BATCHES = 4
# the captured QAT step (`train`'s `CapturedStep` over `make_qat_step(...,
# donate=True)`) against the raw eager step at full width: (spec, batch)
TRAIN_CAPTURED = ((TRAIN_SPATIAL, 32), (TRAIN_TEMPORAL, 8))
QAT_STEPS = 20           # steps compared bit for bit, and per timed window
QAT_PROFILED = 5         # steps in each torch.profiler window
DETERMINISM_STEPS = 20   # captured QAT steps timed per cuDNN setting, in turns

# the LM serving path: the served config and the SSM config at full published
# width; the 4096-token prefill takes the flash route at its threshold;
# (batch, S) of the full-width prefill -> decode consistency check (mamba's S
# crosses a 256-step SSD chunk); the SMOKE runs' shapes, as the CPU tests'
LM_SERVED = "gemma-2b"
LM_SSM = "mamba2-370m"
LM_LONG = 4096
LM_DECODES = 16            # decode steps timed after a warm-up
LM_CONSISTENCY = {"gemma-2b": (2, 48), "mamba2-370m": (2, 300)}
LM_CONSISTENCY_TOL = 2e-3  # the reference's own (tests/test_arch_smoke.py)
LM_SMOKE_SHAPE = (2, 13, 3)  # batch, prompt, decode steps
LM_SMOKE_TOL = 1e-3        # whole-model float32 logits, as tests/test_torch_lm_model.py
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores (the SSD scan's einsums)

# the LM training path: the served config at full published width under the
# paper's ternary STE, batch 1 x 4096 tokens (the causal flash route, so its
# backward runs): three donating steps eagerly, again eagerly from the same
# seed, then through the launcher's `CapturedStep` (captured == eager bit for
# bit, or, where eager does not repeat its own bits, within the CPU tests'
# tolerances: the loss rel 1e-5, params rtol 1e-3, atol 1e-5), then steps of
# each on the captured step's held state in turns; one float32 step of each
# SMOKE config on the card and on the CPU, as the CPU tests compare them
# (loss, aux and grad norm within 1e-5 / 1e-4, the first moment m = 0.1 *
# clipped grads within rtol 1e-3, atol 1e-5), and LM_TRAIN_SMOKE_STEPS of
# each captured == eager bit for bit; the launcher at full width on the SSM
# config: (arch, steps, resumed steps, checkpoint every); at SMOKE size, an
# injected fault (at step LM_TRAIN_FAULT[0] of LM_TRAIN_FAULT[1]); and its
# full-width step at the launcher's 8 x 64 timed captured against eager in turns
LM_TRAIN_ARCH = "gemma-2b"
LM_TRAIN_SEQ = 4096
LM_TRAIN_STEPS = 3
LM_TRAIN_ROUNDS = 2        # rounds of captured, eager, eager, captured: one step each
LM_TRAIN_OPT = {"lr": 1e-4, "warmup_steps": 2, "total_steps": 10}
LM_TRAIN_TOL = {"loss_rtol": 1e-5, "rtol": 1e-3, "atol": 1e-5}
LM_TRAIN_SMOKE_SHAPE = (4, 16)   # batch, seq
LM_TRAIN_SMOKE_STEPS = 4
LM_TRAIN_SMOKE_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10}
LM_TRAIN_SMOKE_TOL = {"metrics": 1e-5, "grad_norm": 1e-4, "m_rtol": 1e-3, "m_atol": 1e-5}
LM_TRAIN_LAUNCH = ("mamba2-370m", 20, 30, 10)
LM_TRAIN_FAULT = (7, 12, 5)      # fault at step, steps, checkpoint every
LM_TRAIN_LAUNCH_SHAPE = (8, 64)  # the launcher's default batch, seq
LM_TRAIN_LAUNCH_WINDOW = 5       # steps per timed window

# the dry-run: full-width cells on the (16, 16) production mesh (dense train
# and decode, an MoE model's MLA cache, an SSM's cache sequence over every
# axis); the cells held against the card on a (1, 1) mesh of this card: a
# full-width decode step at batch 4 against a 2048-token cache and a SMOKE
# train step
DRYRUN_CELLS = (("gemma-2b", "train_4k"), ("gemma-2b", "decode_32k"),
                ("deepseek-v2-lite-16b", "decode_32k"), ("mamba2-370m", "long_500k"))
DRYRUN_DECODE = ("gemma-2b", 2048, 4)       # arch, cache length, batch
DRYRUN_TRAIN = ("gemma-2b", 64, 4)          # SMOKE arch, seq, batch

# the split pool: full-width dvs_cnn_tcn, pool 8, in two blocks on this card
SHARD_BLOCKS = 2

# the LM on a real mesh: an NCCL group of world size 1 and a (1, 1) mesh of
# this card; the launcher's serving defaults (batch, prompt, tokens: 15
# greedy decodes) and the logits' tolerance against the plain step (the
# reference's own, as LM_CONSISTENCY_TOL); one ternary train step at the
# phase-9 shape, held at the CPU tests' tolerances (the loss within rel
# 1e-5, params rtol 1e-3, atol 1e-5)
SPMD_ARCH = "gemma-2b"
SPMD_SERVE = (4, 32, 16)
SPMD_TOL = 2e-3
SPMD_TIMING_ROUNDS = 2      # rounds of plain, dtensor, dtensor, plain
SPMD_TRAIN_TOL = {"loss_rtol": 1e-5, "rtol": 1e-3, "atol": 1e-5}

# (name, H, W, C_in, C_out, K, pool, input dtype) — the nine launches of one
# pool tick of dvs_cnn_tcn (5 conv + 4 TCN layers; TCN maps carry the extra
# causal top row), batch = pool size on the pool path, 1 in a lone session
MAIN_PATH_SHAPES = [
    ("conv0", 64, 64, 4, 64, 3, 2, torch.float32),
    ("conv1", 32, 32, 64, 64, 3, 2, torch.int8),
    ("conv2", 16, 16, 64, 96, 3, 2, torch.int8),
    ("conv3", 8, 8, 96, 96, 3, 2, torch.int8),
    ("conv4", 4, 4, 96, 96, 3, 2, torch.int8),
    ("tcn_d1", 25, 1, 96, 96, 3, 0, torch.float32),
    ("tcn_d2", 13, 2, 96, 96, 3, 0, torch.int8),
    ("tcn_d4", 7, 4, 96, 96, 3, 0, torch.int8),
    ("tcn_d8", 4, 8, 96, 96, 3, 0, torch.int8),
]
# shapes off the main path that must be right all the same
EXTRA_SHAPES = [
    ("1x1", 16, 16, 64, 64, 1, 0),        # kws_tcn pointwise
    ("5x5_stem", 32, 32, 4, 192, 5, 2),   # cifar10_tnn_wide stem
    ("ragged_cout", 6, 6, 8, 9, 3, 2),
    ("odd_hw", 7, 5, 8, 6, 3, 0),
    ("pool3", 9, 9, 12, 10, 3, 3),
]

# (M, K, N) of K2: the reference's kernel tests, the quickstart (64x2048x512)
# and the kernel bench (512x2048x512), a K the wrapper pads (98 -> 100), and
# K-splits whose boundary falls inside a 64-deep chunk with a ragged last
# split (2052 = 7 x 272 + 148; 260 = 5 x 48 + 20)
MATMUL_SHAPES = [
    (128, 512, 128), (256, 1024, 384), (8, 512, 128), (100, 100, 70),
    (1, 2048, 512), (384, 4, 128), (64, 2048, 512), (512, 2048, 512),
    (7, 98, 33), (64, 2052, 512), (3, 260, 40),
]
MATMUL_TIMED = [(64, 2048, 512), (512, 2048, 512)]  # quickstart first


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ops_ms(ops: int, x: torch.Tensor) -> float:
    """Milliseconds for ``ops`` operations (a multiply-add is two) with x as
    one operand at the tensor cores' peak, on the route the kernels take:
    float32 x costs three bf16 mmas per product (hi + mid + lo), or one when
    every value of x is bf16-exact."""
    if x.dtype == torch.int8:
        return ops / PEAK_OPS_PER_S[torch.int8] * 1e3
    terms = 3 if x.dtype == torch.float32 and not torch.equal(x, x.bfloat16().float()) else 1
    return terms * ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device milliseconds per call of ``fn``.  The calls are enqueued behind
    a spin kernel long enough for the host to run ahead, so the two events
    bracket back-to-back device work and not the host's enqueue rate (a
    wrapper call costs the host more than these kernels cost the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0   # upper bound of the enqueue time
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 1.5 * 2.0e9) + 1_000_000)  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def make_case(gen, b, h, w, c_in, c_out, k, in_dtype, dev):
    """Seeded operands of one launch: trits (multiples of 1/4 for the float
    input, as the ring's pooled features are), packed trit weights, positive
    scales, thresholds that leave all three output values in use."""
    from repro_torch.core.ternary import pack_ternary

    x = torch.randint(-1, 2, (b, h, w, c_in), generator=gen)
    if in_dtype == torch.float32:
        x = x.float() * 0.25 * torch.randint(1, 5, (b, h, w, c_in), generator=gen)
    t = torch.randint(-1, 2, (k, k, c_in, c_out), generator=gen).to(torch.int8)
    scale = torch.rand(c_out, generator=gen) * 0.2 + 0.05
    thr = torch.rand(c_out, generator=gen) * 1.5 + 0.25
    return (x.to(in_dtype).to(dev), pack_ternary(t, axis=2).to(dev),
            scale.to(dev), thr.to(dev))


def check_kernel(dev):
    """Phase 3a: kernel == plain version, tolerance 0, and within 1e-4 on
    Gaussian float32 x.  Returns the largest absolute difference seen on
    each (0.0 when every exact case is equal)."""
    from repro_torch.kernels.ref import ternary_conv2d_ref
    from repro_torch.kernels.ternary_conv2d import (
        ternary_conv2d_cuda,
        ternary_conv2d_native,
    )

    gen = torch.Generator().manual_seed(SEED)
    variants = [  # (fuse_ternary, pooled, out dtype)
        (False, False, torch.float32),
        (True, False, torch.int8),
        (True, True, torch.int8),
        (True, True, torch.float32),
    ]
    cases = []
    for name, h, w, c_in, c_out, k, pool, in_dtype in MAIN_PATH_SHAPES:
        for b in (POOL, 1):
            for dt in (torch.float32, torch.int8):
                cases.append((f"{name}/B{b}", b, h, w, c_in, c_out, k, pool, dt))
    for name, h, w, c_in, c_out, k, pool in EXTRA_SHAPES:
        for dt in (torch.float32, torch.int8):
            cases.append((name, 2, h, w, c_in, c_out, k, pool, dt))
    worst = 0.0
    n = 0
    for name, b, h, w, c_in, c_out, k, pool, dt in cases:
        x, wp, scale, thr = make_case(gen, b, h, w, c_in, c_out, k, dt, dev)
        for tern, pooled, out_dtype in variants:
            if pooled and not pool:
                continue
            kw = dict(fuse_ternary=tern, fuse_pool=pool if pooled else 0,
                      out_dtype=out_dtype)
            got = ternary_conv2d_cuda(x, wp, scale, thr, **kw)
            torch.cuda.synchronize()
            want = ternary_conv2d_native(x, wp, scale, thr, **kw)
            oracle = ternary_conv2d_ref(x, wp, scale, threshold=thr, **kw)
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            n += 1
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"kernel != plain version at {name} {dt} variant "
                     f"{(tern, pooled, out_dtype)}: max|diff|={err}")
            if not torch.equal(got, oracle):
                fail(f"kernel != ref oracle at {name} {dt} variant "
                     f"{(tern, pooled, out_dtype)}")
    # the float32 route on data that is not bf16-exact: the summation order
    # differs, so the tolerance the reference's conv tests use on Gaussian x
    geometry = {s[0]: s[1:7] for s in MAIN_PATH_SHAPES + EXTRA_SHAPES}
    worst_gauss = 0.0
    for name in K1_GAUSSIAN:
        h, w, c_in, c_out, k, pool = geometry[name]
        _, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, torch.float32, dev)
        x = torch.randn((POOL, h, w, c_in), generator=gen).to(dev)
        for fuse_pool in sorted({0, pool}):
            kw = dict(fuse_pool=fuse_pool, out_dtype=torch.float32)
            got = ternary_conv2d_cuda(x, wp, scale, thr, **kw)
            torch.cuda.synchronize()
            want = ternary_conv2d_native(x, wp, scale, thr, **kw)
            err = (got - want).abs().max().item()
            worst_gauss = max(worst_gauss, err)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                fail(f"kernel off the plain version beyond 1e-4 at {name} pool "
                     f"{fuse_pool} on Gaussian float32 x: max|diff|={err}")
    print(f"[chip_smoke] kernels: ternary_conv2d == plain version == ref oracle "
          f"on {n} cases (tolerance 0), max_abs_err {worst}; within 1e-4 on Gaussian "
          f"float32 x at {', '.join(K1_GAUSSIAN)}, max_abs_err {worst_gauss}", flush=True)
    return worst, worst_gauss


def time_kernel(dev):
    """Phase 3b: one pool tick's nine launches at B = POOL on the fused
    int8 variant — kernel, plain version, `F.conv2d` yardstick, and the
    bound worked out from the shapes.  Returns (totals, per-shape rows)."""
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ternary_conv2d import (
        ternary_conv2d_cuda,
        ternary_conv2d_native,
    )

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for name, h, w, c_in, c_out, k, pool, dt in MAIN_PATH_SHAPES:
        x, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, dt, dev)
        kw = dict(fuse_ternary=True, fuse_pool=pool, out_dtype=torch.int8)
        ms = time_ms(lambda: ternary_conv2d_cuda(x, wp, scale, thr, **kw))
        plain_ms = time_ms(lambda: ternary_conv2d_native(x, wp, scale, thr, **kw), iters=10)
        # yardstick only: one cuDNN convolution on pre-decoded float weights
        # (no scale, threshold or pool); the port never calls it
        x_nchw = x.float().permute(0, 3, 1, 2).contiguous()
        w_oihw = unpack_ternary(wp, axis=2).float().permute(3, 2, 0, 1).contiguous()
        library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=k // 2))
        p = pool if pool > 1 else 1
        out_elems = POOL * (h // p) * (w // p) * c_out
        nbytes = (x.numel() * x.element_size() + wp.numel() + 4 * scale.numel()
                  + 4 * thr.numel() + out_elems)  # int8 out: one byte each
        ops = 2 * POOL * h * w * k * k * c_in * c_out
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        op_ms = ops_ms(ops, x)
        rows.append({
            "shape": name, "x": [POOL, h, w, c_in], "x_dtype": str(dt).split(".")[-1],
            "c_out": c_out, "pool": pool, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ms_over_library": ms / library_ms,
            "bytes": nbytes, "operations": ops, "bound_ms": max(bytes_ms, op_ms),
            "bound_by": "bytes" if bytes_ms >= op_ms else "operations",
            "_bytes_ms": bytes_ms, "_ops_ms": op_ms,
        })
        print(f"[chip_smoke]   {name:7s} x{[POOL, h, w, c_in]} {rows[-1]['x_dtype']:7s} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  F.conv2d {library_ms:.4f} ms  "
              f"bound {rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})", flush=True)
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["bound_by"] = ("bytes" if sum(r["_bytes_ms"] for r in rows)
                         >= sum(r["_ops_ms"] for r in rows) else "operations")
    for r in rows:
        del r["_bytes_ms"], r["_ops_ms"]
    return total, rows


def matmul_case(gen, m, k, n, dtype, dev, gaussian=False):
    """Seeded K2 operands: x dyadic (trits times 1/4..1, exact in bf16) or
    Gaussian, packed trit weights [ceil(K/4), N] along K, positive scales."""
    from repro_torch.core.ternary import pack_ternary

    if gaussian:
        x = torch.randn((m, k), generator=gen)
    else:
        x = (torch.randint(-1, 2, (m, k), generator=gen).float() * 0.25
             * torch.randint(1, 5, (m, k), generator=gen))
    k4 = -(-k // 4)
    t = torch.randint(-1, 2, (4 * k4, n), generator=gen).to(torch.int8)
    scale = torch.rand(n, generator=gen) * 0.2 + 0.05
    return x.to(dtype).to(dev), pack_ternary(t, axis=0).to(dev), scale.to(dev)


def check_matmul(dev):
    """Phase 3c: K2 == plain version == oracle (`torch.equal`) on dyadic x;
    within the JAX tests' tolerances on Gaussian x.  Returns the largest
    |kernel - plain version| per dtype over all cases."""
    from repro_torch.kernels.ops import ternary_matmul
    from repro_torch.kernels.ref import ternary_matmul_ref
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_cuda,
        ternary_matmul_native,
    )

    gen = torch.Generator().manual_seed(SEED + 2)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for m, k, n in MATMUL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for gaussian in (False, True):
                x, wp, scale = matmul_case(gen, m, k, n, dt, dev, gaussian)
                before = ternary_matmul_cuda.launches
                got = ternary_matmul(x, wp, scale)
                torch.cuda.synchronize()
                if ternary_matmul_cuda.launches != before + 1:
                    fail(f"ternary_matmul on the card did not launch K2 at {(m, k, n)}")
                xp = F.pad(x, (0, 4 * wp.shape[0] - k))
                want = ternary_matmul_native(xp, wp, scale)
                oracle = ternary_matmul_ref(xp, wp, scale)
                err = (got.float() - want.float()).abs().max().item()
                worst[dt] = max(worst[dt], err)
                n_cases += 1
                where = f"{(m, k, n)} {dt} {'gaussian' if gaussian else 'dyadic'}"
                if got.shape != (m, n) or got.dtype != dt:
                    fail(f"K2 output {tuple(got.shape)} {got.dtype} at {where}")
                if not gaussian:
                    if not torch.equal(got, want):
                        fail(f"K2 != plain version at {where}: max|diff|={err}")
                    if not torch.equal(got, oracle):
                        fail(f"K2 != ternary_matmul_ref at {where}")
                elif not torch.allclose(got.float(), want.float(), rtol=tol[dt], atol=tol[dt]):
                    fail(f"K2 off the plain version beyond {tol[dt]} at {where}: max|diff|={err}")
    print(f"[chip_smoke] kernels: ternary_matmul == plain version == ref oracle on "
          f"{n_cases // 2} dyadic cases (tolerance 0), and within 1e-4 (float32) / "
          f"2e-2 (bf16) on {n_cases // 2} Gaussian cases; max|kernel - plain| "
          f"float32 {worst[torch.float32]}, bf16 {worst[torch.bfloat16]}", flush=True)
    return worst[torch.float32], worst[torch.bfloat16]


def time_matmul(dev):
    """Phase 3d: K2 at the quickstart and kernel-bench shapes — kernel, plain
    version, a `torch.matmul` yardstick on pre-decoded float weights (no
    scale; the port never calls it) and the bound from the shapes."""
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ref import exact_float32
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul_cuda,
        ternary_matmul_native,
    )

    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in MATMUL_TIMED:
            x, wp, scale = matmul_case(gen, m, k, n, dt, dev, gaussian=True)
            ms = time_ms(lambda: ternary_matmul_cuda(x, wp, scale))
            plain_ms = time_ms(lambda: ternary_matmul_native(x, wp, scale), iters=20)
            w_dec = unpack_ternary(wp, axis=0).to(dt)
            with exact_float32():
                library_ms = time_ms(lambda: torch.matmul(x, w_dec))
            nbytes = x.numel() * x.element_size() + wp.numel() + 4 * n + m * n * x.element_size()
            ops = 2 * m * k * n
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            op_ms = ops_ms(ops, x)
            rows.append({
                "shape": [m, k, n], "x_dtype": str(dt).split(".")[-1], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "ms_over_library": ms / library_ms, "bytes": nbytes,
                "operations": ops, "bound_ms": max(bytes_ms, op_ms),
                "bound_by": "bytes" if bytes_ms >= op_ms else "operations",
            })
            print(f"[chip_smoke]   matmul {m}x{k}x{n} {rows[-1]['x_dtype']:8s} kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  torch.matmul {library_ms:.4f} ms  bound "
                  f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})", flush=True)
    return rows


def check_determinism(dev):
    """Phase 3e: each kernel launched REPEAT_LAUNCHES times on the same
    Gaussian inputs gives the same bits every time — the sums run in a fixed
    order, with no atomics.  K1 at the pool-8 shapes of both input types
    (int8 x beyond the trits), K2 at the split and unsplit shapes in both
    types.  Returns the number of cases."""
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

    def same_bits(launch) -> bool:
        outs = [launch() for _ in range(REPEAT_LAUNCHES)]
        torch.cuda.synchronize()
        return all(torch.equal(outs[0], o) for o in outs[1:])

    gen = torch.Generator().manual_seed(SEED + 4)
    n = 0
    for name, h, w, c_in, c_out, k, pool, dt in MAIN_PATH_SHAPES:
        _, wp, scale, thr = make_case(gen, POOL, h, w, c_in, c_out, k, dt, dev)
        x = torch.randn((POOL, h, w, c_in), generator=gen).to(dev)
        if dt == torch.int8:
            x = torch.randint(-100, 101, (POOL, h, w, c_in), generator=gen).to(torch.int8).to(dev)
        kw = dict(fuse_pool=pool, out_dtype=torch.float32)
        if not same_bits(lambda: ternary_conv2d_cuda(x, wp, scale, thr, **kw)):
            fail(f"K1 not deterministic at {name} {dt}: {REPEAT_LAUNCHES} launches differ")
        n += 1
    for m, k, nn in MATMUL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, wp, scale = matmul_case(gen, m, 4 * -(-k // 4), nn, dt, dev, gaussian=True)
            if not same_bits(lambda: ternary_matmul_cuda(x, wp, scale)):
                fail(f"K2 not deterministic at {(m, k, nn)} {dt}: "
                     f"{REPEAT_LAUNCHES} launches differ")
            n += 1
    print(f"[chip_smoke] kernels: {REPEAT_LAUNCHES} launches bit-identical on each of {n} "
          f"Gaussian cases (K1 and K2)", flush=True)
    return n


def serve_main_path(dev):
    """Phase 4: the main path at full width.  Returns (launches counted on
    the main path, serving stats for the report)."""
    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import ContinuousBatcher, StreamRequest

    prog = get_net("dvs_cnn_tcn")
    g = prog.graph
    if (g.feature_channels, g.input_hw, g.tcn_steps) != (96, (64, 64), 24):
        fail(f"dvs_cnn_tcn is not at full width: {g}")
    params = prog.init(torch.Generator().manual_seed(SEED), device=dev)
    frames, labels = DVSEventPipeline(
        N_STREAMS, steps=N_FRAMES, hw=g.input_hw[0], seed=SEED
    ).next_batch()
    deployed = prog.quantize(params, calib=torch.from_numpy(frames).to(dev))

    def run_pool(n_streams, jit=True):
        pool = deployed.serve(POOL, backend="fused", jit=jit)
        batcher = ContinuousBatcher(pool)
        for i in range(n_streams):
            batcher.submit(StreamRequest(
                stream_id=f"sensor-{i}", frames=frames[i], label=int(labels[i]),
                arrival=i,
            ))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = batcher.run()
        torch.cuda.synchronize()
        return batcher, results, time.perf_counter() - t0

    run_pool(2)  # warm-up: first-launch costs stay out of the timed run
    ternary_conv2d_cuda.launches = 0
    batcher, results, wall = run_pool(N_STREAMS)
    launches = ternary_conv2d_cuda.launches

    stats = batcher.stats()
    busy_ticks = len(batcher.latency_trace)
    if len(results) != N_STREAMS:
        fail(f"{len(results)}/{N_STREAMS} streams completed")
    if stats["frames_processed"] != N_STREAMS * N_FRAMES:
        fail(f"{stats['frames_processed']} frames processed, expected "
             f"{N_STREAMS * N_FRAMES}")
    for r in results:
        if r.logits.shape != (g.n_classes,) or not np.isfinite(r.logits).all():
            fail(f"{r.stream_id}: logits not finite or misshaped {r.logits.shape}")
    if launches != 9 * busy_ticks:
        fail(f"{launches} kernel launches over {busy_ticks} pool ticks; the "
             "fused path makes 9 per tick (5 conv + 4 TCN layers)")
    if batcher.pool.trace_count != 1 or not batcher.pool.captured:
        fail(f"the pool's step was captured {batcher.pool.trace_count} times "
             f"(captured: {batcher.pool.captured}); the contract is once")

    # the same churn run on the eager step (jit=False): bit-equal per stream
    by_id = {r.stream_id: r for r in results}
    eager_batcher, eager_results, eager_wall = run_pool(N_STREAMS, jit=False)
    if eager_batcher.pool.captured or len(eager_results) != N_STREAMS:
        fail("the jit=False pool captured its step or lost a stream")
    for r in eager_results:
        if not np.array_equal(r.logits, by_id[r.stream_id].logits):
            fail(f"{r.stream_id}: jit=False logits != jit=True logits")

    # pooled == lone StreamSession (captured) == lone StreamSession (eager)
    for i in (0, 5, N_STREAMS - 1):
        clip = torch.from_numpy(frames[i:i + 1]).to(dev)
        for jit in (True, False):
            session = deployed.stream(batch=1, backend="fused", jit=jit)
            for t in range(N_FRAMES):
                lone = session.step(clip[:, t])
            if session.captured != jit or session.trace_count != 1:
                fail(f"sensor-{i}: lone session jit={jit} captured={session.captured}")
            if not np.array_equal(by_id[f"sensor-{i}"].logits, lone.cpu().numpy()[0]):
                fail(f"sensor-{i}: pooled logits != lone StreamSession(jit={jit}) logits")
    # fused == ref on the card, whole clips through the batch forward
    clips = torch.from_numpy(frames[:2]).to(dev)
    fused = deployed.forward(clips, backend="fused")
    ref = deployed.forward(clips, backend="ref")
    if not torch.equal(fused, ref):
        fail(f"fused != ref on the card: max|diff|={(fused - ref).abs().max().item()}")
    if not np.array_equal(by_id["sensor-0"].logits, fused.cpu().numpy()[0]):
        fail("streamed logits != batch forward logits for sensor-0")

    serving = {
        "net": g.name, "pool": POOL, "streams": N_STREAMS, "frames_per_stream": N_FRAMES,
        "ticks": stats["ticks"], "busy_ticks": busy_ticks,
        "frames_processed": stats["frames_processed"],
        "mean_occupancy": stats["mean_occupancy"],
        "wall_s": wall, "frames_per_s": stats["frames_processed"] / wall,
        "ms_per_tick": wall / busy_ticks * 1e3, "trace_count": batcher.pool.trace_count,
        "eager_wall_s": eager_wall,
        "eager_ms_per_tick": eager_wall / len(eager_batcher.latency_trace) * 1e3,
    }
    print(f"[chip_smoke] serve: {g.name} fused, {N_STREAMS} streams x {N_FRAMES} frames, "
          f"{POOL}-slot pool: {serving['frames_processed']} frames in {busy_ticks} ticks, "
          f"{wall:.3f} s -> {serving['frames_per_s']:.1f} frames/s, "
          f"{serving['ms_per_tick']:.3f} ms/tick (jit=False: "
          f"{serving['eager_ms_per_tick']:.3f}), occupancy "
          f"{serving['mean_occupancy']:.2f}; {launches} kernel launches "
          f"(9 per tick); step captured once; jit=True == jit=False; pooled == lone "
          f"session (captured and eager); fused == ref", flush=True)
    serving["backends_captured_vs_eager"] = _captured_vs_eager_backends(dev)
    serving["tick_times"] = _tick_times(deployed, dev)
    serving["classify"] = _classify_main_path(dev)
    return launches, serving


def _classify_main_path(dev):
    """Phase 4d: the full-width ``cifar10_tnn`` through a 256-image
    `BatchClassifier`: seeded 8-bit images in 12 requests of 1-512 images,
    served to the end.  Gates: every request answered with one row per
    image, each row bit-equal to the eager fused forward of its image, the
    step captured once, 8 K1 launches in each replay.  Returns the run's
    images, ticks, K1 launches, the share of ticks that left their batch
    in flight (the pipelined flush) and images/s."""
    from repro_torch.api import get_net
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda

    prog = get_net("cifar10_tnn")
    g = prog.graph
    convs = [l for l in g.layers if l.kind == "conv2d"]
    if (g.input_hw, len(convs), max(l.c_out for l in convs)) != ((32, 32), 8, 96):
        fail(f"cifar10_tnn is not at full width: {g}")
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(1, 2 * CLASSIFY_BATCH + 1, 12)
    images = ((rng.integers(0, 256, (int(sizes.sum()), *g.input_hw, g.input_ch)) - 128)
              / 128).astype(np.float32)
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(SEED), device=dev),
                             calib=torch.from_numpy(images[:16]).to(dev))
    clf = deployed.classify(CLASSIFY_BATCH)
    ends = np.cumsum(sizes)
    for i, (lo, hi) in enumerate(zip(ends - sizes, ends)):
        clf.submit(f"request-{i}", images[lo:hi])
    ternary_conv2d_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers, inflight = {}, 0
    while clf.pending:  # clf.run(), counting the ticks that left their batch on the card
        answers.update(clf.tick()[1])
        inflight += clf.inflight
    wall = time.perf_counter() - t0
    launches = ternary_conv2d_cuda.launches
    if len(answers) != len(sizes) or [len(answers[f"request-{i}"]) for i in
                                      range(len(sizes))] != sizes.tolist():
        fail(f"classify: {len(answers)}/{len(sizes)} requests answered, or rows != images")
    got = np.concatenate([answers[f"request-{i}"] for i in range(len(sizes))])
    # the eager fused forward launches the same K1 as the replays; the plain
    # path ("ref": float32 conv, no kernel of the port) holds K1 itself to
    # its arithmetic at this batch and on these 8-bit pixel inputs
    for lo in range(0, len(images), CLASSIFY_BATCH):
        x = torch.from_numpy(images[lo:lo + CLASSIFY_BATCH]).to(dev)
        for backend in ("fused", "ref"):
            want = deployed.forward(x, backend=backend).cpu().numpy()
            if not np.array_equal(got[lo:lo + len(want)], want):
                fail(f"classify: images {lo}.. served != the eager {backend} forward")
    if np.abs(got).max() == 0:
        fail("classify: every logit is zero; the comparison would be vacuous")
    if clf.trace_count != 1 or not clf.captured or clf.step.k1_per_replay != 8:
        fail(f"classify: {clf.trace_count} captures (captured {clf.captured}), "
             f"{clf.step.k1_per_replay} K1 launches a replay; the contract is 1 and 8")
    if launches != 8 * clf.tick_index:
        fail(f"classify: {launches} K1 launches over {clf.tick_index} ticks, expected 8 a tick")
    out = {"net": g.name, "batch": CLASSIFY_BATCH, "requests": len(sizes),
           "images": int(sizes.sum()), "ticks": clf.tick_index, "k1_launches": launches,
           "inflight_share": inflight / clf.tick_index,
           "wall_s": wall, "images_per_s": int(sizes.sum()) / wall}
    print(f"[chip_smoke] classify: {g.name} fused, {out['images']} images in "
          f"{len(sizes)} requests, batch {CLASSIFY_BATCH}: {clf.tick_index} ticks, "
          f"{wall:.3f} s -> {out['images_per_s']:.0f} images/s (first tick builds); "
          f"{launches} K1 launches (8 per tick), step captured once; "
          f"{inflight}/{clf.tick_index} ticks left their batch in flight; served == eager "
          f"fused == ref forward on every image", flush=True)
    return out


def _captured_vs_eager_backends(dev):
    """Phase 4b: on ``dvs_cnn_tcn_smoke``, a churn run (6 streams x 6
    frames through a 4-slot pool) on every backend with the captured step
    (``jit=True``) and the eager one: bit-equal logits, one capture, and 9
    K1 launches per tick on the two kernel backends, none on ``ref`` /
    ``bitsim``.  Returns the per-backend ticks and K1 launches."""
    from repro_torch.api import BACKENDS, get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import ContinuousBatcher, StreamRequest

    prog = get_net("dvs_cnn_tcn_smoke")
    g = prog.graph
    frames, _ = DVSEventPipeline(6, steps=6, hw=g.input_hw[0], seed=SEED).next_batch()
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(SEED), device=dev),
                             calib=torch.from_numpy(frames).to(dev))
    out = {}
    for backend in BACKENDS:
        logits = {}
        for jit in (True, False):
            pool = deployed.serve(4, backend=backend, jit=jit)
            batcher = ContinuousBatcher(pool)
            for i in range(6):
                batcher.submit(StreamRequest(f"s{i}", frames[i], arrival=i))
            ternary_conv2d_cuda.launches = 0
            logits[jit] = {r.stream_id: r.logits for r in batcher.run()}
            busy = len(batcher.latency_trace)
            per_tick = 9 if backend in ("fused", "kernel") else 0
            if ternary_conv2d_cuda.launches != per_tick * busy:
                fail(f"{backend} jit={jit}: {ternary_conv2d_cuda.launches} K1 launches "
                     f"over {busy} ticks, expected {per_tick} per tick")
            if pool.trace_count != 1 or pool.captured != jit:
                fail(f"{backend} jit={jit}: trace_count {pool.trace_count}, "
                     f"captured {pool.captured}")
        for sid, want in logits[False].items():
            if not np.array_equal(logits[True][sid], want):
                fail(f"{backend}: captured step != eager step for {sid}")
        out[backend] = {"busy_ticks": busy, "k1_launches": ternary_conv2d_cuda.launches}
    print(f"[chip_smoke] serve: dvs_cnn_tcn_smoke captured == eager on "
          f"{', '.join(out)} (one capture each)", flush=True)
    return out


def _tick_times(deployed, dev):
    """Phase 4c: a full pool-8 tick of the served program through
    `SessionPool.step` (host assembly included), captured (``jit=True``)
    and eager, timed in turns — captured, eager, eager, captured, for
    ``TIMING_ROUNDS`` rounds of ``TIMED_TICKS`` ticks ending in a
    synchronise — then one `torch.profiler` window of each for the device
    time.  Returns host ms/tick (each window and the median), frames/s,
    device ms and kernels per tick and the busy share (device ms over
    the median host ms) of each."""
    from repro_torch.data.pipeline import DVSEventPipeline

    g = deployed.graph
    frames, _ = DVSEventPipeline(POOL, steps=TIMED_TICKS + 5, hw=g.input_hw[0],
                                 seed=SEED + 1).next_batch()
    pools = {}
    for jit in (True, False):
        pool = pools[jit] = deployed.serve(POOL, backend="fused", jit=jit)
        for i in range(POOL):
            pool.admit(f"s{i}")

    def ticks(pool, lo=5, hi=5 + TIMED_TICKS):
        for t in range(lo, hi):
            pool.step({f"s{i}": frames[i, t] for i in range(POOL)})

    for pool in pools.values():
        ticks(pool, 0, 5)  # warm-up; the jit=True pool captures here
    torch.cuda.synchronize()
    host = {True: [], False: []}
    for _ in range(TIMING_ROUNDS):
        for jit in (True, False, False, True):
            t0 = time.perf_counter()
            ticks(pools[jit])
            torch.cuda.synchronize()
            host[jit].append((time.perf_counter() - t0) / TIMED_TICKS * 1e3)
    out = {}
    for jit, name in ((True, "captured"), (False, "eager")):
        n, device_ms, _top = _profile_kernels(lambda: ticks(pools[jit]))
        median = float(np.median(host[jit]))
        out[name] = {
            "host_ms_per_tick": host[jit], "host_ms_per_tick_median": median,
            "frames_per_s": POOL / median * 1e3,
            "device_ms_per_tick": device_ms / TIMED_TICKS if n else None,
            "device_events_per_tick": n / TIMED_TICKS if n else None,
            "device_busy_share": device_ms / TIMED_TICKS / median if n else None,
        }
        if pools[jit].trace_count != 1 or pools[jit].captured != jit:
            fail(f"timed pool jit={jit}: trace_count {pools[jit].trace_count}")
    for name, o in out.items():
        print(f"[chip_smoke] serve: pool {POOL} {name}: host ms/tick "
              + " ".join(f"{v:.4f}" for v in o["host_ms_per_tick"])
              + f" (median {o['host_ms_per_tick_median']:.4f}, "
              f"{o['frames_per_s']:.1f} frames/s); device "
              + ("not measured (the profiler saw no device events)"
                 if o["device_ms_per_tick"] is None else
                 f"{o['device_ms_per_tick']:.4f} ms/tick over "
                 f"{o['device_events_per_tick']:.1f} events, busy {o['device_busy_share']:.3f}"),
              flush=True)
    return out


def quickstart_path(dev):
    """Phase 5: the quickstart path on the card, with the launch counts set
    to 0 just before it and read just after.  Returns the counts."""
    from repro_torch import quickstart
    from repro_torch.api import BACKENDS, get_graph, get_net, silicon_report
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
    from repro_torch.sim import reconcile

    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    rc = quickstart.main(["--device", "cuda", "--seed", str(SEED)])
    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    if rc != 0:
        fail(f"repro_torch.quickstart exited {rc} on the card")
    if launches["ternary_matmul"] < 1 or launches["ternary_conv2d"] < 1:
        fail(f"the quickstart did not go through both kernels: {launches}")

    # two full-width dvs_cnn_tcn clips on every deploy backend
    prog = get_net("dvs_cnn_tcn")
    frames, _ = DVSEventPipeline(2, steps=N_FRAMES, hw=prog.graph.input_hw[0],
                                 seed=SEED).next_batch()
    clips = torch.from_numpy(frames).to(dev)
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(SEED), device=dev),
                             calib=clips)
    logits = {b: deployed.forward(clips, backend=b) for b in BACKENDS}
    for b, y in logits.items():
        if not torch.equal(y, logits["ref"]):
            fail(f"dvs_cnn_tcn: {b} != ref on the card: "
                 f"max|diff|={(y - logits['ref']).abs().max().item()}")
    session = deployed.stream(batch=1, backend="bitsim")
    for t in range(N_FRAMES):
        streamed = session.step(clips[:1, t])
    if not torch.equal(streamed, logits["bitsim"][:1]):
        fail("dvs_cnn_tcn: bitsim stream != bitsim batch forward")

    # the silicon model: every committed row of the reference's sweep
    rows = json.loads((REPO / "BENCH_silicon.json").read_text())["results"]
    for r in rows:
        g = get_graph(r["net"])
        rep = silicon_report(g, v=r["v"], source=r["source"])
        rec = reconcile(g)
        got = {
            "cycles": rep.ideal.cycles, "ideal_energy_uj": rep.ideal.energy_j * 1e6,
            "ideal_inf_per_s": rep.ideal.inf_per_s, "energy_uj": rep.energy_uj,
            "inf_per_s": rep.inf_per_s, "calibrated": rep.calibrated is not None,
            "analytic_schedulable": rec["analytic_schedulable"],
            "divergence_at_0v5": rec["divergence"], "stall_cycles": rec["stall_cycles"],
        }
        diff = {key: (r[key], val) for key, val in got.items() if r[key] != val}
        if diff:
            fail(f"silicon model != reference at {r['net']} {r['v']} V {r['source']}: {diff}")
    cifar = silicon_report(get_graph("cifar10_tnn"), v=0.5)
    print(f"[chip_smoke] quickstart: OK on the card; {launches} launches; "
          f"dvs_cnn_tcn fused == kernel == ref == bitsim on 2 clips x {N_FRAMES} frames, "
          f"bitsim stream == batch; {len(rows)} BENCH_silicon.json rows reproduced exactly "
          f"(CIFAR {cifar.energy_uj:.2f} uJ, {cifar.inf_per_s:.0f} inf/s)", flush=True)
    return launches


def _fleet_clips(g, n, duty, seed):
    """Seeded clips of ``n`` sensors x N_FRAMES frames from the net's own
    pipeline (DVS events for 2 channels, KWS spectrograms for 1)."""
    from repro_torch.data.pipeline import DVSEventPipeline, KWSSpectrogramPipeline

    cls = DVSEventPipeline if g.input_ch == 2 else KWSSpectrogramPipeline
    return cls(n, steps=N_FRAMES, hw=g.input_hw[0], n_classes=g.n_classes,
               seed=seed, duty_cycle=duty).next_batch()


def _lone_logits(program, clip, frame_idx, dev):
    """Final logits of a lone batch-1 `StreamSession` on ``program`` fed
    exactly ``frame_idx``'s frames (None when that is no frame)."""
    session = program.stream(batch=1, backend="fused")
    out = None
    for t in frame_idx:
        out = session.step(torch.from_numpy(clip[t][None]).to(dev))
    return None if out is None else out.cpu().numpy()[0]


def _run_fleet(programs, requests, ingest, gate=None):
    """One `FleetRouter` run on ``fused`` with ``programs`` registered.
    Counts K1 launches per bucket tick and the pool objects each rung
    shows.  Returns (router, results, wall seconds, per-bucket launches,
    per-bucket {rung: set of pool ids})."""
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import FleetRouter

    router = FleetRouter(backend="fused", max_pool_size=FLEET_CAP, ingest=ingest,
                         gate=gate)
    for name, program in programs.items():
        router.register(name, program)
    launches = {name: 0 for name in programs}
    pools_seen = {name: {} for name in programs}
    for name, bucket in router.buckets.items():
        def counted(tick=bucket.tick, name=name, bucket=bucket):
            before = ternary_conv2d_cuda.launches
            out = tick()
            launches[name] += ternary_conv2d_cuda.launches - before
            pools_seen[name].setdefault(bucket.size, set()).add(id(bucket.batcher.pool))
            return out
        bucket.tick = counted
    router.submit_many(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router.close()
    return router, results, wall, launches, pools_seen


def fleet_path(dev):
    """Phase 6: the deployment path at full width — ship two ``.cutie``
    programs, load them on the card, serve them through one gated and one
    ungated `FleetRouter`, then through the launcher.  Returns the ``fleet``
    report."""
    from repro_torch import artifact
    from repro_torch.api import get_net
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import ActivityGate, StreamRequest, energy_summary

    t_phase = time.perf_counter()
    loaded, clips, labels = {}, {}, {}
    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    for idx, (name, per_tick, ch, hw, in_ch, steps) in enumerate(FLEET_NETS):
        prog = get_net(name)
        g = prog.graph
        if (g.feature_channels, tuple(g.input_hw), g.input_ch, g.tcn_steps) != (ch, hw, in_ch, steps):
            fail(f"{name} is not at full width: {g}")
        clips[name], labels[name] = _fleet_clips(g, FLEET_SENSORS, 1.0, SEED + idx)
        deployed = prog.quantize(
            prog.init(torch.Generator().manual_seed(SEED), device=dev),
            calib=torch.from_numpy(clips[name]).to(dev))
        data = artifact.assemble(deployed)
        program = loaded[name] = artifact.loads(data, device=dev)
        if program.to_bytes() != data:
            fail(f"{name}: LoadedProgram.to_bytes() != the assembled bytes")
        if artifact.reassemble(artifact.disassemble(data)) != data:
            fail(f"{name}: disassemble -> reassemble is not byte-identical")
        (build_dir / f"chip_smoke_{name}.cutie").write_bytes(data)
        clip = torch.from_numpy(clips[name][:1]).to(dev)
        got = {b: program.forward(clip, backend=b) for b in ("fused", "ref", "bitsim")}
        want = deployed.forward(clip, backend="fused")
        for b, y in got.items():
            if not torch.equal(y, want):
                fail(f"{name}: loaded {b} != DeployedProgram fused on an {N_FRAMES}-frame "
                     f"clip: max|diff|={(y - want).abs().max().item()}")
        print(f"[chip_smoke] fleet: {name} -> {len(data)} .cutie bytes, loaded on the "
              f"card; to_bytes and dis/asm identical; fused == ref == bitsim == "
              f"deployed", flush=True)

    # the ungated fleet: two waves per net, the first overshooting the cap
    requests = []
    for idx, (name, *_rest) in enumerate(FLEET_NETS):
        for s in range(FLEET_SENSORS):
            arrival = idx + s // 4 if s < 12 else FLEET_WAVE2_TICK
            requests.append(StreamRequest(
                stream_id=f"{name}/sensor-{s}", frames=clips[name][s],
                label=int(labels[name][s]), arrival=arrival, net=name))
    ternary_conv2d_cuda.launches = 0
    router, results, wall, launches, pools_seen = _run_fleet(loaded, requests, "thread")
    total_launches = ternary_conv2d_cuda.launches
    stats = router.stats()
    n_streams = FLEET_SENSORS * len(FLEET_NETS)
    if len(results) != n_streams:
        fail(f"fleet: {len(results)}/{n_streams} streams completed")
    by_id = {r.stream_id: r for r in results}
    for r in results:
        if r.logits is None or not np.isfinite(r.logits).all():
            fail(f"fleet: {r.stream_id} logits missing or not finite")
        name, s = r.net, int(r.stream_id.rsplit("-", 1)[1])
        lone = _lone_logits(loaded[name], clips[name][s], range(N_FRAMES), dev)
        if not np.array_equal(r.logits, lone):
            fail(f"fleet: {r.stream_id} pooled logits != lone StreamSession")
    per_bucket = {}
    for name, per_tick, *_rest in FLEET_NETS:
        s = stats["nets"][name]
        reasons = [e["reason"] for e in s["scale_events"]]
        busy = len(router.buckets[name].batcher.latency_trace)
        if "grow" not in reasons or "shrink" not in reasons:
            fail(f"fleet: {name} scale events {reasons} lack a grow and a shrink")
        if any(n != 1 for n in s["pools_built"].values()):
            fail(f"fleet: {name} pools built {s['pools_built']} (1 per rung)")
        if any(len(ids) != 1 for ids in pools_seen[name].values()):
            fail(f"fleet: {name} ran more than one pool object on a rung")
        if set(pools_seen[name]) != set(s["pools_built"]):
            fail(f"fleet: {name} rungs seen {sorted(pools_seen[name])} != built")
        if any(tc > 1 for tc in s["pools_traced"].values()):
            fail(f"fleet: {name} step programs {s['pools_traced']} (<= 1 per pool)")
        stepped = {size for size, _ in router.buckets[name].batcher.latency_trace}
        bucket_pools = router.buckets[name].pools
        if any(s["pools_traced"][size] != 1 or not bucket_pools[size].captured
               for size in stepped):
            fail(f"fleet: {name} pools that stepped {sorted(stepped)} captured "
                 f"{s['pools_traced']} (each once)")
        if not s["ingest_threaded"]:
            fail(f"fleet: {name} feeder did not run on its thread")
        if launches[name] != per_tick * busy:
            fail(f"fleet: {name} made {launches[name]} K1 launches over {busy} "
                 f"busy ticks; expected {per_tick} per tick")
        per_bucket[name] = {
            "busy_ticks": busy, "k1_launches": launches[name],
            "k1_launches_per_tick": launches[name] / busy,
            "scale_events": [f"{e['from_size']}->{e['to_size']}@{e['tick']}"
                             for e in s["scale_events"]],
            "pools_built": s["pools_built"], "pools_traced": s["pools_traced"],
            "rungs_stepped": sorted(stepped),
            "ms_per_tick_by_rung": {
                str(size): {"ticks": v["ticks"], "p50": v["p50_ms"], "p99": v["p99_ms"]}
                for size, v in s["latency_by_pool_size"].items()},
        }
    if total_launches != sum(launches.values()):
        fail(f"fleet: {total_launches} K1 launches in the run, "
             f"{sum(launches.values())} inside bucket ticks")
    frames = stats["aggregate"]["frames_processed"]
    _, sync_results, sync_wall, _, _ = _run_fleet(loaded, requests, "sync")
    for r in sync_results:
        if not np.array_equal(r.logits, by_id[r.stream_id].logits):
            fail(f"fleet: {r.stream_id} ingest=sync != ingest=thread")
    print(f"[chip_smoke] fleet: {n_streams} streams x {N_FRAMES} frames over "
          f"{stats['aggregate']['ticks']} ticks, {wall:.3f} s -> {frames / wall:.1f} "
          f"frames/s (ingest=sync: {frames / sync_wall:.1f}); == lone sessions; sync == thread; "
          + "; ".join(f"{n}: {b['scale_events']}, K1 {b['k1_launches_per_tick']:.0f}/tick"
                      for n, b in per_bucket.items()), flush=True)

    # the gated fleet: bursty traces, ActivityGate(16, 4, 2)
    gate = ActivityGate(16, 4, 2)
    g_clips, g_requests = {}, []
    for idx, (name, *_rest) in enumerate(FLEET_NETS):
        g_clips[name], g_labels = _fleet_clips(loaded[name].graph, GATED_SENSORS,
                                               GATED_DUTY, SEED + 10 + idx)
        for s in range(GATED_SENSORS):
            g_requests.append(StreamRequest(
                stream_id=f"{name}/gated-{s}", frames=g_clips[name][s],
                label=int(g_labels[s]), arrival=idx + s * len(FLEET_NETS), net=name))
    ternary_conv2d_cuda.launches = 0
    g_router, g_results, g_wall, g_launches, _ = _run_fleet(loaded, g_requests, "thread", gate)
    g_stats = g_router.stats()
    if len(g_results) != GATED_SENSORS * len(FLEET_NETS):
        fail(f"gated fleet: {len(g_results)} streams completed")
    for r in g_results:
        name, s = r.net, int(r.stream_id.rsplit("-", 1)[1])
        clip = g_clips[name][s]
        plan = gate.plan([ActivityGate.activity(f) for f in clip])
        processed = [t for t, p in enumerate(plan) if p]
        if r.frames_processed != len(processed):
            fail(f"gated fleet: {r.stream_id} processed {r.frames_processed} frames, "
                 f"plan says {len(processed)}")
        lone = _lone_logits(loaded[name], clip, processed, dev)
        if (lone is None) != (r.logits is None) or (
                lone is not None and not np.array_equal(r.logits, lone)):
            fail(f"gated fleet: {r.stream_id} != a lone session fed the plan's frames")
    energy = {}
    for name, per_tick, *_rest in FLEET_NETS:
        sg = g_stats["nets"][name]["gating"]
        busy = len(g_router.buckets[name].batcher.latency_trace)
        if g_launches[name] != per_tick * busy:
            fail(f"gated fleet: {name} made {g_launches[name]} K1 launches over "
                 f"{busy} busy ticks")
        g_bucket = g_router.buckets[name]
        g_stepped = {size for size, _ in g_bucket.batcher.latency_trace}
        if any(g_bucket.pools[size].trace_count != 1 or not g_bucket.pools[size].captured
               for size in g_stepped):
            fail(f"gated fleet: {name} pools that stepped {sorted(g_stepped)} captured "
                 f"{g_stats['nets'][name]['pools_traced']} (each once)")
        e = energy_summary(
            loaded[name], frames_processed=sg["frames_processed"],
            frames_total=sg["frames_processed"] + sg["frames_skipped"],
            completed=sum(1 for r in g_results if r.net == name and r.logits is not None))
        if not e["energy_uj_saved"] > 0.0:
            fail(f"gated fleet: {name} saves no energy ({e['energy_uj_saved']} uJ)")
        energy[name] = {
            "frames_processed": sg["frames_processed"],
            "frames_skipped": sg["frames_skipped"], "parks": sg["parks"],
            "wakes": sg["wakes"], "busy_ticks": busy,
            "k1_launches_per_tick": g_launches[name] / busy,
            "silicon_model_uj_saved": e["energy_uj_saved"],
            "silicon_model_uj_per_classification": e["energy_uj_per_classification"],
            "silicon_model_uj_per_classification_ungated":
                e["energy_uj_per_classification_ungated"],
        }
    g_frames = g_stats["aggregate"]["frames_processed"]
    print(f"[chip_smoke] gated fleet: {g_frames} frames processed, "
          f"{g_stats['gating']['frames_skipped']} skipped, {g_wall:.3f} s; processed == "
          f"plan, == lone sessions; silicon-model uJ saved "
          + ", ".join(f"{n} {e['silicon_model_uj_saved']:.3f}" for n, e in energy.items()),
          flush=True)

    # the launcher, as a user runs it
    dvs_file = build_dir / f"chip_smoke_{FLEET_NETS[0][0]}.cutie"
    for argv in (["--dvs", "--program", str(dvs_file), "--pool", str(FLEET_CAP)],
                 ["--fleet", "--fleet-nets", ",".join(n for n, *_ in FLEET_NETS),
                  "--pool", str(FLEET_CAP), "--gate"]):
        rc = launch_serve.main(argv + ["--device", "cuda", "--seed", str(SEED)])
        if rc != 0:
            fail(f"repro_torch.launch.serve {' '.join(argv)} exited {rc}")
    print("[chip_smoke] fleet: launcher --dvs --program and --fleet --gate exit 0",
          flush=True)
    return {
        "nets": [n for n, *_ in FLEET_NETS], "ladder_cap": FLEET_CAP,
        "ungated": {
            "streams": n_streams, "frames": frames, "ticks": stats["aggregate"]["ticks"],
            "wall_s": wall, "frames_per_s": frames / wall,
            "sync_ingest_wall_s": sync_wall, "sync_ingest_frames_per_s": frames / sync_wall,
            "k1_launches": total_launches, "buckets": per_bucket,
        },
        "gated": {
            "streams": len(g_results), "frames_processed": g_frames,
            "frames_skipped": g_stats["gating"]["frames_skipped"],
            "ticks": g_stats["aggregate"]["ticks"], "wall_s": g_wall,
            "frames_per_s": g_frames / g_wall, "buckets": energy,
        },
        "phase_s": time.perf_counter() - t_phase,
    }


def _check_width(graph, spec):
    name, _per_eval, ch, hw, in_ch, n_conv, n_tcn = spec
    kinds = [l.kind for l in graph.layers]
    got = (graph.feature_channels if graph.is_temporal else
           max(l.c_out for l in graph.layers if l.kind == "conv2d"),
           tuple(graph.input_hw), graph.input_ch, kinds.count("conv2d"), kinds.count("tcn"))
    if got != (ch, hw, in_ch, n_conv, n_tcn):
        fail(f"{name} is not at full width: {got}")


def _qat_setup(spec, batch, dev):
    """(program, AdamW config, QAT_STEPS numpy batches, a fresh train state)
    of a full-width registry net, as `train` builds them."""
    import dataclasses

    from repro_torch.api import CutieProgram, get_graph
    from repro_torch.data.pipeline import pipeline_for_net
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import init_train_state

    graph = dataclasses.replace(get_graph(spec[0]), qat_per_channel=True)
    _check_width(graph, spec)
    prog = CutieProgram(graph)
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200, weight_decay=0.0)
    pipe = pipeline_for_net(graph, batch, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(QAT_STEPS)]
    return prog, cfg, batches, init_train_state(prog, torch.Generator().manual_seed(SEED),
                                                device=dev)


def _qat_captured_vs_eager(spec, batch, dev):
    """`train`'s captured, donated QAT step against the raw eager step (the
    function the reference wraps in ``jax.jit``) from one state on the same
    QAT_STEPS batches: loss, every metric, param, m, v and the step counter
    bit for bit, one capture.  Then host ms per step as `train` runs them
    (numpy batch in, the loss read), captured and eager in turns, and a
    `torch.profiler` window of each: device ms, kernels, busy share."""
    from repro_torch.capture import CapturedStep
    from repro_torch.train import make_qat_step
    from repro_torch.tree import tree_leaves, tree_map

    name = spec[0]
    prog, cfg, batches, a = _qat_setup(spec, batch, dev)
    b = tree_map(torch.clone, a)
    raw = make_qat_step(prog, cfg)
    step = CapturedStep(make_qat_step(prog, cfg, donate=True), dev, inputs=(1,))

    def eager(state, nb):  # the batch moved to the card per step, as before capture
        return raw(state, tuple(torch.from_numpy(x).to(dev) for x in nb))

    for i, nb in enumerate(batches):
        a, ma = eager(a, nb)
        b, mb = step(b, nb)
        for key in ma:
            if not torch.equal(ma[key], mb[key]):
                fail(f"train {name}: captured step {i} {key} {float(mb[key])!r} != eager "
                     f"{float(ma[key])!r}")
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        if not torch.equal(x, y):
            fail(f"train {name}: after {QAT_STEPS} steps, state leaf {i} {tuple(x.shape)} "
                 f"captured != eager")
    if step.builds != 1 or not step.captured:
        fail(f"train {name}: the step was built {step.builds} times (captured: {step.captured})")

    def window(fn, state, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for nb in batches[:n]:
            state, m = fn(state, nb)
            float(m["loss"])  # train() reads each loss
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3 / n

    host = {"captured": [], "eager": []}
    for _ in range(TIMING_ROUNDS):
        for kind in ("captured", "eager", "eager", "captured"):
            if kind == "captured":
                b, ms = window(step, b, QAT_STEPS)
            else:
                a, ms = window(eager, a, QAT_STEPS)
            host[kind].append(ms)
    out = {"batch": batch, "steps_compared": QAT_STEPS, "bit_equal": True,
           "builds": step.builds, "host_ms_per_step": host}
    for kind, fn, state in (("captured", step, b), ("eager", eager, a)):
        n, dev_ms, top = _profile_kernels(lambda: window(fn, state, QAT_PROFILED))
        med = float(np.median(host[kind]))
        out[kind] = {
            "host_ms_per_step_median": med,
            "device_kernels_per_step": n / QAT_PROFILED if n else None,
            "device_ms_per_step": dev_ms / QAT_PROFILED if n else None,
            "device_busy_share": dev_ms / QAT_PROFILED / med if n else None,
            "top_kernels_ms": [[k, ms / QAT_PROFILED] for k, ms in top] if n else None,
        }
    c, e = out["captured"], out["eager"]
    print(f"[chip_smoke] train: {name} batch {batch}: captured == eager over {QAT_STEPS} "
          f"steps, 1 capture; host ms/step captured {c['host_ms_per_step_median']:.3f} vs "
          f"eager {e['host_ms_per_step_median']:.3f} (medians of {2 * TIMING_ROUNDS} windows "
          f"in turns); device ms {c['device_ms_per_step']} vs {e['device_ms_per_step']}, "
          f"busy {c['device_busy_share']} vs {e['device_busy_share']}", flush=True)
    return out


def _captured_step_device_ms(dev):
    """Device ms per captured full-width ``cifar10_tnn`` QAT step (batch 32)
    with cuDNN deterministic and not autotuned (the trainer's setting,
    `kernels.ref.deterministic_float32`) or autotuned and free to pick any
    algorithm, TF32 off in both; timed in turns (deterministic, autotuned,
    autotuned, deterministic) with CUDA events, the batch on the card."""
    import contextlib

    import repro_torch.train.loop as loop
    from repro_torch.capture import CapturedStep
    from repro_torch.tree import tree_map

    prog, cfg, batches, state = _qat_setup(TRAIN_SPATIAL, 32, dev)
    batch = tuple(torch.from_numpy(x).to(dev) for x in batches[0])

    @contextlib.contextmanager
    def autotuned():
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                        allow_tf32=False):
            yield

    steps = {}
    for deterministic in (True, False):
        s = tree_map(torch.clone, state)
        step = CapturedStep(loop.make_qat_step(prog, cfg, donate=True), dev, inputs=(1,))
        # the step enters loop.deterministic_float32; the algorithms are
        # chosen in the eager warm-up and the capture, which replays keep
        saved = loop.deterministic_float32
        if not deterministic:
            loop.deterministic_float32 = autotuned
        try:
            step(s, batch)
            step(s, batch)
        finally:
            loop.deterministic_float32 = saved
        steps[deterministic] = (step, s)
    det, fast = [], []
    for deterministic in (True, False, False, True):
        step, s = steps[deterministic]
        (det if deterministic else fast).append(
            time_ms(lambda: step(s, batch), iters=DETERMINISM_STEPS, warmup=2))
    return det, fast


class _TwoSizes:
    """A pipeline whose batch at an odd step drops its last row: eval batches
    of two shapes."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.state = pipe.state

    def batch_at(self, step):
        x, y = self.pipe.batch_at(step)
        return (x[:-1], y[:-1]) if step % 2 else (x, y)


def _eval_two_shapes(rep, batch, dev):
    """`evaluate` of the trained full-width net over eval batches of two
    sizes: hits equal the plain forwards', each forward captured once per
    shape, and K1 launched per batch as the captures recorded it."""
    import dataclasses

    from repro_torch.api import CutieProgram, get_graph
    from repro_torch.data.pipeline import pipeline_for_net
    from repro_torch.kernels.ref import deterministic_float32
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.train.evaluate import eval_batches, evaluate

    name, per_eval = TRAIN_SPATIAL[0], TRAIN_SPATIAL[1]
    prog = CutieProgram(dataclasses.replace(get_graph(name), qat_per_channel=True))
    pipe = _TwoSizes(pipeline_for_net(prog.graph, batch, seed=SEED))
    n_batches = TRAIN_EVAL_BATCHES
    ternary_conv2d_cuda.launches = 0
    recorded = ternary_conv2d_cuda.recorded
    e = evaluate(prog, rep.params, pipe, deployed=rep.deployed, n_batches=n_batches,
                 nu=rep.nu_final)
    launches = ternary_conv2d_cuda.launches
    captured = ternary_conv2d_cuda.recorded - recorded
    hq = hd = n = 0
    with torch.no_grad(), deterministic_float32():
        for x, y in eval_batches(pipe, n_batches):
            xt = torch.from_numpy(x).to(dev)
            hq += int((prog.forward_qat(rep.params, xt, nu=rep.nu_final).argmax(-1).cpu()
                       .numpy() == y).sum())
            hd += int((rep.deployed.forward(xt, backend="fused").argmax(-1).cpu().numpy()
                       == y).sum())
            n += len(y)
    if (e.qat_accuracy, e.deployed_accuracy, e.n_examples) != (hq / n, hd / n, n):
        fail(f"evaluate over two batch shapes: {e.summary()} != plain forwards qat "
             f"{hq}/{n}, deployed {hd}/{n}")
    if e.step_builds != 2 * 2:
        fail(f"evaluate over two batch shapes: {e.step_builds} builds, not one per "
             f"forward and shape (4)")
    if captured != 2 * per_eval or launches != per_eval * n_batches:
        fail(f"evaluate over two batch shapes: {launches} K1 launches over {n_batches} "
             f"batches, {captured} recorded by captures; the deployed forward makes "
             f"{per_eval} per batch, captured once per shape")
    print(f"[chip_smoke] train: evaluate {name} over batches of {batch} and {batch - 1}: "
          f"{e.summary()} == plain forwards; {e.step_builds} captures (2 forwards x 2 "
          f"shapes); {launches} K1 launches, {captured} recorded", flush=True)
    return {"n_examples": e.n_examples, "qat_accuracy": e.qat_accuracy,
            "deployed_accuracy": e.deployed_accuracy, "step_builds": e.step_builds,
            "k1_launches": launches, "k1_recorded_by_captures": captured,
            "equals_plain_forwards": True}


def train_path(dev):
    """Phase 7: the training path at full width, then a resume on the card
    and the launcher with its trace.  Returns (the ``train`` report, K1
    launches of the full-width spatial run)."""
    import dataclasses

    from repro_torch.api import CutieProgram, get_graph
    from repro_torch.data.pipeline import pipeline_for_net
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.capture import CapturedStep
    from repro_torch.kernels.ref import deterministic_float32
    from repro_torch.launch.ft import run_with_restarts
    from repro_torch.launch.train import SMOKE_GAP_BOUND, smoke_recipe
    from repro_torch.obs import load, validate_nesting
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (cross_entropy, init_train_state, make_qat_step, schedules,
                                   train)
    from repro_torch.train.evaluate import eval_batches
    from repro_torch.tree import tree_leaves, tree_unflatten

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    quiet = lambda *_: None  # noqa: E731
    out = {"nets": {}}

    def run(spec, **kw):
        name, per_eval = spec[0], spec[1]
        _check_width(get_graph(name), spec)
        ternary_conv2d_cuda.launches = 0
        recorded = ternary_conv2d_cuda.recorded
        rep = train(name, seed=SEED, ckpt_dir=root / name, backend="fused",
                    device="cuda", log=quiet, **kw)
        launches = ternary_conv2d_cuda.launches
        if not rep.losses or not all(np.isfinite(rep.losses)):
            fail(f"train {name}: a loss is not finite: {rep.losses[:5]} ...")
        if rep.step_builds != 1:
            fail(f"train {name}: the step was captured {rep.step_builds} times in one segment")
        n_eval = kw.get("eval_batches", 4)
        # constant schedules: no segment eval, so every launch is the final
        # eval's deployed forward: the eager first batch, then replays of the
        # one capture (which recorded per_eval launches)
        if (rep.evals or launches != per_eval * n_eval
                or ternary_conv2d_cuda.recorded - recorded != per_eval):
            fail(f"train {name}: {launches} K1 launches over {n_eval} eval batches, "
                 f"{ternary_conv2d_cuda.recorded - recorded} recorded by captures; the "
                 f"deployed forward makes {per_eval} per batch, captured once")
        # the captured eval == the plain forwards on the same batches
        graph = dataclasses.replace(get_graph(name), qat_per_channel=True)
        eprog = CutieProgram(graph)
        hq = hd = n = 0
        with torch.no_grad(), deterministic_float32():
            for x, y in eval_batches(pipeline_for_net(graph, kw["batch"], seed=SEED), n_eval):
                xt = torch.from_numpy(x).to(dev)
                yq = eprog.forward_qat(rep.params, xt, nu=rep.nu_final).argmax(-1).cpu()
                yd = rep.deployed.forward(xt, backend="fused").argmax(-1).cpu()
                hq += int((yq.numpy() == y).sum())
                hd += int((yd.numpy() == y).sum())
                n += len(y)
        e = rep.final_eval
        if (e.qat_accuracy, e.deployed_accuracy, e.n_examples) != (hq / n, hd / n, n):
            fail(f"train {name}: captured eval {e.summary()} != eager eval qat {hq}/{n}, "
                 f"deployed {hd}/{n}")
        n = len(rep.losses)
        q = max(n // 4, 1)
        e = rep.final_eval
        out["nets"][name] = {
            "steps": n, "batch": kw["batch"], "lr": kw["lr"],
            "ms_per_step": rep.ms_per_step, "wall_s": rep.wall_s,
            "loss_first_quarter_mean": sum(rep.losses[:q]) / q,
            "loss_last_quarter_mean": sum(rep.losses[-q:]) / q,
            "loss_decreased": rep.loss_decreased, "qat_accuracy": e.qat_accuracy,
            "deployed_accuracy": e.deployed_accuracy, "gap": e.gap,
            "eval_examples": e.n_examples, "k1_launches": launches,
            "k1_launches_per_eval_batch": launches / n_eval, "restarts": rep.restarts,
            "step_builds": rep.step_builds, "captured_eval_equals_eager": True,
        }
        print(f"[chip_smoke] train: {name} {n} steps x batch {kw['batch']}, "
              f"{rep.ms_per_step:.2f} ms/step, loss {out['nets'][name]['loss_first_quarter_mean']:.4f}"
              f" -> {out['nets'][name]['loss_last_quarter_mean']:.4f}, {e.summary()}, "
              f"{launches} K1 launches", flush=True)
        return rep, launches

    # full-width spatial: the launcher's smoke recipe, gated as the launcher gates it
    recipe = smoke_recipe(TRAIN_SPATIAL[0])
    rep, k1_spatial = run(TRAIN_SPATIAL, eval_batches=TRAIN_EVAL_BATCHES, **recipe)
    failures = rep.gate(SMOKE_GAP_BOUND)
    if failures:
        fail(f"train {TRAIN_SPATIAL[0]}: smoke gate: {'; '.join(failures)}")
    pipe = pipeline_for_net(get_graph(TRAIN_SPATIAL[0]), recipe["batch"], seed=SEED)
    x_eval = torch.from_numpy(eval_batches(pipe, 1)[0][0]).to(dev)
    fused = rep.deployed.forward(x_eval, backend="fused")
    ref = rep.deployed.forward(x_eval, backend="ref")
    if not torch.equal(fused, ref):
        fail(f"train {TRAIN_SPATIAL[0]}: trained fused != ref: "
             f"max|diff|={(fused - ref).abs().max().item()}")
    out["eval_two_shapes"] = _eval_two_shapes(rep, recipe["batch"], dev)

    # full-width temporal: every layer takes a finite, non-zero gradient at step 1
    name = TRAIN_TEMPORAL[0]
    graph = dataclasses.replace(get_graph(name), qat_per_channel=True)
    prog = CutieProgram(graph)
    state = init_train_state(prog, torch.Generator().manual_seed(SEED), device=dev)
    xb, yb = pipeline_for_net(graph, TRAIN_TEMPORAL_RECIPE["batch"], seed=SEED).batch_at(0)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(state["params"])]
    loss = cross_entropy(prog.forward_qat(tree_unflatten(state["params"], leaves),
                                          torch.from_numpy(xb).to(dev)),
                         torch.from_numpy(yb).to(dev))
    grads = torch.autograd.grad(loss, leaves)
    for i, g in enumerate(grads):
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            fail(f"train {name}: gradient leaf {i} {tuple(g.shape)} not finite or all zero")
    run(TRAIN_TEMPORAL, eval_batches=1, **TRAIN_TEMPORAL_RECIPE)
    out["nets"][name]["grad_leaves_nonzero_at_step_1"] = len(grads)

    # resume on the card: 8 straight == 4 + restore + 4, bit for bit
    kw = dict(steps=8, batch=8, lr=1e-3, seed=3, ckpt_every=4, eval_batches=1,
              device="cuda", log=quiet)
    full = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_a", **kw)
    half = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_b", **{**kw, "steps": 4})
    resumed = train("cifar10_tnn_smoke", ckpt_dir=root / "resume_b", **kw)
    if half.losses != full.losses[:4] or resumed.losses != full.losses[4:]:
        fail(f"resume on the card: losses differ {full.losses} vs "
             f"{half.losses} + {resumed.losses}")
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        if not torch.equal(a, b):
            fail("resume on the card: params after 4 + restore + 4 != 8 straight")
    print("[chip_smoke] train: resume on the card bit-identical (8 steps == 4 + restore + 4)",
          flush=True)

    # a schedule with segments: one capture each
    kw = dict(steps=12, batch=8, lr=1e-3, seed=SEED, ckpt_every=6, eval_batches=1,
              nu_schedule="anneal", thresholds="learned", device="cuda", log=quiet)
    rep = train("cifar10_tnn_smoke", ckpt_dir=root / "anneal", **kw)
    g = get_graph("cifar10_tnn_smoke")
    segs = schedules.merged_segments(12, schedules.resolve("anneal", g.weight_nu, 12),
                                     schedules.constant(g.act_threshold))
    if not (len(segs) > 1 and rep.step_builds == len(segs)):
        fail(f"train anneal: {rep.step_builds} step captures over {len(segs)} segments")
    out["anneal_segments"] = len(segs)
    out["anneal_step_builds"] = rep.step_builds

    # a fault injected mid-run under capture == an uninterrupted eager run
    sprog = CutieProgram(dataclasses.replace(g, qat_per_channel=True))
    cfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=8, weight_decay=0.0)
    init = lambda: init_train_state(sprog, torch.Generator().manual_seed(2), device=dev)  # noqa: E731
    crashed = []

    def injector(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    def eager_step(fn):
        return lambda s, b: fn(s, tuple(torch.from_numpy(x).to(dev) for x in b))

    runs = {}
    for kind, step_fn, inj in (
            ("eager", eager_step(make_qat_step(sprog, cfg)), None),
            ("captured", CapturedStep(make_qat_step(sprog, cfg, donate=True), dev,
                                      inputs=(1,)), injector)):
        runs[kind] = run_with_restarts(
            lambda: step_fn, init, pipeline_for_net(sprog.graph, 8, seed=3),
            ckpt_dir=root / f"fault_{kind}", n_steps=8, ckpt_every=4, fault_injector=inj,
            log=quiet)
    (clean, h_clean), (faulty, h_fault) = runs["eager"], runs["captured"]
    if (h_fault["restarts"] != 1 or h_fault["resumed_from"] != [4]
            or h_fault["losses"][:5] + h_fault["losses"][6:] != h_clean["losses"]):
        fail(f"train fault under capture: {h_fault} vs uninterrupted {h_clean['losses']}")
    for a, b in zip(tree_leaves(faulty), tree_leaves(clean)):
        if not torch.equal(a, b):
            fail("train fault under capture: final state != the uninterrupted eager run")
    out["fault_restart_under_capture_bit_identical"] = True
    print("[chip_smoke] train: anneal run captured once per segment "
          f"({len(segs)}); a fault at step 5 under capture == the uninterrupted eager run",
          flush=True)

    # the captured step against the raw eager step at full width, timed in turns
    out["captured"] = {spec[0]: _qat_captured_vs_eager(spec, batch, dev)
                       for spec, batch in TRAIN_CAPTURED}

    # the cost of the deterministic cuDNN settings on the captured step, in turns
    det, fast = _captured_step_device_ms(dev)
    out["captured_step_device_ms_deterministic"] = det
    out["captured_step_device_ms_autotuned"] = fast
    print(f"[chip_smoke] train: {TRAIN_SPATIAL[0]} captured QAT step {det} device ms with "
          f"deterministic cuDNN, {fast} autotuned ({DETERMINISM_STEPS} replays each, "
          f"in turns)", flush=True)

    # the launcher as a user runs it, then the trace CLI
    trace = root / "train_trace.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for argv in (["-m", "repro_torch.launch.train", "--net", "cifar10_tnn_smoke", "--smoke",
                  "--trace", str(trace), "--ckpt-dir", str(root / "launcher"),
                  "--device", "cuda"],
                 ["-m", "repro_torch.obs", "summarize", str(trace)]):
        res = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"python {' '.join(argv)} exited {res.returncode}:\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        print(f"[chip_smoke] train: python {' '.join(argv[:2])} ... exit 0: "
              f"{res.stdout.strip().splitlines()[-1]}", flush=True)
    problems = validate_nesting(load(str(trace)))
    if problems:
        fail(f"train trace does not nest: {problems[:3]}")
    out["k1_launches"] = sum(n["k1_launches"] for n in out["nets"].values())
    out["restarts"] = sum(n["restarts"] for n in out["nets"].values())
    out["resume_bit_identical"] = True
    out["launcher_trace_nests"] = True
    out["phase_s"] = time.perf_counter() - t_phase
    return out, k1_spatial


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _lm_flops(cfg, batch: int, seq: int, kv_len: int):
    """(tensor-core bf16 operations, float32 CUDA-core operations) of a
    prefill of ``seq`` tokens (or a decode step, seq=1) against ``kv_len``
    cached positions: the projections, the attention scores and values
    over the causal positions, the SSD scan, and the logits of the last
    position.  A multiply-add is two."""
    from repro_torch.models.model import build_segments

    d, tok = cfg.d_model, batch * seq
    mm, f32 = 0, 0
    for seg in build_segments(cfg):
        for mixer, ffn in zip(seg.mixers, seg.ffns):
            if mixer == "mamba":
                di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
                mm += 2 * tok * (d * (2 * di + 2 * n + nh) + di * d) * seg.n_steps
                l = min(cfg.ssm_chunk, seq)
                # intra-chunk (C B^T, its decay-weighted product with x), the
                # inter-chunk read of the state and the state update
                f32 += 2 * tok * (l * n + l * di + 2 * di * n) * seg.n_steps
                continue
            h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            mm += 2 * tok * (d * h * hd + 2 * d * kvh * hd + h * hd * d) * seg.n_steps
            pairs = batch * (seq * (seq + 1) // 2 if seq > 1 else kv_len)
            mm += 2 * 2 * pairs * h * hd * seg.n_steps
            if ffn == "dense":
                mm += 2 * tok * (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) \
                    * d * cfg.d_ff * seg.n_steps
    mm += 2 * batch * d * cfg.vocab_size
    return mm, f32


def _lm_bound(cfg, params, cache_in_bytes: int, cache_out_bytes: int, batch: int, seq: int,
              kv_len: int):
    """The least time of a prefill / decode step: every param read once,
    the cache read and written once, against the FLOPs at the card's peaks
    (bf16 tensor cores; the float32 SSD scan at the CUDA cores' rate)."""
    bytes_ = _tree_bytes(params) + cache_in_bytes + cache_out_bytes
    mm, f32 = _lm_flops(cfg, batch, seq, kv_len)
    bytes_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    ops_ms = (mm / PEAK_OPS_PER_S[torch.bfloat16] + f32 / PEAK_F32_FLOPS) * 1e3
    return {"bytes": bytes_, "bytes_ms": bytes_ms, "flops": mm + f32, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _profile_kernels(fn, top: int = 5):
    """(device kernels incl. copies, their device ms, the ``top`` kernels
    by device ms) of one call of ``fn``, from `torch.profiler`; Nones when
    it reports no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, by_name = 0, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            us = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us / 1e3
    if not n:
        return None, None, None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return n, sum(by_name.values()), [[name[:120], ms] for name, ms in ranked]


def _lm_serve_run(cfg, params, dev, batch: int, prompt: int, gen):
    """Prefill ``batch x prompt`` random tokens, then LM_DECODES greedy decode
    steps through the captured, donated step (`serve_lm`'s) and through the
    raw eager step from one prefill: logits and the final cache bit for bit,
    one capture.  Then windows of LM_DECODES tokens, each after a fresh
    prefill, eager and captured in turns (eager, captured, captured, eager);
    host clock around work that ends in a synchronise.  Fails on non-finite
    logits."""
    from repro_torch.capture import CapturedStep
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.tree import tree_leaves, tree_map

    prefill = make_prefill_step(cfg, prompt + LM_DECODES + 1, cache_dtype=torch.float32)
    eager = make_decode_step(cfg)
    captured = CapturedStep(make_decode_step(cfg, donate=True), dev, inputs=(1,))
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)

    logits, cache = prefill(params, {"tokens": tokens})
    cache_c = tree_map(torch.clone, cache)
    tok_e = tok_c = torch.argmax(logits, dim=-1)[:, None]
    for i in range(LM_DECODES):
        le, cache = eager(params, tok_e, cache)
        lc, cache_c = captured(params, tok_c, cache_c)
        if not torch.equal(le, lc):
            fail(f"lm {cfg.name}: captured decode step {i} logits != eager, max|diff| "
                 f"{(le - lc).abs().max().item():.3e}")
        tok_e, tok_c = torch.argmax(le, dim=-1)[:, None], torch.argmax(lc, dim=-1)[:, None]
    for a, b in zip(tree_leaves(cache), tree_leaves(cache_c)):
        if not torch.equal(a, b):
            fail(f"lm {cfg.name}: cache after {LM_DECODES} captured decode steps != eager")
    if captured.builds != 1 or not captured.captured:
        fail(f"lm {cfg.name}: the decode step was built {captured.builds} times")
    del cache, cache_c

    prefill_ms, decode_ms = [], {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        step = captured if kind == "captured" else eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)[:, None]
        t0 = time.perf_counter()
        for _ in range(LM_DECODES):
            logits, cache = step(params, tok, cache)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize()
        decode_ms[kind].append((time.perf_counter() - t0) * 1e3 / LM_DECODES)
        if not bool(finite):
            fail(f"lm {cfg.name}: non-finite logits (batch {batch}, prompt {prompt})")
    cache_in = _tree_bytes(cache)
    prof = {}
    for kind, step in (("captured", captured), ("eager", eager)):
        n, ms, top = _profile_kernels(lambda: step(params, tok, cache))
        prof[kind] = {"device_kernels_per_decode_step": n, "device_ms_per_decode_step": ms,
                      "top_kernels_ms_per_decode_step": top}
    pf_kernels, pf_device_ms, _ = _profile_kernels(lambda: prefill(params, {"tokens": tokens}))
    kv = prompt + LM_DECODES
    med = {k: float(np.median(v)) for k, v in decode_ms.items()}
    return {
        "batch": batch, "prompt": prompt, "decode_steps": LM_DECODES,
        "captured_equals_eager": True, "decode_builds": captured.builds,
        "prefill_ms_first_call": prefill_ms[0], "prefill_ms": float(np.median(prefill_ms[1:])),
        "device_kernels_per_prefill": pf_kernels, "device_ms_per_prefill": pf_device_ms,
        "decode_ms_per_token": med["captured"], "decode_ms_per_token_eager": med["eager"],
        "decode_ms_per_token_turns": decode_ms,
        "device_kernels_per_decode_step": prof["captured"]["device_kernels_per_decode_step"],
        "device_ms_per_decode_step": prof["captured"]["device_ms_per_decode_step"],
        "top_kernels_ms_per_decode_step": prof["captured"]["top_kernels_ms_per_decode_step"],
        "eager": prof["eager"],
        "prefill_bound": _lm_bound(cfg, params, 0, cache_in, batch, prompt, prompt),
        "decode_bound": _lm_bound(cfg, params, cache_in, cache_in, batch, 1, kv),
    }


def _lm_long_prefill(cfg, params, dev, gen):
    """One batch-1 prefill of LM_LONG tokens (timed on its second call)."""
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg, LM_LONG, cache_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen, device=dev)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        fail(f"lm {cfg.name}: non-finite logits after a {LM_LONG}-token prefill")
    if int(cache["len"]) != LM_LONG:
        fail(f"lm {cfg.name}: cache len {int(cache['len'])} after a {LM_LONG}-token prefill")
    kernels, device_ms, top = _profile_kernels(lambda: prefill(params, {"tokens": tokens}))
    return {"tokens": LM_LONG, "prefill_ms_first_call": times[0], "prefill_ms": times[1],
            "device_kernels": kernels, "device_ms": device_ms, "top_kernels_ms": top,
            "bound": _lm_bound(cfg, params, 0, _tree_bytes(cache), 1, LM_LONG, LM_LONG)}


def _lm_consistency(cfg, params, dev, gen):
    """decode(prefill(S-1), token S) == the full forward's last logits, in
    float32 at full width; returns the largest difference."""
    import dataclasses

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import forward

    batch, seq = LM_CONSISTENCY[cfg.name]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    with torch.no_grad():
        want = forward(params, cfg32, tokens, mode="train", logits_mode="last").logits[:, -1]
    _, cache = make_prefill_step(cfg32, seq + 1, cache_dtype=torch.float32)(
        params, {"tokens": tokens[:, : seq - 1]})
    got, cache = make_decode_step(cfg32)(params, tokens[:, seq - 1:], cache)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_CONSISTENCY_TOL, atol=LM_CONSISTENCY_TOL):
        fail(f"lm {cfg.name}: decode(prefill(S-1), token S) != forward's last logits at full "
             f"width, float32: max|diff|={err:.3e} (rtol=atol={LM_CONSISTENCY_TOL})")
    return {"batch": batch, "seq": seq, "max_abs_err": err, "tol": LM_CONSISTENCY_TOL}


def _lm_smoke_card_vs_cpu(arch, dev):
    """One SMOKE config: the same params and tokens on the card and on the
    CPU, train-mode logits, prefill and decode steps within LM_SMOKE_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import forward, init_params
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(SEED)
    p_cpu = init_params(cfg, gen, device="cpu")
    p_gpu = tree_map(lambda a: a.to(dev), p_cpu)
    b, s, n_dec = LM_SMOKE_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s + n_dec), generator=gen)
    extras = {}
    if cfg.frontend == "vision":
        extras["frontend_embeds"] = torch.randn((b, cfg.frontend_seq, cfg.d_model),
                                                generator=gen)
    if cfg.is_encdec:
        extras["enc_embeds"] = torch.randn((b, cfg.enc_seq_len, cfg.d_model), generator=gen)

    def run(params, device):
        kw = {k: v.to(device) for k, v in extras.items()}
        t = toks.to(device)
        outs = []
        with torch.no_grad():
            outs.append(forward(params, cfg, t[:, :s], mode="train", **kw).logits)
        logits, cache = make_prefill_step(cfg, s + n_dec, cache_dtype=torch.float32)(
            params, {"tokens": t[:, :s], **kw})
        outs += [logits, *tree_leaves(cache)]
        decode = make_decode_step(cfg)
        for i in range(n_dec):
            logits, cache = decode(params, t[:, s + i:s + i + 1], cache)
            outs += [logits, *tree_leaves(cache)]
        return [o.cpu() for o in outs]

    err = 0.0
    for a, c in zip(run(p_gpu, dev), run(p_cpu, torch.device("cpu"))):
        if a.dtype == torch.int32:
            if not torch.equal(a, c):
                fail(f"lm {arch} smoke: cache len on the card {a} != on the CPU {c}")
            continue
        if not bool(torch.isfinite(a).all()):
            fail(f"lm {arch} smoke: non-finite values on the card")
        if not torch.allclose(a, c, rtol=LM_SMOKE_TOL, atol=LM_SMOKE_TOL):
            fail(f"lm {arch} smoke: card != CPU, max|diff|={(a - c).abs().max().item():.3e}")
        err = max(err, float((a - c).abs().max()))
    return err


def lm_path(dev):
    """Phase 8: LM serving.  ``serve --arch gemma-2b`` at the reference's
    defaults, with and without ``--quant ternary_packed``; full-width
    ``gemma-2b`` and ``mamba2-370m`` measured in-process (prefill, decode,
    a 4096-token prefill, float32 consistency); the ten SMOKE configs on the
    card against the CPU.  The path has no kernel of its own: K1 and K2
    must launch 0 times."""
    import re

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    out = {"launcher": {}, "full_width": {}, "smoke_card_vs_cpu_max_abs_err": {}}

    # the launcher as a user runs it
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for quant in ("none", "ternary_packed"):
        argv = ["-m", "repro_torch.launch.serve", "--arch", LM_SERVED, "--quant", quant]
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"python {' '.join(argv)} exited {res.returncode}:\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        line = next((ln for ln in res.stdout.splitlines() if "decode steps" in ln), "")
        m = re.search(r"prefill\((\d+)x(\d+)\) (\d+) ms; (\d+) decode steps (\d+) ms "
                      r"\(([\d.]+) ms/tok\)", line)
        if not m:
            fail(f"python {' '.join(argv)}: no [serve] line in\n{res.stdout[-2000:]}")
        out["launcher"][quant] = {
            "argv": " ".join(argv[2:]), "exit": 0, "wall_s": wall,
            "prefill_ms": int(m[3]), "decode_ms_per_token": float(m[6]),
            "batch": int(m[1]), "prompt": int(m[2]), "decode_steps": int(m[4]),
        }
        print(f"[chip_smoke] lm: python {' '.join(argv)} exit 0: {line}", flush=True)

    # full width, in-process: the launcher's defaults (batch 4, prompt 32) on
    # gemma-2b, plain then 2-bit packed, with the long prefill and the float32
    # consistency on the plain one; a 4096-token prefill, then decode, on mamba2
    for key, arch, quant in ((LM_SERVED, LM_SERVED, "none"),
                             (f"{LM_SERVED}/ternary_packed", LM_SERVED, "ternary_packed"),
                             (LM_SSM, LM_SSM, "none")):
        cfg = get_config(arch, quant=quant)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params = init_params(cfg, gen, dtype=torch.float32, device=dev)
        rep = {"n_params": cfg.n_params(), "param_bytes": _tree_bytes(params),
               "dtype": cfg.dtype, "quant": quant}
        if arch == LM_SERVED:
            rep["serve"] = _lm_serve_run(cfg, params, dev, 4, 32, gen)
            if quant == "none":
                rep["long_prefill"] = _lm_long_prefill(cfg, params, dev, gen)
        else:
            rep["serve"] = _lm_serve_run(cfg, params, dev, 1, LM_LONG, gen)
        if quant == "none":
            rep["consistency_float32"] = _lm_consistency(cfg, params, dev, gen)
        rep["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["full_width"][key] = rep
        sv, lp = rep["serve"], rep.get("long_prefill")
        long = (f"; {LM_LONG}-token prefill {lp['prefill_ms']:.2f} ms (bound "
                f"{lp['bound']['bound_ms']:.3f} ms, {lp['bound']['bound_by']})" if lp else "")
        cons = (f"; float32 prefill->decode max|diff| "
                f"{rep['consistency_float32']['max_abs_err']:.2e}"
                if "consistency_float32" in rep else "")
        print(f"[chip_smoke] lm: {key} ({rep['n_params'] / 1e9:.2f} B params): prefill "
              f"{sv['batch']}x{sv['prompt']} {sv['prefill_ms']:.2f} ms (bound "
              f"{sv['prefill_bound']['bound_ms']:.3f} ms, {sv['prefill_bound']['bound_by']}), "
              f"decode captured == eager, 1 capture; {sv['decode_ms_per_token']:.3f} ms/token "
              f"captured vs {sv['decode_ms_per_token_eager']:.3f} eager (medians, in turns), "
              f"device {sv['device_ms_per_decode_step']} ms over "
              f"{sv['device_kernels_per_decode_step']} kernels a step captured, "
              f"{sv['eager']['device_ms_per_decode_step']} ms over "
              f"{sv['eager']['device_kernels_per_decode_step']} eager (bound "
              f"{sv['decode_bound']['bound_ms']:.3f} ms, {sv['decode_bound']['bound_by']})"
              f"{long}{cons}; peak {rep['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        del params
        torch.cuda.empty_cache()

    for arch in ARCH_IDS:
        out["smoke_card_vs_cpu_max_abs_err"][arch] = _lm_smoke_card_vs_cpu(arch, dev)
    print(f"[chip_smoke] lm: the ten SMOKE configs on the card == the CPU within "
          f"{LM_SMOKE_TOL} (max|diff| "
          f"{max(out['smoke_card_vs_cpu_max_abs_err'].values()):.2e})", flush=True)

    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    if any(launches.values()):
        fail(f"lm: the LM path launched the CUTIE kernels: {launches}")
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _lm_train_bound(cfg, state, batch: int, seq: int):
    """The least time of a train step: the state (params, m, v) read once
    and written once, against the operations at the bf16 tensor cores' peak
    of four forward passes over every position's logits — the forward, the
    layer remat's second forward and a backward of twice the forward (the
    flash backward's extra products are left out: a lower bound)."""
    mm, f32 = _lm_flops(cfg, batch, seq, seq)
    mm += 2 * batch * (seq - 1) * cfg.d_model * cfg.vocab_size   # every position's logits
    mm, f32 = 4 * mm, 4 * f32
    bytes_ = 2 * _tree_bytes((state.params, state.opt))
    bytes_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    ops_ms = (mm / PEAK_OPS_PER_S[torch.bfloat16] + f32 / PEAK_F32_FLOPS) * 1e3
    return {"bytes": bytes_, "bytes_ms": bytes_ms, "flops": mm + f32, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _checksums(tree) -> list:
    """Per leaf of ``tree`` (a DTensor: this device's block), the sum and the
    sum of squares of its 32-bit words (bytes for other widths) in wrapping
    int64: leaves of equal bits give equal sums, whatever the order of the
    reduction."""
    from repro_torch.models.spmd import to_local
    from repro_torch.tree import tree_leaves

    sums = []
    for x in tree_leaves(tree):
        flat = to_local(x).detach().reshape(-1)
        flat = flat.view(torch.int32) if flat.element_size() == 4 else flat.view(torch.uint8)
        acc = torch.zeros(2, dtype=torch.int64, device=flat.device)
        for c in flat.split(1 << 26):
            c = c.to(torch.int64)
            acc += torch.stack([c.sum(), (c * c).sum()])
        sums.append(acc)
    return torch.stack(sums).cpu().tolist()


def _lm_train_full_width(dev):
    """Full-width ``gemma-2b`` under ``quant="ternary"`` on batch 1 x
    LM_TRAIN_SEQ tokens of `LMTokenPipeline`, the launcher's donating step:
    LM_TRAIN_STEPS steps eagerly, again eagerly from the same seed, then
    through `CapturedStep` (the launcher's wrapping: one eager warm-up, one
    capture, replays).  Captured == eager: losses, grad norms and every
    state leaf (checksums) bit for bit where eager repeats its own bits,
    else at LM_TRAIN_TOL.  Then, on the captured step's held state, host ms
    per step captured and eager in turns (a numpy batch in, the loss read,
    as `run_with_restarts` runs it), a `torch.profiler` step of each (device
    ms, kernels, busy share), each run's peak allocated and reserved bytes,
    the capture's seconds and the bound.  Gates: finite losses and grad
    norms, every param leaf moved, one capture."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_TRAIN_ARCH, quant="ternary")
    pipe = LMTokenPipeline(cfg.vocab_size, LM_TRAIN_SEQ, 1, seed=SEED)
    batches = [pipe.next_batch() for _ in range(LM_TRAIN_STEPS + 4 * LM_TRAIN_ROUNDS + 2)]
    opt = AdamWConfig(**LM_TRAIN_OPT)

    def run(kind):
        """LM_TRAIN_STEPS steps from the seed's state; (state, step, record)."""
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                                 device=dev)
        if not before:
            before.extend(leaf.reshape(-1)[:4096].cpu() for leaf in tree_leaves(state.params))
        step = make_train_step(cfg, opt, donate=True)
        if kind == "captured":
            step = CapturedStep(step, dev, inputs=(1,))
        rec = {"losses": [], "grad_norms": [], "host_ms": []}
        for b in batches[:LM_TRAIN_STEPS]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            rec["losses"].append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["grad_norms"].append(float(m["grad_norm"]))
        rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
        rec["checksums"] = _checksums(state)
        return state, step, rec

    torch.zeros((), device=dev)
    probe = make_train_state(cfg, None, device="meta")
    bound = _lm_train_bound(cfg, probe, 1, LM_TRAIN_SEQ)
    state_bytes = _tree_bytes(probe)
    del probe
    before, eager = [], {}
    for name in ("eager", "eager_again"):
        state, _, eager[name] = run("eager")
        if name == "eager":
            ref_params = [x.detach().cpu() for x in tree_leaves(state.params)]
            still = [i for i, (a, b) in enumerate(zip(before, ref_params))
                     if torch.equal(a, b.reshape(-1)[:4096])]
            if still:
                fail(f"lm_train {cfg.name}: param leaves {still} did not move in "
                     f"{LM_TRAIN_STEPS} steps")
        del state
    e, e2 = eager["eager"], eager["eager_again"]
    for rec in (e, e2):
        if not all(np.isfinite(rec["losses"])) or not all(np.isfinite(rec["grad_norms"])):
            fail(f"lm_train {cfg.name}: non-finite loss {rec['losses']} or grad norm "
                 f"{rec['grad_norms']}")
    repeats = (e["losses"] == e2["losses"] and e["grad_norms"] == e2["grad_norms"]
               and e["checksums"] == e2["checksums"])

    state, step, c = run("captured")
    if step.builds != 1 or not step.captured:
        fail(f"lm_train {cfg.name}: the step was built {step.builds} times (captured: "
             f"{step.captured})")
    bit_equal = (c["losses"] == e["losses"] and c["grad_norms"] == e["grad_norms"]
                 and c["checksums"] == e["checksums"])
    if repeats and not bit_equal:
        diff = [i for i, (a, b) in enumerate(zip(c["checksums"], e["checksums"])) if a != b]
        fail(f"lm_train {cfg.name}: captured != eager (eager repeats its bits): losses "
             f"{c['losses']} vs {e['losses']}, grad norms {c['grad_norms']} vs "
             f"{e['grad_norms']}, state leaves {diff[:10]} of {len(c['checksums'])} differ")
    param_err = 0.0 if bit_equal else max(
        float((a.to(dev) - b).abs().max()) for a, b in zip(ref_params, tree_leaves(state.params)))
    if not repeats:
        tol = LM_TRAIN_TOL
        for a, b in zip(ref_params, tree_leaves(state.params)):
            if not torch.allclose(b, a.to(dev), rtol=tol["rtol"], atol=tol["atol"]):
                fail(f"lm_train {cfg.name}: captured params differ from eager beyond "
                     f"{tol}: max|diff| {param_err:.3e}")
        if any(abs(x - y) > tol["loss_rtol"] * abs(y) for x, y in zip(c["losses"],
                                                                       e["losses"])):
            fail(f"lm_train {cfg.name}: captured losses {c['losses']} vs eager {e['losses']}")
    del ref_params

    # host ms per step on the one held state, in turns (the loss read each step)
    raw = make_train_step(cfg, opt, donate=True)
    fns = {"captured": step, "eager": raw}
    host = {"captured": [], "eager": []}
    it = iter(batches[LM_TRAIN_STEPS:])
    for _ in range(LM_TRAIN_ROUNDS):
        for kind in ("captured", "eager", "eager", "captured"):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = fns[kind](state, next(it))
            float(m["loss"])
            torch.cuda.synchronize(dev)
            host[kind].append((time.perf_counter() - t0) * 1e3)
    prof = {}
    for kind in ("captured", "eager"):
        box = {}

        def one(kind=kind, b=next(it)):
            box["out"] = fns[kind](state, b)
            float(box["out"][1]["loss"])

        n, dev_ms, top = _profile_kernels(one, top=10)
        state = box.pop("out")[0]
        med = float(np.median(host[kind]))
        prof[kind] = {"host_ms_per_step": host[kind], "host_ms_per_step_median": med,
                      "device_kernels_per_step": n, "device_ms_per_step": dev_ms,
                      "busy_share": dev_ms / med if n else None, "top_kernels_ms": top}
    reserved_after = torch.cuda.memory_reserved(dev)
    capture_s = step.capture_s
    del state, step, raw, fns
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "quant": cfg.quant, "dtype": cfg.dtype, "n_params": cfg.n_params(),
        "batch": 1, "seq": LM_TRAIN_SEQ, "steps": LM_TRAIN_STEPS, "donate": True,
        "state_bytes": state_bytes, "eager_repeats_bits": repeats,
        "captured_bit_equal": bit_equal, "tol_if_not_repeatable": LM_TRAIN_TOL,
        "param_max_abs_err": param_err, "builds": 1, "capture_s": capture_s,
        "first_call_host_ms": c["host_ms"][0],
        "losses": e["losses"], "grad_norms": e["grad_norms"],
        "runs": {k: {kk: v for kk, v in r.items() if kk != "checksums"}
                 for k, r in (("eager", e), ("eager_again", e2), ("captured", c))},
        "in_turns": prof, "reserved_after_turns_bytes": reserved_after, "bound": bound,
    }


def _lm_train_smoke_captured_vs_eager(arch, dev, accum=1, compress=False):
    """LM_TRAIN_SMOKE_STEPS float32 steps of a SMOKE config through the
    launcher's `CapturedStep` and through the same donating step eagerly,
    from one state: every metric and state leaf bit for bit, one capture,
    no leaf moved."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch, smoke=True)
    a = make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), compress=compress,
                         device=dev)
    b = tree_map(torch.clone, a)
    kw = dict(compress_grads=compress, accum_steps=accum, donate=True)
    eager = make_train_step(cfg, AdamWConfig(**LM_TRAIN_SMOKE_OPT), **kw)
    step = CapturedStep(make_train_step(cfg, AdamWConfig(**LM_TRAIN_SMOKE_OPT), **kw), dev,
                        inputs=(1,))
    bs, s = LM_TRAIN_SMOKE_SHAPE
    pipe = LMTokenPipeline(
        cfg.vocab_size, s, bs, seed=SEED,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0, d_model=cfg.d_model,
        enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0)
    ptrs = [x.data_ptr() for x in tree_leaves(b)]
    what = f"lm_train {arch} smoke (accum {accum}, compress {compress})"
    for i in range(LM_TRAIN_SMOKE_STEPS):
        batch = pipe.next_batch()
        a, ma = eager(a, batch)
        b, mb = step(b, batch)
        for k in ma:
            if not torch.equal(ma[k], mb[k]):
                fail(f"{what}: captured step {i} {k} {float(mb[k])!r} != eager "
                     f"{float(ma[k])!r}")
    if step.builds != 1 or not step.captured:
        fail(f"{what}: built {step.builds} times (captured: {step.captured})")
    if [x.data_ptr() for x in tree_leaves(b)] != ptrs:
        fail(f"{what}: a state leaf moved")
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        if not torch.equal(x, y):
            fail(f"{what}: state leaf {i} {tuple(x.shape)} captured != eager")
    return {"steps": LM_TRAIN_SMOKE_STEPS, "bit_equal": True, "builds": step.builds,
            "capture_s": step.capture_s}


def _lm_train_smoke_card_vs_cpu(arch, dev, accum=1, compress=False):
    """One float32 train step of a SMOKE config from the same state and batch
    on the card and on the CPU; returns the largest differences."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch, smoke=True)
    state_cpu = make_train_state(cfg, torch.Generator().manual_seed(SEED), compress=compress,
                                 device="cpu")
    state_gpu = tree_map(lambda a: a.to(dev), state_cpu)
    b, s = LM_TRAIN_SMOKE_SHAPE
    batch = LMTokenPipeline(
        cfg.vocab_size, s, b, seed=SEED,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0, d_model=cfg.d_model,
        enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0).next_batch()
    step = make_train_step(cfg, AdamWConfig(**LM_TRAIN_SMOKE_OPT), compress_grads=compress,
                           accum_steps=accum)
    new_gpu, m_gpu = step(state_gpu, batch)
    new_cpu, m_cpu = step(state_cpu, batch)
    tol = LM_TRAIN_SMOKE_TOL
    err = {"metrics": 0.0, "m": 0.0}
    for k in m_cpu:
        a, c = float(m_gpu[k]), float(m_cpu[k])
        t = tol["grad_norm"] if k == "grad_norm" else tol["metrics"]
        if not (np.isfinite(a) and abs(a - c) <= t + t * abs(c)):
            fail(f"lm_train {arch} smoke (accum {accum}, compress {compress}): {k} on the card "
                 f"{a} != on the CPU {c}")
        err["metrics"] = max(err["metrics"], abs(a - c))
    for a, c in zip(tree_leaves(new_gpu.opt.m), tree_leaves(new_cpu.opt.m)):
        a = a.cpu()
        if not bool(torch.isfinite(a).all()):
            fail(f"lm_train {arch} smoke: non-finite moment on the card")
        if not torch.allclose(a, c, rtol=tol["m_rtol"], atol=tol["m_atol"]):
            fail(f"lm_train {arch} smoke (accum {accum}, compress {compress}): first moment on "
                 f"the card != the CPU, max|diff|={(a - c).abs().max().item():.3e}")
        err["m"] = max(err["m"], float((a - c).abs().max()))
    return err


def _lm_train_launcher(env):
    """``python -m repro_torch.launch.train_lm`` at full width on the SSM
    config, then again for more steps on the same checkpoint directory,
    which must resume.  Checks free disk for three checkpoints first."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import train_state_specs

    arch, steps, steps2, every = LM_TRAIN_LAUNCH
    ckpt = REPO / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    need = 3 * _tree_bytes(train_state_specs(get_config(arch)))  # keep=3 committed steps
    free = shutil.disk_usage(ckpt).free
    if free < need:
        fail(f"lm_train: {free / 1e9:.1f} GB free under {ckpt}, the launcher's three "
             f"{arch} checkpoints need {need / 1e9:.1f} GB")
    runs = []
    try:
        for n, resumed in ((steps, None), (steps2, steps)):
            argv = ["-m", "repro_torch.launch.train_lm", "--arch", arch, "--steps", str(n),
                    "--ckpt-every", str(every), "--ckpt-dir", str(ckpt), "--device", "cuda"]
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                                 capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                fail(f"python {' '.join(argv)} exited {res.returncode}:\n"
                     f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[train]")]
            if len(lines) != 2:
                fail(f"python {' '.join(argv)}: no [train] lines in\n{res.stdout[-2000:]}")
            if resumed is not None and f"[ft] resumed from step {resumed}" not in res.stdout:
                fail(f"python {' '.join(argv)}: did not resume from step {resumed}:\n"
                     f"{res.stdout[-2000:]}")
            runs.append({"argv": " ".join(argv[2:]), "exit": 0, "wall_s": wall,
                         "train_lines": lines, "resumed_from": resumed})
            print(f"[chip_smoke] lm_train: python {' '.join(argv)} exit 0 in {wall:.1f} s: "
                  f"{' | '.join(lines)}", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"checkpoint_bytes": need // 3, "runs": runs}


def _lm_train_launcher_restart(dev):
    """`train_lm.main` in this process on the SSM config at SMOKE size (the
    full width runs twice in `_lm_train_launcher`; a full-width state's
    checkpoints would take most of a minute here) with a fault injected at
    LM_TRAIN_FAULT[0]: one capture across the restart (``step_builds``),
    one resume."""
    from repro_torch.launch import train_lm

    arch, _, _, _ = LM_TRAIN_LAUNCH
    at, steps, every = LM_TRAIN_FAULT
    ckpt = REPO / "build" / "lm_train_fault_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    crashed = []

    def injector(i):
        if i == at and not crashed:
            crashed.append(i)
            raise RuntimeError("simulated node failure")

    try:
        t0 = time.perf_counter()
        state, hist = train_lm.main(
            ["--arch", arch, "--smoke", "--steps", str(steps), "--ckpt-every", str(every),
             "--ckpt-dir", str(ckpt), "--device", "cuda"], fault_injector=injector)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = (at // every) * every
    if crashed != [at] or hist["restarts"] != 1 or hist["resumed_from"] != [resumed]:
        fail(f"lm_train: the launcher's fault at step {at} gave restarts "
             f"{hist['restarts']}, resumed from {hist['resumed_from']}")
    if hist["step_builds"] != 1:
        fail(f"lm_train: the launcher built its step {hist['step_builds']} times across a "
             f"restart")
    del state
    torch.cuda.empty_cache()
    return {"arch": arch, "smoke": True, "steps": steps, "fault_at": at, "resumed_from": resumed,
            "restarts": 1, "step_builds": 1, "wall_s": wall, "losses": hist["losses"]}


def _lm_train_launcher_step(dev):
    """The launcher's step on the SSM config at full width and the launcher's
    batch x seq: host ms per step captured (the launcher's `CapturedStep`)
    and eager (the same donating step), LM_TRAIN_LAUNCH_WINDOW steps a
    window in turns on the one held state, the loss read each step."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    arch = LM_TRAIN_LAUNCH[0]
    bs, seq = LM_TRAIN_LAUNCH_SHAPE
    cfg = get_config(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    raw = make_train_step(cfg, opt, donate=True)
    fns = {"captured": CapturedStep(raw, dev, inputs=(1,)), "eager": raw}
    pipe = LMTokenPipeline(cfg.vocab_size, seq, bs, seed=SEED)
    state, _ = fns["captured"](state, pipe.next_batch())   # warm-up and capture

    host = {"captured": [], "eager": []}
    for _ in range(LM_TRAIN_ROUNDS):
        for kind in ("captured", "eager", "eager", "captured"):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(LM_TRAIN_LAUNCH_WINDOW):
                state, m = fns[kind](state, pipe.next_batch())
                float(m["loss"])
            torch.cuda.synchronize(dev)
            host[kind].append((time.perf_counter() - t0) * 1e3 / LM_TRAIN_LAUNCH_WINDOW)
    if not np.isfinite(float(m["loss"])):
        fail(f"lm_train: {arch} launcher step: non-finite loss")
    capture_s = fns["captured"].capture_s
    del state, fns, raw
    torch.cuda.empty_cache()
    return {"arch": arch, "batch": bs, "seq": seq, "capture_s": capture_s,
            "host_ms_per_step": host,
            "host_ms_per_step_median": {k: float(np.median(v)) for k, v in host.items()}}


def lm_train_path(dev):
    """Phase 9: LM training.  Full-width ``gemma-2b`` under the ternary STE
    at 1 x 4096 tokens, eager twice and through the launcher's captured
    step; the ten SMOKE configs (and ``gemma-2b`` with ``accum_steps=2`` and
    with ``compress_grads``) card == CPU and captured == eager; the launcher
    at full width (captured) with a resume and with an injected fault, and
    its step timed captured against eager.  No kernel of its own: K1 and K2
    must launch 0 times."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

    t_phase = time.perf_counter()
    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    out = {"full_width": _lm_train_full_width(dev)}
    fw, bd = out["full_width"], out["full_width"]["bound"]
    runs, turns = fw["runs"], fw["in_turns"]
    gib = 2 ** 30
    print(f"[chip_smoke] lm_train: {fw['arch']} ternary ({fw['n_params'] / 1e9:.2f} B params, "
          f"state {fw['state_bytes'] / 1e9:.2f} GB) 1x{LM_TRAIN_SEQ}, {LM_TRAIN_STEPS} steps: "
          f"losses {', '.join(f'{x:.6f}' for x in fw['losses'])}; eager repeats its bits: "
          f"{fw['eager_repeats_bits']}; captured == eager bit for bit: "
          f"{fw['captured_bit_equal']} (params max|diff| {fw['param_max_abs_err']:.3e}); "
          f"1 capture in {fw['capture_s']:.2f} s, first call {fw['first_call_host_ms']:.1f} "
          f"host ms", flush=True)
    for kind in ("captured", "eager"):
        t = turns[kind]
        dms = t["device_ms_per_step"]
        print(f"[chip_smoke] lm_train: {kind} host ms/step "
              f"{' '.join(f'{x:.1f}' for x in t['host_ms_per_step'])} (median "
              f"{t['host_ms_per_step_median']:.1f}, in turns); "
              f"{dms if dms is None else round(dms, 1)} device ms over "
              f"{t['device_kernels_per_step']} kernels, busy "
              f"{t['busy_share'] if t['busy_share'] is None else round(t['busy_share'], 3)}; "
              f"peak allocated {runs[kind]['peak_allocated_bytes'] / gib:.2f} GiB, reserved "
              f"{runs[kind]['peak_reserved_bytes'] / gib:.2f} GiB (bound {bd['bound_ms']:.2f} "
              f"ms, {bd['bound_by']})", flush=True)

    smoke = {arch: _lm_train_smoke_card_vs_cpu(arch, dev) for arch in ARCH_IDS}
    smoke[f"{LM_TRAIN_ARCH} accum_steps=2"] = _lm_train_smoke_card_vs_cpu(LM_TRAIN_ARCH, dev,
                                                                         accum=2)
    smoke[f"{LM_TRAIN_ARCH} compress_grads"] = _lm_train_smoke_card_vs_cpu(
        LM_TRAIN_ARCH, dev, compress=True)
    out["smoke_card_vs_cpu_max_abs_err"] = smoke
    print(f"[chip_smoke] lm_train: {len(smoke)} SMOKE train steps on the card == the CPU "
          f"(metrics max|diff| {max(e['metrics'] for e in smoke.values()):.2e}, first moment "
          f"{max(e['m'] for e in smoke.values()):.2e})", flush=True)
    cap = {arch: _lm_train_smoke_captured_vs_eager(arch, dev) for arch in ARCH_IDS}
    cap[f"{LM_TRAIN_ARCH} accum_steps=2"] = _lm_train_smoke_captured_vs_eager(
        LM_TRAIN_ARCH, dev, accum=2)
    cap[f"{LM_TRAIN_ARCH} compress_grads"] = _lm_train_smoke_captured_vs_eager(
        LM_TRAIN_ARCH, dev, compress=True)
    out["smoke_captured_vs_eager"] = cap
    print(f"[chip_smoke] lm_train: {len(cap)} SMOKE configs captured == eager bit for bit "
          f"over {LM_TRAIN_SMOKE_STEPS} steps, 1 capture each (capture s "
          f"{min(c['capture_s'] for c in cap.values()):.3f}-"
          f"{max(c['capture_s'] for c in cap.values()):.3f})", flush=True)

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out["launcher"] = _lm_train_launcher(env)
    out["launcher_fault"] = _lm_train_launcher_restart(dev)
    lf = out["launcher_fault"]
    print(f"[chip_smoke] lm_train: train_lm.main --arch {lf['arch']} --smoke --steps {lf['steps']} "
          f"with a fault at step {lf['fault_at']}: resumed from {lf['resumed_from']}, "
          f"step_builds 1, {lf['wall_s']:.1f} s", flush=True)
    out["launcher_step"] = _lm_train_launcher_step(dev)
    ls = out["launcher_step"]
    print(f"[chip_smoke] lm_train: {ls['arch']} launcher step {ls['batch']}x{ls['seq']}: host "
          f"ms/step captured {' '.join(f'{x:.2f}' for x in ls['host_ms_per_step']['captured'])}"
          f", eager {' '.join(f'{x:.2f}' for x in ls['host_ms_per_step']['eager'])} (windows "
          f"of {LM_TRAIN_LAUNCH_WINDOW} in turns); capture {ls['capture_s']:.2f} s", flush=True)

    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    if any(launches.values()):
        fail(f"lm_train: the LM training path launched the CUTIE kernels: {launches}")
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _dryrun_vs_card(cfg, shape, dev):
    """One cell built by the dry-run on a (1, 1) mesh of this card, run on
    meta tensors and on zero tensors on the card: the argument bytes
    against the allocation's growth, the FLOP counts, and the temp bytes
    against the peak growth over one real step (after a warm-up step).  The
    same cell on a planned (1, 1) mesh through the DTensor path gives the
    plain figures."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, planned_mesh
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_local_mesh(dev)
    step, args, shardings, _donate, rules = dryrun.build_cell(cfg, shape, mesh)
    arg_bytes = dryrun.tree_bytes(args, shardings)
    flops_meta = dryrun.count_flops(step, args)
    t0 = time.perf_counter()
    temp = dryrun.peak_temp_bytes(step, args)
    trace_s = time.perf_counter() - t0
    planned = dryrun.analyze_cell(cfg, shape, planned_mesh((1, 1), ("data", "model")))
    pm = planned["memory_analysis"]
    if (pm["temp_bytes"], pm["argument_bytes"], planned["flops"]) != (temp, arg_bytes,
                                                                       flops_meta):
        fail(f"dryrun {cfg.name} {shape.kind}: the DTensor path on a planned (1, 1) mesh "
             f"gives temp {pm['temp_bytes']}, arguments {pm['argument_bytes']}, FLOPs "
             f"{planned['flops']}; the plain path {temp}, {arg_bytes}, {flops_meta}")

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    real = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=dev), args)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - before
    # the caching allocator may book more than a request: 512-byte blocks,
    # and up to 1 MiB more for a block it leaves unsplit
    sizes = [x.numel() * x.element_size() for x in tree_leaves(args)]
    slack = sum(dryrun.booked_bytes(n) - n for n in sizes)
    if not 0 <= growth - arg_bytes <= slack:
        fail(f"dryrun {cfg.name} {shape.kind}: argument_bytes {arg_bytes} but allocating "
             f"the {len(sizes)} arguments grew memory by {growth} (bound: {slack} bytes "
             f"of allocator rounding)")
    flops_card = dryrun.count_flops(step, real)       # also the warm-up step
    if flops_card != flops_meta:
        fail(f"dryrun {cfg.name} {shape.kind}: {flops_meta} FLOPs on meta tensors, "
             f"{flops_card} on the card")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*real)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, real
    torch.cuda.empty_cache()
    if temp < peak:
        fail(f"dryrun {cfg.name} {shape.kind}: temp_bytes {temp} below the card's peak "
             f"growth {peak} over one step (an upper bound may only err high)")
    return {"arch": cfg.name, "kind": shape.kind, "batch": shape.global_batch,
            "seq": shape.seq_len, "argument_bytes": arg_bytes,
            "allocated_growth": growth, "rounding_bound": slack, "flops": flops_meta,
            "flops_card": flops_card, "temp_bytes": temp, "temp_bytes_dtensor_1x1":
            pm["temp_bytes"], "peak_step_growth": peak, "temp_over_peak": temp / peak,
            "trace_s": trace_s, "trace_s_dtensor_1x1": planned["trace_s"]}


def dryrun_path(dev):
    """Phase 10: the dry-run.  Full-width cells on the (16, 16) production
    mesh through `run_cell` (per device on meta DTensors over a fake process
    group: FLOPs, temp bytes with the model axis split, collectives; fits
    against this card's memory), then two cells held against the card on a
    (1, 1) mesh.  It launches neither K1 nor K2."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    t_phase = time.perf_counter()
    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    out = {"cells": [], "vs_card": []}
    for arch, shape in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, device=dev, force=True,
                            out_dir=REPO / "build" / "dryrun_torch")
        if r["status"] != "ok":
            fail(f"dryrun {arch} x {shape}: {r.get('error')}\n{r.get('traceback', '')}")
        mem, coll = r["memory_analysis"], r["collectives"]
        if r["temp_bytes_kind"] != "per_device" or r["probe"].get("collective_total") is None:
            fail(f"dryrun {arch} x {shape}: temp bytes {r['temp_bytes_kind']}, probe "
                 f"{r['probe']}")
        cell = {"arch": arch, "shape": shape, "mesh": r["mesh"], "flops": r["flops"],
                "flops_global": r["flops_global"],
                "argument_bytes": mem["argument_bytes"], "temp_bytes": mem["temp_bytes"],
                "temp_bytes_kind": r["temp_bytes_kind"],
                "output_bytes": mem["output_bytes"], "alias_bytes": mem["alias_bytes"],
                "collectives": coll, "probe_collective_total": r["probe"]["collective_total"],
                "bytes_accessed": r["bytes_accessed"],
                "hbm_bytes": r["device"]["hbm_bytes"], "fits": r["fits"],
                "trace_s": r["trace_s"]}
        out["cells"].append(cell)
        kinds = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in coll["bytes_by_kind"].items() if v)
        print(f"[chip_smoke] dryrun: {arch} x {shape} x {r['mesh']}: "
              f"{r['flops']:.4e} FLOPs/device ({r['flops_global']:.4e} global), arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB + temp {mem['temp_bytes'] / 2**30:.3f} "
              f"GiB/device (per device), fits {r['device']['name']} "
              f"({r['device']['hbm_bytes'] / 2**30:.2f} GiB): {r['fits']}; collectives "
              f"{coll['total_bytes'] / 2**30:.3f} GiB/device ({kinds or 'none'}); "
              f"trace {r['trace_s']:.1f} s", flush=True)

    arch, cache_len, batch = DRYRUN_DECODE
    arch_t, seq, batch_t = DRYRUN_TRAIN
    for cfg, shape in ((get_config(arch), ShapeConfig("decode", cache_len, batch, "decode")),
                       (get_config(arch_t, smoke=True),
                        ShapeConfig("train", seq, batch_t, "train"))):
        c = _dryrun_vs_card(cfg, shape, dev)
        out["vs_card"].append(c)
        print(f"[chip_smoke] dryrun: {c['arch']} {c['kind']} {c['batch']}x{c['seq']} on a "
              f"(1, 1) mesh: argument_bytes {c['argument_bytes']} vs allocated "
              f"{c['allocated_growth']} (rounding bound {c['rounding_bound']}); FLOPs "
              f"{c['flops']} == card {c['flops_card']}; temp_bytes {c['temp_bytes']} "
              f"(== DTensor path {c['temp_bytes_dtensor_1x1']}) >= peak step growth "
              f"{c['peak_step_growth']} (ratio {c['temp_over_peak']:.3f})", flush=True)

    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    if any(launches.values()):
        fail(f"dryrun: the dry-run launched the CUTIE kernels: {launches}")
    print(f"[chip_smoke] dryrun: K1 {launches['ternary_conv2d']} and K2 "
          f"{launches['ternary_matmul']} launches", flush=True)
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def shard_path(dev):
    """Phase 11: the pool's slot axis laid across devices.  Full-width
    ``dvs_cnn_tcn``, pool 8, ``fused``, captured, in ``SHARD_BLOCKS``
    blocks on this card (`PoolSharding`, the code two cards run) against
    the plain captured pool over admit / partial / evict ticks: bit-equal,
    one capture per block, 9 K1 launches per block per tick; host ms/tick
    of both in turns; the launcher's ``--dvs --shard``.  Returns the
    report and the K1 launches of the split pool's ticks."""
    from repro_torch.api import get_net
    from repro_torch.data.pipeline import DVSEventPipeline
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.serving import PoolSharding

    t_phase = time.perf_counter()
    prog = get_net("dvs_cnn_tcn")
    g = prog.graph
    n_frames = 12
    frames, _ = DVSEventPipeline(POOL + 4, steps=max(n_frames, TIMED_TICKS + 5),
                                 hw=g.input_hw[0], seed=SEED + 2).next_batch()
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(SEED), device=dev),
                             calib=torch.from_numpy(frames[:, :n_frames]).to(dev))
    sharding = PoolSharding([dev] * SHARD_BLOCKS)
    split = deployed.serve(POOL, backend="fused", sharding=sharding)
    plain = deployed.serve(POOL, backend="fused")
    if split.sharding is not sharding or plain.sharding is not None:
        fail(f"shard: split.sharding {split.sharding}, plain.sharding {plain.sharding}")

    # churn: 6 streams, evictions and refills across the block boundary,
    # partial ticks on odd ticks
    clip = {f"s{i}": i for i in range(POOL + 4)}
    admit_at = {0: [f"s{i}" for i in range(6)], 3: ["s6", "s7"], 5: ["s8", "s9"],
                8: ["s10", "s11"]}
    evict_at = {4: ["s1", "s4"], 7: ["s0", "s7"]}
    ternary_conv2d_cuda.launches = 0
    for t in range(n_frames):
        for sid in evict_at.get(t, []):
            a, b = split.evict(sid), plain.evict(sid)
            if not (torch.equal(a.ring.buf, b.ring.buf) and torch.equal(a.steps_seen,
                                                                          b.steps_seen)):
                fail(f"shard: evicted state of {sid} differs at tick {t}")
        for sid in admit_at.get(t, []):
            split.admit(sid)
            plain.admit(sid)
        live = split.active_streams
        stepping = [s for j, s in enumerate(live) if t % 2 == 0 or j % 2 == 0]
        fr = {sid: frames[clip[sid], t] for sid in stepping}
        a, b = split.step(fr), plain.step(fr)
        for sid in fr:
            if not torch.equal(a[sid], b[sid]):
                fail(f"shard: split pool != plain pool for {sid} at tick {t}")
        if split.trace_count != SHARD_BLOCKS or not split.captured:
            fail(f"shard: split pool trace_count {split.trace_count} after tick {t}, "
                 f"captured {split.captured}; the contract is one capture per block")
    k1_split_and_plain = ternary_conv2d_cuda.launches
    # the same ticks again on the split pool alone: 9 K1 per block per tick
    ternary_conv2d_cuda.launches = 0
    for t in range(n_frames):
        split.step({sid: frames[clip[sid], t] for sid in split.active_streams})
    torch.cuda.synchronize()
    k1_split = ternary_conv2d_cuda.launches
    if k1_split != 9 * SHARD_BLOCKS * n_frames:
        fail(f"shard: {k1_split} K1 launches over {n_frames} split-pool ticks, expected "
             f"{9 * SHARD_BLOCKS} per tick")
    if k1_split_and_plain != (9 * SHARD_BLOCKS + 9) * n_frames:
        fail(f"shard: {k1_split_and_plain} K1 launches over the churn ticks of both pools")
    print(f"[chip_smoke] shard: {g.name} fused pool {POOL} in {SHARD_BLOCKS} blocks on "
          f"{dev} == the plain pool over {n_frames} admit/partial/evict ticks; "
          f"trace_count {split.trace_count}; {k1_split} K1 launches over {n_frames} ticks "
          f"({9 * SHARD_BLOCKS} per tick)", flush=True)

    # host ms/tick, every slot busy, in turns: plain, split, split, plain
    pools = {"plain": deployed.serve(POOL, backend="fused"),
             "split": deployed.serve(POOL, backend="fused", sharding=sharding)}
    for pool in pools.values():
        for i in range(POOL):
            pool.admit(f"s{i}")

    def ticks(pool, lo=5, hi=5 + TIMED_TICKS):
        for t in range(lo, hi):
            pool.step({f"s{i}": frames[i, t] for i in range(POOL)})

    for pool in pools.values():
        ticks(pool, 0, 5)
    torch.cuda.synchronize()
    host = {"plain": [], "split": []}
    for _ in range(TIMING_ROUNDS):
        for name in ("plain", "split", "split", "plain"):
            t0 = time.perf_counter()
            ticks(pools[name])
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) / TIMED_TICKS * 1e3)
    timing = {name: {"host_ms_per_tick": v, "host_ms_per_tick_median": float(np.median(v))}
              for name, v in host.items()}
    for name, pool in pools.items():
        if pool.trace_count != (SHARD_BLOCKS if name == "split" else 1):
            fail(f"shard: timed {name} pool trace_count {pool.trace_count}")
    print(f"[chip_smoke] shard: pool {POOL} host ms/tick, in turns: plain "
          + " ".join(f"{v:.4f}" for v in host["plain"])
          + f" (median {timing['plain']['host_ms_per_tick_median']:.4f}); split "
          + " ".join(f"{v:.4f}" for v in host["split"])
          + f" (median {timing['split']['host_ms_per_tick_median']:.4f})", flush=True)

    # the launcher: --shard on one card resolves to one block
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--dvs", "--shard",
            "--pool", str(POOL), "--frames", "4"]
    t0 = time.perf_counter()
    res = subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env,
                         cwd=REPO)
    if res.returncode != 0 or "(shard=False)" not in res.stdout:
        fail(f"{' '.join(argv[1:])}: exit {res.returncode}, no '(shard=False)':\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    print(f"[chip_smoke] shard: python {' '.join(argv[1:])} exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, shard=False on one card", flush=True)
    return {"net": g.name, "pool": POOL, "blocks": SHARD_BLOCKS, "ticks": n_frames,
            "trace_count": split.trace_count, "k1_launches": k1_split,
            "k1_per_tick": k1_split / n_frames, "timing": timing,
            "launcher_shard": "shard=False",
            "phase_s": time.perf_counter() - t_phase}, k1_split


def _spmd_serve(rules, dev):
    """Full-width SPMD_ARCH: prefill and SPMD_SERVE's greedy decodes through
    the captured, donated decode step, plain and on DTensors of ``rules``'
    mesh; logits within SPMD_TOL, tokens equal, one capture; then host ms
    per decode token of both in turns, each window after a fresh prefill."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import distribute
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(SPMD_ARCH)
    batch, prompt, n_tok = SPMD_SERVE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    dparams = distribute(params, rules.param_shardings(params))
    shared = all(a.data_ptr() == b.to_local().data_ptr()
                 for a, b in zip(tree_leaves(params), tree_leaves(dparams)))
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    shard = rules.make_shard_fn()
    runs = {}
    for kind, p, kw in (("plain", params, {}),
                        ("dtensor", dparams, {"shard": shard, "cache_init": rules.cache_init})):
        prefill = make_prefill_step(cfg, prompt + n_tok, cache_dtype=torch.float32, **kw)
        decode = CapturedStep(make_decode_step(cfg, shard=kw.get("shard"), donate=True), dev,
                              inputs=(1,))
        logits, cache = prefill(p, {"tokens": tokens})
        seen = [logits]
        tok = torch.argmax(logits, dim=-1)[:, None]
        toks = [tok]
        for _ in range(n_tok - 1):
            logits, cache = decode(p, tok, cache)
            seen.append(logits)
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok)
        if type(logits) is not torch.Tensor or not bool(torch.isfinite(logits).all()):
            fail(f"spmd {kind}: the decode step's logits are not a finite plain tensor")
        runs[kind] = {"logits": seen, "tokens": torch.cat(toks, dim=1), "prefill": prefill,
                      "decode": decode, "params": p, "cache": cache}
    diffs = [float((a - b).abs().max()) for a, b in zip(runs["plain"]["logits"],
                                                        runs["dtensor"]["logits"])]
    if max(diffs) > SPMD_TOL:
        fail(f"spmd: DTensor logits differ from the plain step's by {max(diffs):.3e} "
             f"(> {SPMD_TOL}) at step {int(np.argmax(diffs))}")
    if not torch.equal(runs["plain"]["tokens"], runs["dtensor"]["tokens"]):
        fail("spmd: the DTensor step's greedy tokens differ from the plain step's")
    captured = runs["dtensor"]["decode"]
    if captured.builds != 1 or not captured.captured:
        fail(f"spmd: the DTensor decode step was built {captured.builds} times "
             f"(captured: {captured.captured})")

    host = {"plain": [], "dtensor": []}
    for _ in range(SPMD_TIMING_ROUNDS):
        for kind in ("plain", "dtensor", "dtensor", "plain"):
            r = runs[kind]
            logits, cache = r["prefill"](r["params"], {"tokens": tokens})
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n_tok - 1):
                logits, cache = r["decode"](r["params"], tok, cache)
                tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize(dev)
            host[kind].append((time.perf_counter() - t0) * 1e3 / (n_tok - 1))
    del runs, params, dparams, cache, logits
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "batch": batch, "prompt": prompt, "decodes": n_tok - 1,
            "max_abs_err": max(diffs), "max_abs_err_per_step": diffs,
            "bit_equal": max(diffs) == 0.0, "tokens_equal": True,
            "decode_builds": captured.builds, "params_shared_with_plain": shared,
            "host_ms_per_token": host,
            "host_ms_per_token_median": {k: float(np.median(v)) for k, v in host.items()}}


def _spmd_train(rules, dev):
    """Full-width SPMD_ARCH ``quant="ternary"`` donating train steps at
    1 x LM_TRAIN_SEQ tokens from the same seed: one plain step, then two on
    DTensors eagerly and two on DTensors through the launcher's
    `CapturedStep` (a warm-up and capture, then a replay).  The first
    DTensor step against the plain one at SPMD_TRAIN_TOL (the loss and
    every param); the captured DTensor steps against the eager ones bit for
    bit (losses, grad norms, every state leaf's checksum), one capture.
    Each run's peak memory and host ms per step (the first a first call:
    it includes the step's warm-up, and for the captured step its
    capture)."""
    from repro_torch.capture import CapturedStep
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.sharding import distribute
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config(SPMD_ARCH, quant="ternary")
    pipe = LMTokenPipeline(cfg.vocab_size, LM_TRAIN_SEQ, 1, seed=SEED)
    batches = [pipe.next_batch() for _ in range(2)]
    out, plain_params = {}, None
    for kind in ("plain", "dtensor", "dtensor_captured"):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                                 device=dev)
        kw = {}
        if kind != "plain":
            state = distribute(state, rules.param_shardings(state))
            kw["shard"] = rules.make_shard_fn()
        step = make_train_step(cfg, AdamWConfig(**LM_TRAIN_OPT), donate=True, **kw)
        if kind == "dtensor_captured":
            step = CapturedStep(step, dev, inputs=(1,))
        rec = {"losses": [], "grad_norms": [], "host_ms": []}
        for i, batch in enumerate(batches[:1] if kind == "plain" else batches):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(metrics["loss"]))
            rec["grad_norms"].append(float(metrics["grad_norm"]))
            if kind == "plain":
                plain_params = [x.detach().to("cpu") for x in tree_leaves(state.params)]
            elif kind == "dtensor" and i == 0:
                errs = []
                for a, b in zip(plain_params, tree_leaves(state.params)):
                    a, b = a.to(dev), b.to_local()
                    errs.append(float((a - b).abs().max()) if a.is_floating_point() else 0.0)
                    if not torch.allclose(b, a, rtol=SPMD_TRAIN_TOL["rtol"],
                                          atol=SPMD_TRAIN_TOL["atol"]):
                        fail(f"spmd: a param after the DTensor train step differs from the "
                             f"plain step's: max|diff| {errs[-1]:.3e}")
                out["param_max_abs_err"] = max(errs)
                del plain_params
        out[kind] = {"loss": rec["losses"][0], "grad_norm": rec["grad_norms"][0],
                     "losses": rec["losses"], "grad_norms": rec["grad_norms"],
                     "host_ms_first_step": rec["host_ms"][0], "host_ms_per_step": rec["host_ms"],
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                     "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)}
        if kind != "plain":
            out[kind]["checksums"] = _checksums(state)
        if kind == "dtensor_captured":
            if step.builds != 1 or not step.captured:
                fail(f"spmd: the DTensor train step was built {step.builds} times (captured: "
                     f"{step.captured})")
            out[kind]["capture_s"] = step.capture_s
        del state, metrics, step
    p, d, c = out["plain"], out["dtensor"], out["dtensor_captured"]
    if abs(d["loss"] - p["loss"]) > SPMD_TRAIN_TOL["loss_rtol"] * abs(p["loss"]):
        fail(f"spmd: the DTensor train step's loss {d['loss']} != the plain {p['loss']}")
    if (c["losses"], c["grad_norms"]) != (d["losses"], d["grad_norms"]):
        fail(f"spmd: the captured DTensor train step's losses {c['losses']} / grad norms "
             f"{c['grad_norms']} != the eager DTensor step's {d['losses']} / {d['grad_norms']}")
    if c.pop("checksums") != d.pop("checksums"):
        fail("spmd: after two steps the captured DTensor train state differs from the eager "
             "DTensor step's")
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "quant": cfg.quant, "batch": 1, "seq": LM_TRAIN_SEQ,
            "tol": SPMD_TRAIN_TOL, "captured_bit_equal": True, "captured_builds": 1, **out}


def spmd_path(dev):
    """Phase 12: the LM on a real device mesh.  An NCCL process group of
    world size 1 on this card and a (1, 1) ``DeviceMesh("cuda")``:
    full-width SPMD_ARCH served and trained through DTensors against the
    plain steps.  No kernel of its own: K1 and K2 must launch 0 times.  The
    group is destroyed before the phase returns (a dry-run's fake group
    raises while one exists)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.launch.sharding import ShardingRules

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="spmd_", dir=REPO / "build") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = world_mesh((1, 1))
            backend, world = dist.get_backend(), dist.get_world_size()
            print(f"[chip_smoke] spmd: process group {backend}, world size {world}, mesh "
                  f"{mesh!r} on {mesh.device_mesh.device_type}", flush=True)
            rules = ShardingRules(mesh)
            ternary_conv2d_cuda.launches = 0
            ternary_matmul_cuda.launches = 0
            serve = _spmd_serve(rules, dev)
            train = _spmd_train(rules, dev)
            launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                        "ternary_matmul": ternary_matmul_cuda.launches}
        finally:
            dist.destroy_process_group()
    if dist.is_initialized():
        fail("spmd: the process group outlived the phase")
    if any(launches.values()):
        fail(f"spmd: the LM on a mesh launched the CUTIE kernels: {launches}")
    hm = serve["host_ms_per_token_median"]
    print(f"[chip_smoke] spmd: {serve['arch']} {serve['batch']}x{serve['prompt']} + "
          f"{serve['decodes']} captured decodes on DTensors: logits max|diff| vs plain "
          f"{serve['max_abs_err']:.3e} (tol {SPMD_TOL}), tokens equal, 1 capture; host "
          f"ms/token plain {' '.join(f'{x:.3f}' for x in serve['host_ms_per_token']['plain'])}"
          f" (median {hm['plain']:.3f}), dtensor "
          f"{' '.join(f'{x:.3f}' for x in serve['host_ms_per_token']['dtensor'])} "
          f"(median {hm['dtensor']:.3f})", flush=True)
    tc = train["dtensor_captured"]
    print(f"[chip_smoke] spmd: {train['arch']} ternary 1x{train['seq']} train step: loss "
          f"plain {train['plain']['loss']:.6f} dtensor {train['dtensor']['loss']:.6f}, "
          f"params max|diff| {train['param_max_abs_err']:.3e}; peak "
          f"{train['plain']['peak_memory_bytes'] / 1e9:.2f} GB plain, "
          f"{train['dtensor']['peak_memory_bytes'] / 1e9:.2f} GB dtensor; "
          f"K1 {launches['ternary_conv2d']}, K2 {launches['ternary_matmul']} launches",
          flush=True)
    print(f"[chip_smoke] spmd: the DTensor train step captured == eager bit for bit over 2 "
          f"steps (losses {' '.join(f'{x:.6f}' for x in tc['losses'])}), 1 capture in "
          f"{tc['capture_s']:.2f} s; host ms/step captured "
          f"{' '.join(f'{x:.1f}' for x in tc['host_ms_per_step'])}, eager "
          f"{' '.join(f'{x:.1f}' for x in train['dtensor']['host_ms_per_step'])}; peak "
          f"allocated {tc['peak_memory_bytes'] / 1e9:.2f} GB, reserved "
          f"{tc['peak_reserved_bytes'] / 1e9:.2f} GB", flush=True)
    return {"backend": backend, "world_size": world, "mesh": [1, 1], "serve": serve,
            "train": train, "kernel_launches": launches,
            "phase_s": time.perf_counter() - t_phase}


def bench_path(dev):
    """Phase 13: the kernel, backend and serving benches, the silicon sweep
    and the bitsim check, each through its ``main(argv)`` on the card.
    Returns the phase's report with K1 and K2 launches."""
    import tempfile

    from benchmarks import (
        backend_bench_torch,
        kernel_bench_torch,
        paper_tables_torch,
        serving_bench_torch,
    )
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

    t_phase = time.perf_counter()
    ternary_conv2d_cuda.launches = 0
    ternary_matmul_cuda.launches = 0
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        runs = [
            ("kernels", kernel_bench_torch, ["--out", str(out / "kernels.json")]),
            ("backends", backend_bench_torch, ["--out", str(out / "backends.json")]),
            ("serving", serving_bench_torch, ["--out", str(out / "serving.json")]),
            ("silicon", paper_tables_torch, ["--silicon", "--out", str(out / "silicon.json")]),
            ("bitsim_check", paper_tables_torch, ["--bitsim-check"]),
        ]
        for name, module, argv in runs:
            t0 = time.perf_counter()
            rc = module.main(argv)
            seconds[name] = time.perf_counter() - t0
            if rc != 0:
                fail(f"benches: {module.__name__.split('.')[-1]} {' '.join(argv)} exited {rc}")
        committed = json.loads((REPO / "BENCH_silicon.json").read_text())["results"]
        if json.loads((out / "silicon.json").read_text())["results"] != committed:
            fail("benches: paper_tables_torch --silicon rows != BENCH_silicon.json")
        kernels = json.loads((out / "kernels.json").read_text())["results"]
    launches = {"ternary_conv2d": ternary_conv2d_cuda.launches,
                "ternary_matmul": ternary_matmul_cuda.launches}
    for name, n in launches.items():
        if n == 0:
            fail(f"benches: {name} launched 0 times over the benches")
    report = {"seconds": seconds, "kernel_launches": launches,
              "kernel_bench": [{k: r[k] for k in ("name", "dense_us", "dense_autotuned_us",
                                                  "dense_deterministic_us", "packed_us",
                                                  "plain_us", "speedup_packed_vs_unpacked",
                                                  "bit_exact")}
                               for r in kernels],
              "phase_s": time.perf_counter() - t_phase}
    print(f"[chip_smoke] benches: kernel, backend and serving benches, --silicon (== "
          f"BENCH_silicon.json) and --bitsim-check exit 0 in {report['phase_s']:.1f} s; "
          f"K1 {launches['ternary_conv2d']} and K2 {launches['ternary_matmul']} launches",
          flush=True)
    return report


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # phase 2: build every kernel source of the checkout, all started together
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        for lib in ex.map(build.build, sources):
            print(f"[chip_smoke] built {lib.name}", flush=True)
    print(f"[chip_smoke] build: {len(sources)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s ({Path(build.find_nvcc()).name})", flush=True)

    # phase 3: each kernel against its plain version, then times
    exact_err, gauss_err = check_kernel(dev)
    total, per_shape = time_kernel(dev)
    mm_err_f32, mm_err_bf16 = check_matmul(dev)
    mm_rows = time_matmul(dev)
    check_determinism(dev)

    # phase 4: the serving path
    launches, serving = serve_main_path(dev)

    # phase 5: the quickstart path
    qs_launches = quickstart_path(dev)

    # phase 6: the deployment path
    fleet = fleet_path(dev)

    # phase 7: the training path
    train_report, k1_train = train_path(dev)

    # phase 8: the LM serving path
    lm_report = lm_path(dev)

    # phase 9: the LM training path
    lm_train_report = lm_train_path(dev)

    # phase 10: the dry-run
    dryrun_report = dryrun_path(dev)

    # phase 11: the pool laid across devices
    shard_report, k1_shard = shard_path(dev)

    # phase 12: the LM on a real device mesh (its group destroyed at the end)
    spmd_report = spmd_path(dev)

    # phase 13: the benches
    bench_report = bench_path(dev)

    # phase 14: results
    mm = mm_rows[0]  # the quickstart's launch: 64x2048x512 float32
    kernels = {"kernels": [{
        "name": "ternary_conv2d", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(exact_err, gauss_err), "max_abs_err_exact_data": exact_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": total["bound_by"], "library_ms": total["library_ms"],
        "ms_over_library": total["ms"] / total["library_ms"],
        "launches_cover": "the serving path (16 streams x 8 frames, pool 8)",
        "launches_quickstart": qs_launches["ternary_conv2d"],
        "launches_fleet": fleet["ungated"]["k1_launches"],
        "launches_train": k1_train,
        "launches_train_cover": "the final deployed eval of the full-width cifar10_tnn run "
                                "(the eager first batch, then replays of its capture)",
        "launches_lm_train": lm_train_report["kernel_launches"]["ternary_conv2d"],
        "launches_dryrun": dryrun_report["kernel_launches"]["ternary_conv2d"],
        "launches_spmd": spmd_report["kernel_launches"]["ternary_conv2d"],
        "launches_shard": k1_shard,
        "launches_shard_cover": f"{shard_report['ticks']} ticks of the pool in "
                                f"{SHARD_BLOCKS} blocks",
        "launches_bench": bench_report["kernel_launches"]["ternary_conv2d"],
        "times_cover": "the 9 launches of one pool tick at pool size 8 (sum)",
        "shapes": per_shape,
    }, {
        "name": "ternary_matmul", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": qs_launches["ternary_matmul"],
        "max_abs_err": mm_err_f32, "max_abs_err_bf16": mm_err_bf16,
        "ms": mm["ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
        "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
        "ms_over_library": mm["ms"] / mm["library_ms"],
        "launches_cover": "the quickstart path",
        "launches_lm_train": lm_train_report["kernel_launches"]["ternary_matmul"],
        "launches_dryrun": dryrun_report["kernel_launches"]["ternary_matmul"],
        "launches_spmd": spmd_report["kernel_launches"]["ternary_matmul"],
        "launches_bench": bench_report["kernel_launches"]["ternary_matmul"],
        "times_cover": "one launch at the quickstart shape 64x2048x512, float32",
        "shapes": mm_rows,
    }]}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"train": train_report}), flush=True)
    print(json.dumps({"lm": lm_report}), flush=True)
    print(json.dumps({"lm_train": lm_train_report}), flush=True)
    print(json.dumps({"dryrun": dryrun_report}), flush=True)
    print(json.dumps({"shard": shard_report}), flush=True)
    print(json.dumps({"spmd": spmd_report}), flush=True)
    print(json.dumps({"benches": bench_report}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
