"""``python -m repro_torch.artifact`` — the artifact toolchain CLI of the port.
Counterpart of ``python -m repro.artifact``.

    build   registry net name -> .cutie file (random weights from --seed,
            calibrated on the net's own synthetic data)
    dis     .cutie -> readable listing (stdout or -o file)
    asm     listing -> .cutie (optionally gated byte-identical vs --expect)
    info    header/plan/image summary + silicon report of an artifact
    verify  load + cross-backend bit-exactness + dis/asm round-trip gate

Examples:

    python -m repro_torch.artifact build dvs_cnn_tcn -o net.cutie
    python -m repro_torch.artifact dis net.cutie -o net.lst
    python -m repro_torch.artifact asm net.lst -o net2.cutie --expect net.cutie
    python -m repro_torch.artifact info net.cutie
    python -m repro_torch.artifact verify net.cutie

``--device`` (build, info, verify) defaults to ``cuda``; without a CUDA
device that is an error, not a move to the CPU — pass ``--device cpu`` for
the plain PyTorch path.  A net built here differs from the reference CLI's
build of the same net: `init` draws from a `torch.Generator`, not from
`jax.random` (the container format is the same).  ``build --ckpt DIR``
packs trained params instead: the newest committed checkpoint under DIR,
written by `repro_torch.train` or `repro.train` (a ``{"params", "opt"}``
train state) or holding params alone; ``--per-channel`` calibrates on the
per-OCU QAT grid `train()` trains on by default, and ``--calib-batch`` set
to the run's batch calibrates on the batch `train()` calibrated on.

``verify`` exercises the whole round trip (assemble -> write -> load ->
execute) with zero graph objects and exits non-zero on any mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.api.program import CutieProgram
from repro_torch.device import resolve_device


def restore_params(ckpt_dir, prog, device):
    """Trained params of ``prog`` from the newest committed checkpoint under
    ``ckpt_dir``: a ``{"params", "opt"}`` train state or params alone, with
    no, scalar or per-channel learned thresholds — whichever structure the
    checkpoint's leaf count and shapes fit.  Returns ``(params, meta)``."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.optim.adamw import adamw_init

    tried = []
    for learn in (False, True, "per_channel"):
        like = prog.init(torch.Generator().manual_seed(0), learn_thresholds=learn,
                         device=device)
        for state in ({"params": like, "opt": adamw_init(like)}, like):
            try:
                restored, meta = restore_checkpoint(ckpt_dir, state)
            except ValueError as e:
                tried.append(str(e))
                continue
            return (restored["params"] if "opt" in state else restored), meta
    raise ValueError(f"{ckpt_dir}: no params structure of {prog.graph.name} fits "
                     f"the checkpoint ({'; '.join(tried)})")


def _build(args) -> int:
    from repro_torch.api import get_net
    from repro_torch.data.pipeline import pipeline_for_net

    dev = resolve_device(args.device)
    prog = get_net(args.net)
    if args.per_channel:
        prog = CutieProgram(dataclasses.replace(prog.graph, qat_per_channel=True))
    g = prog.graph
    if args.ckpt:
        params, meta = restore_params(args.ckpt, prog, dev)
        print(f"[artifact] params restored from {args.ckpt} "
              f"(step {meta.get('step')})")
    else:
        params = prog.init(torch.Generator().manual_seed(args.seed), device=dev)
    calib = None
    if not args.no_calib:
        batch = pipeline_for_net(g, batch=args.calib_batch, seed=args.seed)
        calib = torch.from_numpy(batch.next_batch()[0]).to(dev)
    deployed = prog.quantize(params, calib=calib)
    n = deployed.save_artifact(args.out)
    print(f"[artifact] {g.name} -> {args.out}: {n} bytes "
          f"({'calibrated' if calib is not None else 'fan-in scales'})")
    return 0


def _dis(args) -> int:
    from repro_torch import artifact

    with open(args.artifact, "rb") as f:
        listing = artifact.disassemble(f.read())
    if args.out:
        with open(args.out, "w") as f:
            f.write(listing)
        print(f"[artifact] listing -> {args.out} ({len(listing)} chars)")
    else:
        sys.stdout.write(listing)
    return 0


def _asm(args) -> int:
    from repro_torch import artifact

    with open(args.listing) as f:
        data = artifact.reassemble(f.read())
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"[artifact] {args.listing} -> {args.out}: {len(data)} bytes")
    if args.expect:
        with open(args.expect, "rb") as f:
            want = f.read()
        if data != want:
            print(f"[artifact] FAIL: reassembly differs from {args.expect}",
                  file=sys.stderr)
            return 1
        print(f"[artifact] byte-identical to {args.expect}")
    return 0


def _info(args) -> int:
    from repro_torch import artifact

    prog = artifact.load(args.artifact, device=args.device)
    info, plan = prog.info, prog.plan
    print(f"[artifact] {args.artifact}: format v{artifact.VERSION}, "
          f"net {info.name}")
    print(f"  input           : {info.input_hw[0]}x{info.input_hw[1]}"
          f"x{info.input_ch}, {info.n_classes} classes")
    kind = (f"temporal (T={info.tcn_steps}, C={info.feature_channels}, "
            f"{info.passes_per_inference} passes/inference)"
            if info.is_temporal else "spatial")
    print(f"  kind            : {kind}")
    print(f"  plan            : {len(plan.layers)} layers "
          f"({plan.n_spatial} spatial), {plan.n_ocu} OCU x "
          f"{plan.max_cin} C_in tiles")
    print(f"  weight images   : {len(prog.memory.images)}, "
          f"{prog.nbytes} packed bytes")
    for img in prog.memory.images:
        shape = "x".join(str(s) for s in img.packed.shape)
        thr = ("scalar" if not np.ndim(img.threshold)
               else f"[{np.asarray(img.threshold).size}]")
        print(f"    layer {img.index:2d} {img.kind:6s} packed {shape:>14s} "
              f"{img.nbytes:6d} B  thr {thr}  dil {img.dilation}")
    print(prog.silicon_report(v=args.v).summary())
    return 0


def _verify(args) -> int:
    from repro_torch import artifact

    with open(args.artifact, "rb") as f:
        data = f.read()
    prog = artifact.loads(data, device=args.device)
    failures = []
    if prog.to_bytes() != data:
        failures.append("re-assembly is not byte-identical")
    if artifact.reassemble(artifact.disassemble(data)) != data:
        failures.append("disassemble -> reassemble is not byte-identical")
    info = prog.info
    shape = ((args.batch, args.frames, *info.input_hw, info.input_ch)
             if info.is_temporal else (args.batch, *info.input_hw, info.input_ch))
    x = torch.sign(torch.randn(shape, generator=torch.Generator().manual_seed(args.seed)))
    x = x.to(prog.device)
    outs = {be: prog.forward(x, backend=be).detach().cpu().numpy()
            for be in args.backends}
    ref_be = args.backends[0]
    for be in args.backends[1:]:
        if not (outs[be] == outs[ref_be]).all():
            failures.append(
                f"{be} logits != {ref_be} "
                f"(max|diff|={np.abs(outs[be] - outs[ref_be]).max():.3e})"
            )
    if not all(np.isfinite(o).all() for o in outs.values()):
        failures.append("non-finite logits")
    print(f"[artifact] verify {args.artifact}: {info.name} on {prog.device}, "
          f"backends {'/'.join(args.backends)}, batch {args.batch}"
          + (f" x {args.frames} frames" if info.is_temporal else ""))
    if failures:
        for msg in failures:
            print(f"[artifact] FAIL: {msg}", file=sys.stderr)
        return 1
    print("[artifact] OK: round trip lossless, backends bit-exact")
    return 0


def main(argv=None) -> int:
    from repro_torch.api import BACKENDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.artifact",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = ("cuda (default; an error when no CUDA device is available) "
                   "or cpu (plain PyTorch path)")

    b = sub.add_parser("build", help="net -> .cutie")
    b.add_argument("net", help="registry net name (repro_torch.api.registry)")
    b.add_argument("-o", "--out", required=True, help="output .cutie path")
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--no-calib", action="store_true",
                   help="skip BN calibration (1/sqrt(fan-in) scales)")
    b.add_argument("--calib-batch", type=int, default=8)
    b.add_argument("--ckpt", default=None,
                   help="checkpoint dir to restore trained params from "
                        "(repro_torch.ckpt or repro.ckpt layout)")
    b.add_argument("--per-channel", action="store_true",
                   help="calibrate on the per-OCU QAT grid (train()'s default)")
    b.add_argument("--device", default="cuda", help=device_help)
    b.set_defaults(fn=_build)

    d = sub.add_parser("dis", help=".cutie -> listing")
    d.add_argument("artifact")
    d.add_argument("-o", "--out", default=None)
    d.set_defaults(fn=_dis)

    a = sub.add_parser("asm", help="listing -> .cutie")
    a.add_argument("listing")
    a.add_argument("-o", "--out", required=True)
    a.add_argument("--expect", default=None,
                   help="gate: output must be byte-identical to this artifact")
    a.set_defaults(fn=_asm)

    i = sub.add_parser("info", help="artifact summary + silicon report")
    i.add_argument("artifact")
    i.add_argument("--v", type=float, default=0.5, help="supply voltage")
    i.add_argument("--device", default="cuda", help=device_help)
    i.set_defaults(fn=_info)

    v = sub.add_parser("verify", help="load + cross-backend exactness gate")
    v.add_argument("artifact")
    v.add_argument("--backends", nargs="+", choices=list(BACKENDS),
                   default=["bitsim", "ref", "fused"])
    v.add_argument("--batch", type=int, default=2)
    v.add_argument("--frames", type=int, default=4,
                   help="frames per clip for temporal programs")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--device", default="cuda", help=device_help)
    v.set_defaults(fn=_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
