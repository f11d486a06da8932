"""Quickstart of the port: the paper's technique in a few minutes, on the card.

Counterpart of ``examples/quickstart.py``:

0. The `CutieProgram` pipeline on the full-width ``cifar10_tnn``: one
   network definition -> packed 2-bit deployment -> logits on every deploy
   backend (``fused``, ``kernel``, ``ref``, ``bitsim``), all equal.
1. Ternary-quantize a weight matrix, pack it to 2 bits along K and matmul
   through `kernels.ternary_matmul` (the hand-written K2 kernel on the card)
   — equal to the dense oracle within 1e-4, 8x fewer weight bytes than bf16.
2. Map a dilated 1-D TCN convolution onto the undilated 2-D conv engine
   (the paper's §4 scheduling trick) and check the equivalence.
3. Close the loop: ``deployed.silicon_report()`` against the paper's Table 1.

    python -m repro_torch.quickstart                 # on the card (default)
    python -m repro_torch.quickstart --device cpu    # plain PyTorch path

Inputs come from seeded `torch.Generator`s on the host.  Prints
``quickstart OK`` and exits 0 when every check holds, else exits 1.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.device import resolve_device


def main(argv=None) -> int:
    from repro_torch.api import BACKENDS, get_net
    from repro_torch.core.cutie_arch import PAPER
    from repro_torch.core.tcn import dilated1d_via_2d, dilated_causal_conv1d
    from repro_torch.kernels import quantize_pack_matmul_weights, ternary_matmul
    from repro_torch.kernels.ref import exact_float32, ternary_matmul_ref

    ap = argparse.ArgumentParser(description="repro_torch quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"  FAIL: {what}", file=sys.stderr)

    def gen(offset: int) -> torch.Generator:
        return torch.Generator().manual_seed(args.seed + offset)

    print(f"=== 0. CutieProgram: one definition, every execution mode ({dev}) ===")
    prog = get_net("cifar10_tnn")
    params = prog.init(gen(0), device=dev)
    x = torch.sign(torch.randn((8, 32, 32, 3), generator=gen(1))).to(dev)
    deployed = prog.quantize(params, calib=x)
    logits = {b: deployed.forward(x, backend=b) for b in BACKENDS}
    same = {b: torch.equal(y, logits["ref"]) for b, y in logits.items()}
    print(f"  {prog.graph.name}: params -> packed 2-bit deploy -> logits "
          f"{tuple(logits['fused'].shape)}; equal to ref exactly: {same}")
    check(all(same.values()), f"backends disagree with ref: {same}")
    check(bool(torch.isfinite(logits["fused"]).all()), "non-finite logits")

    print("=== 1. packed-ternary matmul (CUTIE's arithmetic, K2) ===")
    w = torch.randn((2048, 512), generator=gen(0)).to(dev)
    xm = torch.randn((64, 2048), generator=gen(1)).to(dev)
    w_packed, scale = quantize_pack_matmul_weights(w)
    y = ternary_matmul(xm, w_packed, scale)
    y_ref = ternary_matmul_ref(xm, w_packed, scale)
    close = torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4)
    dense_bytes, packed_bytes = w.numel() * 2, w_packed.numel()
    print(f"  kernel == oracle (rtol=atol=1e-4): {close}, max|diff| "
          f"{(y - y_ref).abs().max().item():.3e}; weight bytes {dense_bytes} -> "
          f"{packed_bytes} ({dense_bytes / packed_bytes:.0f}x smaller)")
    check(close, "ternary_matmul != ternary_matmul_ref")
    check(dense_bytes == 8 * packed_bytes, "packed weights are not 8x smaller than bf16")

    print("=== 2. dilated 1-D conv -> undilated 2-D conv (paper §4) ===")
    sig = torch.randn((1, 24, 96), generator=gen(2)).to(dev)
    ker = torch.randn((3, 96, 96), generator=gen(3)).to(dev)
    with exact_float32():
        for d in (1, 2, 4, 8):
            ref = dilated_causal_conv1d(sig, ker, d)
            mapped = dilated1d_via_2d(sig, ker, d)
            check(torch.allclose(mapped, ref, rtol=1e-4, atol=1e-4),
                  f"§4 mapping differs at dilation {d}")
    print("  mapping exact for dilations 1,2,4,8 — TCNs run on the 2-D engine")

    print("=== 3. CUTIE silicon model vs paper (deployed.silicon_report) ===")
    rep = deployed.silicon_report(v=0.5)
    print(f"  peak efficiency  : {rep.peak_eff_topsw:7.0f} TOp/s/W "
          f"(paper {PAPER['peak_eff_0v5_topsw']:.0f})")
    print(f"  CIFAR-10 energy  : {rep.energy_uj:7.2f} uJ/inf  (paper {PAPER['cifar_energy_uj']})")
    print(f"  CIFAR-10 rate    : {rep.inf_per_s:7.0f} inf/s   (paper {PAPER['cifar_inf_per_s']:.0f})")
    print(f"  calibration consistent: {rep.calibration.consistent}")
    check(abs(rep.energy_uj - PAPER["cifar_energy_uj"]) < 1e-9, "CIFAR energy off the paper corner")
    check(abs(rep.inf_per_s - PAPER["cifar_inf_per_s"]) < 1e-6, "CIFAR rate off the paper corner")
    check(round(rep.peak_eff_topsw) == PAPER["peak_eff_0v5_topsw"], "peak efficiency off")
    check(rep.calibration.consistent, "calibration inconsistent")

    if failures:
        print(f"quickstart FAILED: {len(failures)} check(s)", file=sys.stderr)
        return 1
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
