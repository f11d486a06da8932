"""Ternary-QAT language model training on the PyTorch port — the paper's
technique as an LM feature (BitNet-style: every projection through the TWN
STE).  Counterpart of `examples/train_ternary_lm.py`.

Runs a reduced config by default; pass --full-100m for a ~100M-param
gemma-family model (the code path of `repro_torch.launch.train_lm`, which
adds checkpoints and restarts; the paper's own QAT loop is
`repro_torch.train`, driven by `repro_torch.launch.train`).

    PYTHONPATH=src python examples/train_ternary_lm_torch.py [--steps 100] \
        [--full-100m] [--compress-grads] [--device cpu]

``--device`` defaults to ``cuda``; without a CUDA device that is an error.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.capture import CapturedStep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ternary import sparsity, ternary_quantize_weights  # noqa: E402
from repro_torch.data.pipeline import LMTokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_train_state, make_train_step  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="ternary gradient compression (TernGrad + error feedback)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("gemma-2b", smoke=True, quant="ternary")
    if args.full_100m:
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=3072, vocab_size=32768, name="ternary-lm-100m",
        )
    print(f"[qat] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, quant={cfg.quant}, "
          f"compress_grads={args.compress_grads}, device={device}")

    pipe = LMTokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    # the reference's jax.jit(step, donate_argnums=(0,)): on the card one
    # eager step, then a CUDA graph replayed over the state it writes in place
    step = CapturedStep(make_train_step(cfg, opt, compress_grads=args.compress_grads,
                                        donate=True), device, inputs=(1,))
    state = make_train_state(cfg, torch.Generator(device=device).manual_seed(0),
                             compress=args.compress_grads, device=device)

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state, m = step(state, pipe.next_batch())
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"  step {i:4d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e}")
    dt = time.time() - t0
    print(f"[qat] {args.steps} steps in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        print("[qat] FAIL: QAT did not learn", file=sys.stderr)
        return 1

    # what the deployed (packed) model looks like:
    w = state.params["seg0"]["sub0"]["mlp"]["w_up"]["w"]
    t, _ = ternary_quantize_weights(w[0] if w.ndim == 3 else w, axis=0)
    print(f"[qat] deployed ternary sparsity of a trained w_up: {float(sparsity(t)):.2f} "
          f"(zeros cost nothing on the wire and gate no multiply)")
    print("train_ternary_lm_torch OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
