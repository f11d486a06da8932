"""Packed-ternary LLM serving on the port: 2-bit weights end to end.
Counterpart of `examples/ternary_llm_decode.py`.

LLM decode is memory-bound: ``ternary_packed`` weights move 8x fewer bytes
per token than bf16.  This example builds the reduced ``gemma-2b`` with
``quant='ternary_packed'`` (uint8 storage, four trits a byte), prefills a
batch of prompts and decodes greedily, on the card by default.  As the
reference jits its decode step with the cache donated, the decode step
donates the cache and is captured once as a CUDA graph on the card, then
replayed per token (`repro_torch.capture.CapturedStep`).

    PYTHONPATH=src python examples/ternary_llm_decode_torch.py [--tokens 12]
    PYTHONPATH=src python examples/ternary_llm_decode_torch.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.capture import CapturedStep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=24)
ap.add_argument("--tokens", type=int, default=12)
ap.add_argument("--device", default="cuda",
                help="cuda (default; an error without a card) or cpu")
args = ap.parse_args()

device = resolve_device(args.device)
cfg = get_config("gemma-2b", smoke=True, quant="ternary_packed")
gen = torch.Generator(device=device).manual_seed(0)
params = init_params(cfg, gen, dtype=torch.float32, device=device)

leaves = tree_leaves(params)
packed = sum(l.numel() for l in leaves if l.dtype == torch.uint8)
dense_f = sum(l.numel() for l in leaves if l.dtype != torch.uint8)
print(f"[decode] {cfg.name}: {packed} packed-uint8 bytes "
      f"(= {packed*4} ternary weights), {dense_f} float params (norms/embeds)")

prefill = make_prefill_step(cfg, args.prompt_len + args.tokens, cache_dtype=torch.float32)
decode = CapturedStep(make_decode_step(cfg, donate=True), device, inputs=(1,))


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                        device=device)
logits, cache = prefill(params, {"tokens": prompts})
tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
out = [tok]
sync()
t0 = time.perf_counter()
for _ in range(args.tokens - 1):
    logits, cache = decode(params, tok, cache)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out.append(tok)
sync()
dt = (time.perf_counter() - t0) / max(args.tokens - 1, 1)
seq = torch.cat(out, dim=1).cpu().numpy()
assert torch.isfinite(logits).all()
name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
print(f"[decode] {dt*1e3:.1f} ms/token on {name}; generated: {seq[0]}")
print("ternary_llm_decode OK")
