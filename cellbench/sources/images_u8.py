"""8-bit images ``[n_seqs, seq_len, H, W, C]`` in [-1, 1), drawn on the device.

Each pixel is ``(k - 128) / 128`` for a uniform byte ``k``: dyadic, so that a
ternary convolution's float32 sums over them are exact in any order.
"""
from __future__ import annotations

import torch


def make_bank(cfg, n_seqs: int, seq_len: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    h, w = cfg["input_hw"]
    k = torch.randint(0, 256, (n_seqs, seq_len, h, w, int(cfg["input_ch"])), generator=gen,
                      device=device)
    return (k.to(torch.float32) - 128.0) / 128.0
