"""DVS event frames ``[n_seqs, seq_len, H, W, 2]`` — the port's
`DVSEventPipeline` (``src/repro_torch/data/pipeline.py``) drawn on the device.

Each sequence is a gesture-like blob of radius 5 moving 4 px a frame along its
class's direction from near the centre, on/off polarity split at random, plus
1 % noise events in channel 0: the unstructured sparsity (2-6 % events a
frame) of the paper's DVS128 workload.  One change from the original: the
blob wraps around the frame's edges, so a clip of 192 frames keeps its events
instead of leaving the frame after a dozen.
"""
from __future__ import annotations

import math

import torch


def make_bank(cfg, n_seqs: int, seq_len: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    hw, n_classes = int(cfg["input_hw"][0]), int(cfg["n_classes"])
    labels = torch.randint(0, n_classes, (n_seqs,), generator=gen, device=device)
    ang = 2 * math.pi * labels.to(torch.float32) / n_classes
    cx = hw // 2 + torch.randint(-8, 8, (n_seqs,), generator=gen, device=device)
    cy = hw // 2 + torch.randint(-8, 8, (n_seqs,), generator=gen, device=device)
    t = torch.arange(seq_len, device=device, dtype=torch.float32)
    px = cx[:, None] + torch.cos(ang)[:, None] * t * 4   # [S, L]
    py = cy[:, None] + torch.sin(ang)[:, None] * t * 4
    grid = torch.arange(hw, device=device, dtype=torch.float32)
    out = torch.zeros((n_seqs, seq_len, hw, hw, 2), dtype=torch.float32, device=device)
    for s in range(n_seqs):  # one sequence at a time bounds the temporaries
        dx = torch.remainder(grid[None, None, :] - px[s, :, None, None] + hw / 2, hw) - hw / 2
        dy = torch.remainder(grid[None, :, None] - py[s, :, None, None] + hw / 2, hw) - hw / 2
        blob = dx * dx + dy * dy < 25
        on = blob & (torch.rand((seq_len, hw, hw), generator=gen, device=device) < 0.5)
        bg = torch.rand((seq_len, hw, hw), generator=gen, device=device) < 0.01
        out[s, ..., 0] = (on | bg).to(torch.float32)
        out[s, ..., 1] = (blob & ~on).to(torch.float32)
    return out
