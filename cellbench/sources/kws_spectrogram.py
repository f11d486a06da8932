"""Keyword-spotting spectrogram frames ``[n_seqs, seq_len, H, W, 1]`` — the
port's `KWSSpectrogramPipeline` (``src/repro_torch/data/pipeline.py``) drawn
on the device.

Each class has a fixed sparse ternary spectral prototype (15 % of bins set);
frame t of a sequence rolls its class's prototype t bins along the frequency
axis, and 2 % of the bins are replaced by a random sign.  Silence (all-zero
frames) is laid over the bank by the mix's activity runs.
"""
from __future__ import annotations

import torch


def make_bank(cfg, n_seqs: int, seq_len: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    hw, n_classes = int(cfg["input_hw"][0]), int(cfg["n_classes"])
    keep = torch.rand((n_classes, hw, hw), generator=gen, device=device) < 0.15
    sign = torch.sign(torch.randn((n_classes, hw, hw), generator=gen, device=device))
    protos = torch.where(keep, sign, torch.zeros_like(sign))
    labels = torch.randint(0, n_classes, (n_seqs,), generator=gen, device=device)
    rows = torch.remainder(torch.arange(hw, device=device)[None, :]
                           - torch.arange(seq_len, device=device)[:, None], hw)  # [L, H]
    x = protos[labels][:, rows]  # [S, L, H, W]: np.roll(proto, t, axis=0) per frame
    flip = torch.rand(x.shape, generator=gen, device=device) < 0.02
    noise = torch.sign(torch.randn(x.shape, generator=gen, device=device))
    return torch.where(flip, noise, x).to(torch.float32)[..., None]
