"""DEPRECATED shim — the paper's networks live in `repro_torch.api`.
Counterpart of `repro.models.cutie_net` (its CUTIE part; the reference's LM
files under `models/` are not ported).

The two benchmark networks (``cifar10_tnn``, ``dvs_cnn_tcn``) are registry
entries compiled to `repro_torch.api.CutieProgram`; QAT, packed deployment,
streaming, and the silicon report are all program methods.  Use:

    from repro_torch.api import get_net
    prog     = get_net("dvs_cnn_tcn")
    params   = prog.init(torch.Generator().manual_seed(0))   # device="cuda"
    deployed = prog.quantize(params)
    session  = deployed.stream(batch=4)

This module keeps the legacy function-per-network surface as thin wrappers
(the reference's signatures, with a `torch.Generator` for the key and a
``device`` where state is created; the same param/deploy tree layout and
numerics).  New code should not import from here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.api.graph import (
    CutieGraph,
    conv2d,
    fc,
    flatten,
    global_pool,
    last_step,
    pool,
    tcn,
)
from repro_torch.api.program import CutieProgram, DeployedProgram
from repro_torch.core.cutie_arch import PAPER
from repro_torch.core.tcn import TCNStream


@dataclasses.dataclass(frozen=True)
class CutieNetConfig:
    """Legacy config; `repro_torch.api.CutieGraph` is the declarative successor."""
    name: str
    channels: int = 96
    n_classes: int = 10
    input_hw: Tuple[int, int] = (32, 32)
    input_ch: int = 3
    act_threshold: float = 0.5
    # DVS/TCN extension
    tcn_layers: int = 0
    tcn_dilations: Tuple[int, ...] = ()
    tcn_steps: int = 24
    tcn_taps: int = 3


CIFAR_TNN = CutieNetConfig(name="cutie_cifar10", channels=96, n_classes=10)
DVS_CNN_TCN = CutieNetConfig(
    name="cutie_dvs", channels=96, n_classes=12, input_hw=(64, 64), input_ch=2,
    tcn_layers=4, tcn_dilations=(1, 2, 4, 8),
)


def _graph(cfg: CutieNetConfig) -> CutieGraph:
    """Map the legacy config onto a CutieGraph, honoring every field —
    the same layer construction the legacy forward functions hardcoded."""
    c = cfg.channels
    if cfg.tcn_layers:
        # DVS frontend: 5 conv layers, stride-2 pooling between, global pool
        shapes = [(cfg.input_ch, 64), (64, 64), (64, 96), (96, 96), (96, c)]
        layers = []
        for ci, co in shapes:
            layers += [conv2d(ci, co), pool()]
        layers.append(global_pool())
        layers += [tcn(c, c, dilation=d, taps=cfg.tcn_taps) for d in cfg.tcn_dilations]
        layers += [last_step(), fc(c, cfg.n_classes)]
        paper = cfg.name == DVS_CNN_TCN.name
        return CutieGraph(
            name=cfg.name, layers=tuple(layers), input_hw=cfg.input_hw,
            input_ch=cfg.input_ch, n_classes=cfg.n_classes,
            act_threshold=cfg.act_threshold, tcn_steps=cfg.tcn_steps,
            passes_per_inference=5,
            paper_energy_uj=PAPER["dvs_energy_uj"] if paper else None,
            paper_inf_per_s=PAPER["dvs_inf_per_s"] / 5.0 if paper else None,
        )
    # CIFAR 9-layer: 2 conv, pool, 3 conv, pool, 3 conv, pool, flatten, FC
    h, w = cfg.input_hw
    layers = (
        conv2d(cfg.input_ch, c), conv2d(c, c), pool(),
        conv2d(c, c), conv2d(c, c), conv2d(c, c), pool(),
        conv2d(c, c), conv2d(c, c), conv2d(c, c), pool(),
        flatten(), fc((h // 8) * (w // 8) * c, cfg.n_classes),
    )
    paper = cfg.name == CIFAR_TNN.name
    return CutieGraph(
        name=cfg.name, layers=layers, input_hw=cfg.input_hw,
        input_ch=cfg.input_ch, n_classes=cfg.n_classes,
        act_threshold=cfg.act_threshold,
        paper_energy_uj=PAPER["cifar_energy_uj"] if paper else None,
        paper_inf_per_s=PAPER["cifar_inf_per_s"] if paper else None,
    )


def _program(cfg: CutieNetConfig) -> CutieProgram:
    return CutieProgram(_graph(cfg))


def init_cutie_params(generator: torch.Generator, cfg: CutieNetConfig,
                      device="cuda") -> Dict:
    return _program(cfg).init(generator, device=device)


def cnn_forward_qat(params, cfg: CutieNetConfig, x: torch.Tensor) -> torch.Tensor:
    """2-D frontend, QAT path: feature vector (DVS) or logits (CIFAR)."""
    return _program(cfg).spatial_forward_qat(params, x)


def tcn_forward_qat(params, cfg: CutieNetConfig, feats: torch.Tensor) -> torch.Tensor:
    """TCN head over the time-ordered feature window [B, T, C] -> logits."""
    return _program(cfg).temporal_forward_qat(params, feats)


def dvs_forward_qat(params, cfg: CutieNetConfig, frames: torch.Tensor) -> torch.Tensor:
    """Full hybrid pass: frames [B, T, H, W, C] -> logits [B, n_classes]."""
    return _program(cfg).forward_qat(params, frames)


def quantize_for_deploy(params, cfg: CutieNetConfig, calib: Optional[torch.Tensor] = None) -> Dict:
    """QAT params -> packed 2-bit deploy tables (see CutieProgram.quantize)."""
    return _program(cfg).quantize(params, calib=calib).tables


def _deployed(dep: Dict, cfg: CutieNetConfig) -> DeployedProgram:
    return DeployedProgram(_program(cfg).graph, dep)


def cnn_forward_deploy(dep, cfg: CutieNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Frontend on the fused ternary conv kernel (int8 trits between layers)."""
    return _deployed(dep, cfg).spatial_forward(x)


def tcn_forward_deploy(dep, cfg: CutieNetConfig, feats: torch.Tensor) -> torch.Tensor:
    """TCN head via the §4 mapping + the fused ternary conv kernel."""
    return _deployed(dep, cfg).temporal_forward(feats)


def make_stream(cfg: CutieNetConfig, batch: Optional[int] = None,
                device="cuda") -> TCNStream:
    return TCNStream.create(cfg.tcn_steps, cfg.channels, batch=batch, device=device)


def stream_step(dep, cfg: CutieNetConfig, stream: TCNStream, frame: torch.Tensor):
    """One sensor frame in -> (logits, updated stream) — the silicon flow."""
    return _deployed(dep, cfg).stream_step(stream, frame)
