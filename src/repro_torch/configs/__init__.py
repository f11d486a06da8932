"""Config registry: ``--arch <id>`` resolution for launchers/tests/benches.
Counterpart of `repro.configs`: the same ten architectures in the same
order, each ``CONFIG`` and ``SMOKE`` equal field for field.

Every assigned architecture ships its exact published dims (CONFIG) and a
structurally-identical reduced config (SMOKE) that runs a real train step on
one CPU device.  ``get_config(name, quant=...)`` applies the paper's ternary
technique to any arch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig

from repro_torch.configs import (
    dbrx_132b,
    deepseek_coder_33b,
    deepseek_v2_lite_16b,
    gemma_2b,
    glm4_9b,
    internvl2_76b,
    jamba_v0_1_52b,
    mamba2_370m,
    qwen2_5_32b,
    seamless_m4t_medium,
)

_MODULES = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "dbrx-132b": dbrx_132b,
    "qwen2.5-32b": qwen2_5_32b,
    "glm4-9b": glm4_9b,
    "gemma-2b": gemma_2b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-76b": internvl2_76b,
    "mamba2-370m": mamba2_370m,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str, *, quant: str = "none", smoke: bool = False, **overrides) -> ModelConfig:
    mod = _MODULES[name]
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if quant != "none":
        overrides["quant"] = quant
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic sequence mixing (per assignment)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def all_cells(quant: str = "none"):
    """Every (arch x shape) dry-run cell, with applicability filtering."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch, quant=quant)
        for shape in SHAPES.values():
            cells.append((cfg, shape, shape_applicable(cfg, shape)))
    return cells
