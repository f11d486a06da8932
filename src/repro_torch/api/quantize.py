"""THE quantize -> pad -> pack path — counterpart of `repro.api.quantize`.

All helpers return ``(packed_uint8, scale)`` where ``unpack(packed) * scale``
approximates the input weights (TWN: per-group threshold nu * E|w|).  The
packed bytes are not a storage-only format: the conv and matmul kernels consume them
verbatim as operands and decode each 2-bit field in the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tcn import project_weights_to_2d
from repro_torch.core.ternary import (
    TERNARY_NU_DEFAULT,
    clamp_threshold,
    pack_ternary,
    ternary_quantize_weights,
)


def resolve_deploy_thresholds(graph, params) -> dict:
    """Per-layer activation thresholds for the deploy tables.

    When ``params`` carries a ``"thresh"`` group, each learned threshold is
    clamped exactly as the QAT forward clamps it and materialized as a
    Python float (scalar) or a float32 [c_out] tensor (per-channel).
    Without the group every layer falls back to the graph's static
    ``act_threshold``.  Returns ``{"conv": [t...], "tcn": [t...]}`` in
    layer order."""
    n_conv = sum(l.kind == "conv2d" for l in graph.layers)
    n_tcn = sum(l.kind == "tcn" for l in graph.layers)
    th = params.get("thresh") if hasattr(params, "get") else None
    if th is None:
        return {"conv": [graph.act_threshold] * n_conv,
                "tcn": [graph.act_threshold] * n_tcn}

    def _fold(t):
        clamped = clamp_threshold(torch.as_tensor(t, dtype=torch.float32))
        return float(clamped) if clamped.ndim == 0 else clamped

    return {
        "conv": [_fold(t) for t in th.get("conv", [])],
        "tcn": [_fold(t) for t in th.get("tcn", [])],
    }


def _pad_axis_to_4(t: torch.Tensor, axis: int) -> torch.Tensor:
    pad = (-t.shape[axis]) % 4
    if pad == 0:
        return t
    widths = [0, 0] * t.ndim
    widths[2 * (t.ndim - 1 - axis % t.ndim) + 1] = pad  # F.pad lists the last axis first
    return F.pad(t, widths)


def quantize_pad_pack(
    w: torch.Tensor, *, reduce_axes, pack_axis: int, nu: float = TERNARY_NU_DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternary-quantize ``w`` (thresholding over ``reduce_axes``), zero-pad
    ``pack_axis`` to a multiple of 4 (zero trits contribute nothing), and
    pack 4 trits/byte along it."""
    t, alpha = ternary_quantize_weights(w, nu=nu, axis=reduce_axes)
    return pack_ternary(_pad_axis_to_4(t, pack_axis), axis=pack_axis), alpha.reshape(-1)


def quantize_pack_matmul_weights(
    w: torch.Tensor, nu: float = TERNARY_NU_DEFAULT
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> ([ceil(K/4), N] uint8 packed along K, [N] per-column
    scale) — the operands of `kernels.ops.ternary_matmul`."""
    return quantize_pad_pack(w, reduce_axes=0, pack_axis=0, nu=nu)


def quantize_pack_conv_weights(
    w: torch.Tensor, nu: float = TERNARY_NU_DEFAULT
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[KH, KW, C_in, C_out] float -> packed along C_in + per-C_out scale."""
    return quantize_pad_pack(w, reduce_axes=(0, 1, 2), pack_axis=2, nu=nu)


def quantize_pack_tcn_weights(
    w: torch.Tensor, nu: float = TERNARY_NU_DEFAULT, *, kh: int = 3, kw: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D TCN kernel [N, C_in, C_out] -> packed 2-D kernel via the paper's
    §4 weight projection (taps into the middle column of a KHxKW kernel),
    then the same pad+pack as any conv weight."""
    t, alpha = ternary_quantize_weights(w, nu=nu, axis=(0, 1))
    k2d = project_weights_to_2d(t.to(torch.int8), kh=kh, kw=kw)
    return pack_ternary(_pad_axis_to_4(k2d, 2), axis=2), alpha.reshape(-1)
