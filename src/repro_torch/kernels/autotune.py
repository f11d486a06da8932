"""Plan-driven kernel blocks: `TileAssign` geometry -> ``block_cout``.

Counterpart of `repro.kernels.autotune`, with the same rule and the same
results (`kernel_block_plan` equals the reference's for every registry net).

In the port ``block_cout`` is the plan's **logical OCU tile**, not a launch
parameter: the CUDA kernels under `repro_torch/csrc` pick their own tiles
(32 output channels per block for the conv kernel) and ignore it.  It stays
visible — `DeployedProgram.kernel_blocks` and `PlanExecutor` expose it —
because it is the bridge between the schedule the silicon model prices and
the kernel launches: a uniform ``"plan"`` block means the layer's OCU tile
passes are one width.

Selection rule (`block_for_layer`):

  * **plan-derived** — when the layer's `TileAssign`s have ONE uniform
    output-channel width and the kernel fits the OCU window engine
    (kh, kw <= 3), the block IS the tile width (96 on every 96-channel
    layer of the paper nets).
  * **fallback** — otherwise (a 5x5 stem, ragged tile widths) the block
    comes from `MEASURED_FALLBACK_BLOCKS`, the reference's table (measured
    on its CPU paths; kept so both packages name the same blocks): the
    largest entry that divides C_out, else C_out itself.

Everything here is a pure function of the plan.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List

if TYPE_CHECKING:  # no kernels -> sim import at module load
    from repro_torch.sim.plan import ExecutionPlan, LayerPlan

# The reference's block candidates, largest first.
MEASURED_FALLBACK_BLOCKS = (128, 96, 64, 48, 32, 24, 16, 8)

# The OCU window engine holds kh x kw <= 3 x 3 natively.
_NATIVE_WINDOW = 3


@dataclasses.dataclass(frozen=True)
class KernelBlock:
    """One layer's block.  ``source``: ``"plan"`` (the `TileAssign` cout
    width) or ``"fallback"`` (the table — the plan cannot describe the layer
    as uniform single-window passes)."""

    block_cout: int
    source: str  # "plan" | "fallback"


def _fallback_block(c_out: int) -> int:
    for b in MEASURED_FALLBACK_BLOCKS:
        if b <= c_out and c_out % b == 0:
            return b
    return c_out


def block_for_layer(lp: "LayerPlan") -> KernelBlock:
    """The block of one conv2d/tcn `LayerPlan` (see the module docstring)."""
    if lp.kind not in ("conv2d", "tcn"):
        raise ValueError(
            f"layer {lp.index} ({lp.kind}) has no conv kernel block; only "
            "conv2d/tcn layers dispatch through ternary_conv2d"
        )
    widths = lp.cout_tile_widths
    if len(widths) == 1 and lp.kh <= _NATIVE_WINDOW and lp.kw <= _NATIVE_WINDOW:
        return KernelBlock(block_cout=widths[0], source="plan")
    return KernelBlock(block_cout=_fallback_block(lp.c_out), source="fallback")


def kernel_block_plan(plan: "ExecutionPlan") -> Dict[str, List[KernelBlock]]:
    """Per-layer blocks keyed the way the deploy tables are:
    ``{"conv": [...], "tcn": [...]}`` in layer order."""
    blocks: Dict[str, List[KernelBlock]] = {"conv": [], "tcn": []}
    for lp in plan.layers:
        if lp.kind in ("conv2d", "tcn"):
            blocks["conv" if lp.kind == "conv2d" else "tcn"].append(block_for_layer(lp))
    return blocks
