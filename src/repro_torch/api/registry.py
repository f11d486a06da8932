"""Network registry: name -> `CutieGraph` factory -> `CutieProgram`.

New workloads are one `register_net` call; everything downstream (QAT,
packed deploy, streaming, silicon report, serving) composes against the
returned `CutieProgram`.  Seeded with the paper's two benchmark networks:

  * ``cifar10_tnn``  — the 9-layer (8 conv + FC) 96-channel ternary CNN of
    §7, behind the 2.72 uJ / 1036 TOp/s/W headline numbers.
  * ``dvs_cnn_tcn``  — the hybrid 2-D-CNN + dilated-TCN of [6] (5-layer CNN
    frontend into a 24-step TCN memory, 4 dilated TCN layers, 12-class head).

Plus ``cifar10_tnn_wide`` — a 192-channel, 5x5-stem variant whose schedule
(C_in/OCU tiling, multi-pass windows) only the `repro.sim` execution plan
can express; the analytic formula misprices it (see docs/simulator.md).

And ``kws_tcn`` — a keyword-spotting TCN in the style of [10]: a strided
3x3 stem and 1x1 pointwise convs over single-channel spectrogram frames
into a dilated-TCN head.  It exists to exercise the stride/1x1 layer
kinds end to end (lower -> bitsim -> fused -> ``.cutie`` artifact) and is
the always-on workload the activity gate duty-cycles in serving.

Legacy aliases ``cutie_cifar10`` / ``cutie_dvs`` map to the same graphs.

The port's own copy of `repro.api.registry`: same nets, same names, same
shapes; `get_net` compiles to the port's `CutieProgram`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

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
from repro_torch.api.program import CutieProgram

# The paper-reported corners the graphs calibrate against — literal copies of
# the `PAPER` entries of the reference's `core/cutie_arch.py` (that module is
# ported with the silicon model).
PAPER = dict(
    cifar_energy_uj=2.72,
    cifar_inf_per_s=3200.0,
    dvs_energy_uj=5.5,
    dvs_inf_per_s=8000.0,
    tcn_steps=24,
)

GraphFactory = Callable[[], CutieGraph]

_REGISTRY: Dict[str, GraphFactory] = {}


def register_net(name: str, graph: Union[CutieGraph, GraphFactory, None] = None):
    """Register a graph (or zero-arg factory) under ``name``.

    Usable directly — ``register_net("mynet", graph)`` — or as a decorator
    over a factory function.  Graphs are validated at registration.
    """
    def _register(b: GraphFactory) -> GraphFactory:
        b().validate()
        _REGISTRY[name] = b
        return b

    if graph is None:
        return _register
    if isinstance(graph, CutieGraph):
        g = graph.validate()
        _REGISTRY[name] = lambda: g
        return _REGISTRY[name]
    return _register(graph)


def get_net(name: str) -> CutieProgram:
    """Compile the registered graph into a ready-to-use `CutieProgram`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown net {name!r}; registered: {sorted(_REGISTRY)}")
    return CutieProgram(_REGISTRY[name]())


def get_graph(name: str) -> CutieGraph:
    """The registered graph itself (un-compiled) — for `dataclasses.replace`
    tweaks (e.g. `qat_per_channel=True`) before building a `CutieProgram`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown net {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_nets() -> List[str]:
    """Registered net names, sorted — what ``--net`` accepts everywhere."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# The paper's two benchmark networks
# ---------------------------------------------------------------------------

def cifar10_tnn_graph(
    channels: int = 96,
    n_classes: int = 10,
    input_hw: Tuple[int, int] = (32, 32),
    name: str = "cifar10_tnn",
) -> CutieGraph:
    """VGG-like 9-layer TNN: 2x conv @32, pool, 3x conv @16, pool,
    3x conv @8, pool, flatten, FC.  ``input_hw`` must be divisible by 8
    (three 2x2 pools); non-default sizes drop the paper calibration."""
    c = channels
    h, w = input_hw
    layers = (
        conv2d(3, c), conv2d(c, c), pool(),
        conv2d(c, c), conv2d(c, c), conv2d(c, c), pool(),
        conv2d(c, c), conv2d(c, c), conv2d(c, c), pool(),
        flatten(), fc((h // 8) * (w // 8) * c, n_classes),
    )
    is_paper = channels == 96 and input_hw == (32, 32) and n_classes == 10
    return CutieGraph(
        name=name,
        layers=layers,
        input_hw=input_hw,
        input_ch=3,
        n_classes=n_classes,
        paper_energy_uj=PAPER["cifar_energy_uj"] if is_paper else None,
        paper_inf_per_s=PAPER["cifar_inf_per_s"] if is_paper else None,
    )


def dvs_cnn_tcn_graph(
    channels: int = 96,
    n_classes: int = 12,
    input_hw: Tuple[int, int] = (64, 64),
    tcn_steps: int = PAPER["tcn_steps"],
    name: str = "dvs_cnn_tcn",
) -> CutieGraph:
    """Hybrid gesture network of [6]: 5 conv+pool stages (64 -> 2 px),
    global pool to a feature vector, 4 dilated TCN layers (D = 1,2,4,8)
    through the §4 mapping, last-step FC head.  One classification = 5 CNN
    passes through the TCN memory + the TCN head (paper's counting).

    Frontend widths scale with ``channels`` (2c/3, 2c/3, c, c, c — the
    paper's 64/64/96/96/96 at c=96); ``input_hw`` must be divisible by 32
    (five 2x2 pools).  Non-default sizes drop the paper calibration."""
    c = channels
    c23 = 2 * c // 3
    layers = (
        conv2d(2, c23), pool(),
        conv2d(c23, c23), pool(),
        conv2d(c23, c), pool(),
        conv2d(c, c), pool(),
        conv2d(c, c), pool(),
        global_pool(),
        tcn(c, c, dilation=1), tcn(c, c, dilation=2),
        tcn(c, c, dilation=4), tcn(c, c, dilation=8),
        last_step(), fc(c, n_classes),
    )
    is_paper = (channels == 96 and input_hw == (64, 64)
                and tcn_steps == PAPER["tcn_steps"] and n_classes == 12)
    return CutieGraph(
        name=name,
        layers=layers,
        input_hw=input_hw,
        input_ch=2,
        n_classes=n_classes,
        tcn_steps=tcn_steps,
        passes_per_inference=5,
        paper_energy_uj=PAPER["dvs_energy_uj"] if is_paper else None,
        paper_inf_per_s=PAPER["dvs_inf_per_s"] / 5.0 if is_paper else None,
    )


def cifar10_tnn_wide_graph(
    channels: int = 192,
    stem_kernel: Tuple[int, int] = (5, 5),
    n_classes: int = 10,
    input_hw: Tuple[int, int] = (32, 32),
    name: str = "cifar10_tnn_wide",
) -> CutieGraph:
    """A deliberately *un-analytic* CIFAR variant: a ``stem_kernel`` (5x5)
    input conv and ``channels`` (192) > the 96-OCU array width.

    The closed-form silicon model prices every layer at one pixel/cycle
    with a 3x3 window — it cannot express the extra window passes a 5x5
    kernel needs, and only coarsely tiles the >96-channel layers.  The
    `repro.sim` `ExecutionPlan` schedules both explicitly (per-tile
    `TileAssign`s, ``window_passes`` in the counters), which is the point
    of this net: `sim.reconcile` reports ``analytic_schedulable=False``
    and a large, *documented* cycle divergence (see docs/simulator.md).
    ``input_hw`` must be divisible by 8 (three 2x2 pools)."""
    c = channels
    h, w = input_hw
    layers = (
        conv2d(3, c, kernel=stem_kernel), pool(),
        conv2d(c, c), pool(),
        conv2d(c, c), pool(),
        flatten(), fc((h // 8) * (w // 8) * c, n_classes),
    )
    return CutieGraph(
        name=name,
        layers=layers,
        input_hw=input_hw,
        input_ch=3,
        n_classes=n_classes,
    )


def kws_tcn_graph(
    channels: int = 64,
    head_channels: int = 96,
    n_classes: int = 12,
    input_hw: Tuple[int, int] = (32, 32),
    tcn_steps: int = 16,
    name: str = "kws_tcn",
) -> CutieGraph:
    """Keyword-spotting TCN (the TCN-on-MFCC family of [10]): strided 3x3
    stem halving a 1-channel spectrogram patch, 1x1 pointwise mixers
    between stages, global pool into a 3-layer dilated TCN, 12-keyword
    last-step head.  One classification = ``passes_per_inference``
    spectrogram frames pushed through the TCN memory.

    This net is the registry's stride/1x1 coverage: both strided convs
    subsample post-ternarize (never pool-fused), both pointwise layers run
    the same kernels at kh = kw = 1 — all analytically schedulable, so it
    joins the reconcile and stall-free gates alongside the paper nets.
    ``input_hw`` must be divisible by 4 (two stride-2 stages)."""
    c, ch = channels, head_channels
    layers = (
        conv2d(1, c, stride=2),
        conv2d(c, c, kernel=(1, 1)),
        conv2d(c, ch, stride=2),
        conv2d(ch, ch, kernel=(1, 1)),
        global_pool(),
        tcn(ch, ch, dilation=1), tcn(ch, ch, dilation=2),
        tcn(ch, ch, dilation=4),
        last_step(), fc(ch, n_classes),
    )
    return CutieGraph(
        name=name,
        layers=layers,
        input_hw=input_hw,
        input_ch=1,
        n_classes=n_classes,
        tcn_steps=tcn_steps,
        passes_per_inference=4,
    )


register_net("cifar10_tnn", cifar10_tnn_graph)
register_net("dvs_cnn_tcn", dvs_cnn_tcn_graph)
register_net("cifar10_tnn_wide", cifar10_tnn_wide_graph)
register_net("kws_tcn", kws_tcn_graph)
# legacy config names from configs/cutie_nets.py
register_net("cutie_cifar10", cifar10_tnn_graph)
register_net("cutie_dvs", dvs_cnn_tcn_graph)
# shrunken variants with the same layer structure — CI bench-smoke targets
register_net(
    "cifar10_tnn_smoke",
    lambda: cifar10_tnn_graph(channels=8, input_hw=(16, 16), name="cifar10_tnn_smoke"),
)
register_net(
    "dvs_cnn_tcn_smoke",
    lambda: dvs_cnn_tcn_graph(
        channels=12, input_hw=(32, 32), tcn_steps=8, name="dvs_cnn_tcn_smoke"
    ),
)
register_net(
    "cifar10_tnn_wide_smoke",
    lambda: cifar10_tnn_wide_graph(
        channels=8, input_hw=(16, 16), name="cifar10_tnn_wide_smoke"
    ),
)
register_net(
    "kws_tcn_smoke",
    lambda: kws_tcn_graph(
        channels=8, head_channels=12, input_hw=(16, 16), tcn_steps=6,
        name="kws_tcn_smoke",
    ),
)
# two more CI-sized temporal variants so the fleet lanes (fleet-smoke,
# serving bench, launch --fleet) have >= 3 genuinely distinct TCN nets to
# serve concurrently — different widths, ring depths, and head sizes
register_net(
    "dvs_cnn_tcn_micro",
    lambda: dvs_cnn_tcn_graph(
        channels=9, input_hw=(32, 32), tcn_steps=6, name="dvs_cnn_tcn_micro"
    ),
)
register_net(
    "dvs_cnn_tcn_nano",
    lambda: dvs_cnn_tcn_graph(
        channels=6, n_classes=6, input_hw=(32, 32), tcn_steps=4,
        name="dvs_cnn_tcn_nano",
    ),
)
