"""`repro_torch.api` — the declarative program layer of the port.

    from repro_torch.api import get_net
    prog     = get_net("cifar10_tnn")
    params   = prog.init(torch.Generator().manual_seed(0), device="cuda")
    deployed = prog.quantize(params)
    logits   = deployed.forward(x, backend="fused")   # | "kernel" | "ref" | "bitsim"
    report   = deployed.silicon_report(v=0.5)          # paper Table 1 loop

Submodules:
    graph     LayerSpec / CutieGraph + constructor helpers
    quantize  THE quantize->pad->pack path
    program   CutieProgram / DeployedProgram / StreamSession
    registry  register_net / get_net, seeded with the paper's networks
"""
from repro_torch.api import quantize
from repro_torch.api.graph import (
    CutieGraph,
    LayerSpec,
    conv2d,
    fc,
    flatten,
    global_pool,
    last_step,
    pool,
    tcn,
)
from repro_torch.api.program import (
    BACKENDS,
    SILICON_SOURCES,
    CutieProgram,
    DeployedProgram,
    SiliconReport,
    StreamSession,
    check_backend,
    effective_scale,
    export_conv_layers,
    silicon_report,
    silicon_report_from_plan,
)
from repro_torch.api.registry import (
    cifar10_tnn_graph,
    cifar10_tnn_wide_graph,
    dvs_cnn_tcn_graph,
    get_graph,
    get_net,
    kws_tcn_graph,
    list_nets,
    register_net,
)

__all__ = [
    "CutieGraph", "LayerSpec", "conv2d", "fc", "flatten", "global_pool",
    "last_step", "pool", "tcn", "quantize", "BACKENDS", "CutieProgram",
    "DeployedProgram", "StreamSession", "check_backend", "effective_scale",
    "SILICON_SOURCES", "SiliconReport", "export_conv_layers", "silicon_report",
    "silicon_report_from_plan",
    "register_net", "get_net", "get_graph", "list_nets", "cifar10_tnn_graph",
    "dvs_cnn_tcn_graph", "cifar10_tnn_wide_graph", "kws_tcn_graph",
]
