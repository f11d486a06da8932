"""The paper's own networks as selectable configs.  Counterpart of
`repro.configs.cutie_nets`.

``CUTIE_CONFIGS`` keeps the legacy `CutieNetConfig` objects; new code should
use the graph registry instead:

    from repro_torch.api import get_net, list_nets
    prog = get_net("cifar10_tnn")   # or "dvs_cnn_tcn"
"""
from repro_torch.models.cutie_net import CIFAR_TNN, DVS_CNN_TCN

CUTIE_CONFIGS = {
    "cutie_cifar10": CIFAR_TNN,
    "cutie_dvs": DVS_CNN_TCN,
}


def cutie_graph(name: str):
    """Registry graph for a legacy config name (or any registered net)."""
    from repro_torch.api import get_graph

    return get_graph(name)
