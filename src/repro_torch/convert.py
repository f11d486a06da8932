"""Carry weights and deploy tables across from the reference package.

The reference's arrays are handed over **as numpy** by the caller (a parity
test does the ``np.asarray``); this module never imports the reference or
its array library.  It is the bridge the bit-exactness tests stand on: the
quantizer's threshold and the calibration std are order-dependent float
reductions, so the deploy path is compared on the reference's own tables
(bytes, scales, ``bn_sd``) rather than on tables re-derived here.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.api.graph import CutieGraph
from repro_torch.api.program import DeployedProgram
from repro_torch.api.registry import get_graph
from repro_torch.device import resolve_device

_ARRAY_DTYPES = {
    "packed": torch.uint8, "scale": torch.float32, "bn_sd": torch.float32,
    "t": torch.int8,
}


def _tensor(a, dtype, device) -> torch.Tensor:
    # a writable C-ordered copy (a 0-d array stays 0-d)
    return torch.from_numpy(np.array(a, order="C")).to(device=device, dtype=dtype)


def _entry(entry: Dict, device) -> Dict:
    out: Dict = {}
    for key, value in entry.items():
        if key in _ARRAY_DTYPES:
            out[key] = _tensor(value, _ARRAY_DTYPES[key], device)
        elif key == "threshold":
            # a Python float (scalar) or a per-channel [C_out] vector
            thr = np.asarray(value)
            out[key] = float(thr) if thr.ndim == 0 else _tensor(thr, torch.float32, device)
        elif key in ("pool", "dilation"):
            out[key] = int(value)
        else:
            raise ValueError(f"unknown deploy-table key {key!r}")
    return out


def deployed_from_reference_tables(
    graph: Union[str, CutieGraph], tables_numpy: Dict, device="cuda"
) -> DeployedProgram:
    """A port `DeployedProgram` over the reference's ``DeployedProgram
    .tables`` handed over as numpy: per conv/tcn entry ``packed`` (uint8),
    ``scale``, ``threshold``, ``pool`` / ``dilation`` and optionally
    ``bn_sd``; ``fc`` with ``t`` (int8 trits) and ``scale``.  ``graph`` is a
    registry name or a port `CutieGraph` describing the same network."""
    dev = resolve_device(device)
    g = get_graph(graph) if isinstance(graph, str) else graph.validate()
    tables = {
        "conv": [_entry(e, dev) for e in tables_numpy.get("conv", [])],
        "tcn": [_entry(e, dev) for e in tables_numpy.get("tcn", [])],
        "fc": _entry(tables_numpy.get("fc", {}), dev),
    }
    return DeployedProgram(g, tables)


def params_from_reference(params_numpy: Dict, device="cuda") -> Dict:
    """The float QAT params of the reference (``{"conv": [{"w"}...], "tcn":
    [{"w"}...], "fc": {"w"}, ("thresh": {...})}`` as numpy) as float32
    tensors on ``device``."""
    dev = resolve_device(device)

    def conv(a):
        return _tensor(a, torch.float32, dev)

    p: Dict = {}
    for kind in ("conv", "tcn"):
        if kind in params_numpy:
            p[kind] = [{"w": conv(lp["w"])} for lp in params_numpy[kind]]
    if "fc" in params_numpy:
        p["fc"] = {"w": conv(params_numpy["fc"]["w"])}
    if "thresh" in params_numpy:
        p["thresh"] = {
            kind: [conv(t) for t in ts] for kind, ts in params_numpy["thresh"].items()
        }
    return p


def train_state_from_reference(state_numpy: Dict, device="cuda") -> Dict:
    """The reference's QAT train state ``{"params", "opt": AdamWState(step,
    m, v)}`` handed over as numpy (the NamedTuple, or any ``(step, m, v)``
    sequence) as the port's state on ``device``: float32 params and
    moments, an int32 0-d ``step``."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    step, m, v = state_numpy["opt"]
    return {
        "params": params_from_reference(state_numpy["params"], device=dev),
        "opt": AdamWState(
            step=_tensor(step, torch.int32, dev),
            m=params_from_reference(m, device=dev),
            v=params_from_reference(v, device=dev),
        ),
    }
