"""Device meshes.  Counterpart of `repro.launch.mesh`.

A `Mesh` names its axes and holds its devices in a numpy object array, so
``mesh.devices.shape`` reads as the reference's.  The port has no SPMD
partitioner: a mesh is what the sharding plan (`launch/sharding.py`) and the
dry-run (`launch/dryrun.py`) reason about.  `torch.distributed`'s
``DeviceMesh`` would need a process group, which neither the dry-run nor
one card has.

Functions, not module-level constants, so importing this module touches no
device state.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


class AbstractDevice(NamedTuple):
    """A placeholder for a device of a mesh that no process owns."""
    id: int


class Mesh:
    """``axis_names`` over an n-d array of ``devices`` (`torch.device`s, or
    `AbstractDevice` placeholders for a planned mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def abstract(self) -> bool:
        """True for a planned mesh (placeholders, no real device)."""
        return all(isinstance(d, AbstractDevice) for d in self.devices.flat)

    def __repr__(self) -> str:
        shape = dict(zip(self.axis_names, self.devices.shape))
        return f"Mesh({shape}{', abstract' if self.abstract else ''})"


def _abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    devices[:] = [AbstractDevice(i) for i in range(n)]
    return Mesh(devices.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes as abstract meshes: ``(16, 16)``
    over ``("data", "model")`` plans 256 devices, ``(2, 16, 16)`` over
    ``("pod", "data", "model")`` plans 512.  The shapes stay the
    reference's so both packages' plans compare leaf for leaf; the dry-run
    checks what one device of such a mesh holds against the card's own
    capacity."""
    if multi_pod:
        return _abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return _abstract_mesh((16, 16), ("data", "model"))


def make_local_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The local devices as a degenerate ``(n, 1)`` (data, model) mesh.

    ``device`` defaults to ``cuda``: every visible card (``n`` =
    ``torch.cuda.device_count()``); without a card it raises.  A device
    with an index (``cuda:0``) or ``cpu`` is one device, ``n`` = 1."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    arr = np.empty((len(devices), 1), dtype=object)
    arr[:, 0] = devices
    return Mesh(arr, ("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))

