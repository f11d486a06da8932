"""Device meshes.  Counterpart of `repro.launch.mesh`.

A `Mesh` names its axes and holds its devices in a numpy object array, so
``mesh.devices.shape`` reads as the reference's.  The port has no SPMD
partitioner: a mesh is what the sharding plan (`launch/sharding.py`) and the
dry-run (`launch/dryrun.py`) reason about.

`fake_device_mesh` backs a planned (abstract) mesh with a `torch.distributed`
``DeviceMesh`` over a fake process group: ``mesh.size`` ranks, this process
rank 0, collectives that move nothing.  Inside it the dry-run lays its meta
arguments out as DTensors and the shard function places activations, so
what one device holds and sends is read off DTensor's redistributions.
The fake group is ``torch._C._distributed_c10d.FakeProcessGroup``, private
API of PyTorch, registered as the ``"fake"`` backend where nothing has yet.
The mesh is a CPU ``DeviceMesh``, on which DTensor would move a tensor from
one sharded dim to another by an all-gather and a cut (gloo has no
all-to-all); inside `fake_device_mesh` it issues the one all-to-all it
issues on a GPU mesh (`_shard_dim_alltoall`, patched into DTensor's private
``placement_types``).

Functions, not module-level constants, so importing this module touches no
device state.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Sequence, Tuple, Union

from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.tensor.placement_types as placement_types

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
        # the `DeviceMesh` backing a planned mesh inside `fake_device_mesh`
        self.device_mesh = None

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


def _create_fake_group(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup

    return FakeProcessGroup._create_internal(common_opts.group_rank,
                                             common_opts.group_size, backend_opts)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(gather_dim) -> Shard(shard_dim) transform over one
    mesh dim as the one all-to-all of the local block that DTensor issues
    on a GPU mesh: this device's block cut into one chunk per peer along
    ``shard_dim``, exchanged (``all_to_all_single``), and the chunks it
    receives joined along ``gather_dim``.  DTensor has padded ``shard_dim``
    to a multiple of the peers."""
    from torch.distributed import _functional_collectives as funcol

    n = mesh.size(mesh_dim)
    out = funcol.all_to_all_single(torch.stack(input.chunk(n, dim=shard_dim)), None, None,
                                   (mesh, mesh_dim))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return torch.cat(out.unbind(0), dim=gather_dim)


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Back the planned ``mesh`` with a ``DeviceMesh`` (``mesh.device_mesh``)
    over a fake default process group of ``mesh.size`` ranks, rank 0, for
    the ``with`` block; on exit the group is destroyed and the mesh is
    unbacked again.  A transform between two sharded dims is an all-to-all
    inside the block, as on a GPU mesh.  Raises where a default group exists
    already or the group cannot be built: nothing falls back to an unbacked
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if not mesh.abstract:
        raise ValueError(f"{mesh!r} holds real devices: only a planned mesh is backed "
                         "by a fake process group")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the fake group "
                           "of a planned mesh would replace it")
    if "FAKE" not in dist.Backend._plugins:
        dist.Backend.register_backend("fake", _create_fake_group, extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=mesh.size)
    try:
        mesh.device_mesh = init_device_mesh("cpu", mesh.devices.shape,
                                            mesh_dim_names=mesh.axis_names)
        with mock.patch.object(placement_types, "shard_dim_alltoall", _shard_dim_alltoall):
            yield mesh
    finally:
        mesh.device_mesh = None
        dist.destroy_process_group()


def planned_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose devices no process owns."""
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
        return planned_mesh((2, 16, 16), ("pod", "data", "model"))
    return planned_mesh((16, 16), ("data", "model"))


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

