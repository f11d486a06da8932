"""Device meshes.  Counterpart of `repro.launch.mesh`.

A `Mesh` names its axes and holds its devices in a numpy object array, so
``mesh.devices.shape`` reads as the reference's.  The port has no SPMD
partitioner: a mesh is what the sharding plan (`launch/sharding.py`) lays
DTensors out on, and what the dry-run (`launch/dryrun.py`) reasons about.

`world_mesh` backs a mesh with a ``DeviceMesh`` over the ranks of the
default process group (gloo on the CPU, NCCL on cards, one card per rank):
real DTensors on real devices, the counterpart of a ``jax.make_mesh`` over
the local devices.  `run_ranks` starts the ranks — or, in a process that
already sits in a group (under ``torchrun``, or inside a rank), runs the
function there.

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
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

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
        # the `DeviceMesh` backing the mesh: a planned one's inside
        # `fake_device_mesh`, a real one's from `world_mesh`
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


# ---------------------------------------------------------------------------
# Real meshes over a process group
# ---------------------------------------------------------------------------

def world_mesh(shape: Optional[Tuple[int, ...]] = None,
               axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The default process group's ranks as a real mesh of ``shape``
    (default ``(world, 1)``, `make_local_mesh`'s layout) over ``axes``,
    backed by ``init_device_mesh``: a ``"cuda"`` mesh under NCCL (each rank
    on its current card), a ``"cpu"`` one otherwise.  Raises where no group
    exists or the shape does not hold the world."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no default process group: start the ranks with `run_ranks` "
                           "(or torchrun) before building a world mesh")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world, 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {shape} mesh over {world} ranks")
    cuda = dist.get_backend() == "nccl"
    devices = np.empty(world, dtype=object)
    devices[:] = [torch.device("cuda", torch.cuda.current_device()) if cuda
                  else torch.device("cpu")] * world
    mesh = Mesh(devices.reshape(shape), axes)
    mesh.device_mesh = init_device_mesh("cuda" if cuda else "cpu", shape,
                                        mesh_dim_names=tuple(axes))
    return mesh


def launcher_ranks(device: torch.device) -> int:
    """The ranks an LM launcher runs on ``device``: every visible card for
    ``cuda`` without an index (`make_local_mesh`'s ``n``), else 1."""
    if device.type == "cuda" and device.index is None:
        return max(torch.cuda.device_count(), 1)
    return 1


def local_device(device: torch.device) -> torch.device:
    """The device of this rank: its current card under NCCL, else
    ``device``."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def rank() -> int:
    """This process's rank in the default group (0 outside any group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def in_group(device_type: str) -> bool:
    """True in a process that sits in a process group — a rank of
    `run_ranks`, or one that joins here the group a launcher such as
    ``torchrun`` describes in the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``PORT``; NCCL for ``"cuda"``, gloo otherwise)."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return True


def _rank_main(r: int, n: int, device_type: str, init_method: str, fn, args, kwargs,
               out) -> None:
    """One spawned rank: join the group, run ``fn(*args, **kwargs)``, hand
    back its result (or the traceback), destroy the group."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(r)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=init_method, rank=r, world_size=n)
        try:
            result = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        out.put((r, True, result))
    except BaseException:  # every failure goes back to the parent
        out.put((r, False, traceback.format_exc()))


def run_ranks(fn: Callable, n: int, device_type: str = "cpu", *, args: Sequence = (),
              kwargs: Optional[dict] = None, timeout: float = 3600.0) -> List[Any]:
    """``fn(*args, **kwargs)`` on each of ``n`` ranks of a process group — gloo on
    ``"cpu"``, NCCL on ``"cuda"`` with rank ``r`` on card ``r`` — and the
    list of their results, rank by rank.  The ranks are spawned processes
    that meet through a file in a fresh temporary directory (no TCP port),
    and each destroys the group on exit.
    A rank that raises fails the whole run: the error names it, with its
    traceback.  ``fn``, its arguments and the results cross processes by pickle
    (hand tensors back as numpy).

    A process that already sits in a group (a rank, or a process started
    by ``torchrun``) is not spawned again: ``fn`` runs there, and the list
    holds its one result."""
    kwargs = dict(kwargs or {})
    if in_group(device_type):
        return [fn(*args, **kwargs)]
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on cuda: {torch.cuda.device_count()} cards visible")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, device_type, init_method, fn, tuple(args), kwargs,
                                   out))
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n and not errors:
                try:
                    r, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in results]
                    if dead:
                        errors.append(f"rank {dead[0]} of {n} died (exit code "
                                      f"{procs[dead[0]].exitcode}) without a result")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result from every rank within {timeout} s")
                    continue
                if ok:
                    results[r] = value
                    continue
                errors.append(f"rank {r} of {n} failed:\n{value}")
                # the first failure may be a peer's broken connection: the
                # others' tracebacks, for a few seconds, name the cause
                while len(results) + len(errors) < n:
                    try:
                        r, ok, value = out.get(timeout=10.0)
                    except queue.Empty:
                        break
                    if not ok:
                        errors.append(f"rank {r} of {n} failed:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=5 if errors else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]
