"""The model code over DTensors: what the steps do when their arguments
are laid out on a mesh — real ranks of a process group
(`launch.mesh.world_mesh`, gloo or NCCL) or the dry-run's planned mesh on a
fake group (`launch/dryrun.py`).

Most ops run on DTensors as they are, and DTensor's sharding propagation
decides what each device computes and which collectives it issues.  A few
blocks are run on each device's local tensors instead (`local_block`, over
``torch.distributed.tensor.experimental.local_map``), with the placements an
SPMD partitioner gives them: blocks whose ops DTensor cannot shard on meta
tensors, or whose plain factories (``torch.zeros(shape)``) would build
replicated tensors of the global shape.  Where operands could meet in more
than one way (a linear, an einsum, a weight beside an activation) the
sharding plan decides (`launch/sharding.py`, "Placements of the model's
per-device blocks"); `docs/port.md` lists the blocks.

On plain tensors every helper here is the identity (or calls its function
directly), so the steps run unchanged on one device.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def batch_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t`` [B, ...] (a plain tensor built in the step, the same on every
    device) laid out like the batch axis of ``x``: sharded over the mesh
    dims that shard ``x``'s dim 0 — each device keeps the rows of its
    block — and replicated over the others.  ``t`` itself where ``x`` is
    plain."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    placements = batch_split(x)
    dims = [i for i, p in enumerate(placements) if p.is_shard()]
    rows = t.shape[0] // math.prod(mesh.size(i) for i in dims)
    first = shard_index(mesh, dims) * rows
    local = t[first:first + rows].contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def replicate(x):
    """A DTensor ``x`` gathered (or all-reduced) to a full copy on every
    device; ``x`` itself where plain."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def replicated_context():
    """The context a step on DTensors runs in: a plain tensor that meets a
    DTensor (a constant, a position table built in the step) is read as
    replicated over the mesh (``implicit_replication``).  The dry-run and
    the steps on a real mesh enter it; on plain tensors it changes
    nothing."""
    return implicit_replication()


def local_block(fn: Callable, args: Sequence, in_placements: Sequence[Optional[tuple]],
                out_placements):
    """``fn(*args)`` run on each device's local tensors: every DTensor
    argument redistributed to its entry of ``in_placements`` (None for a
    plain argument), the outputs wrapped as ``out_placements`` (one
    placement tuple, or a tuple of them for a tuple of outputs).  A mesh dim
    that shards any argument splits the block's work; an argument
    replicated over such a dim gets its gradient as a `Partial` sum there.
    Where no argument is a DTensor, ``fn(*args)``."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    split_dims = {i for pl in in_placements if pl is not None
                  for i, p in enumerate(pl) if p.is_shard()}
    grad_placements = tuple(
        None if pl is None else tuple(
            Partial() if (i in split_dims and not p.is_shard()) else p
            for i, p in enumerate(pl))
        for pl in in_placements)

    if out_placements is not None:
        # local_map reads a tuple as one entry per output, a list as one output's
        out_placements = (list(out_placements) if isinstance(out_placements[0], Placement)
                          else tuple(list(o) for o in out_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements), in_grad_placements=grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def batch_split(x: DTensor) -> tuple:
    """``x``'s placements with only its batch (dim 0) sharding kept."""
    return tuple(Shard(0) if p == Shard(0) else Replicate() for p in x.placements)


def microbatch(v, n: int, i: int):
    """Rows ``i*B/n .. (i+1)*B/n`` of ``v`` [B, ...].  Of a DTensor, laid out
    as ``v``'s batch where the rows divide its axes (else replicated): the
    batch is gathered (the one collective), cut and sharded again."""
    rows = replicate_dim(v, 0).reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    if isinstance(v, DTensor):
        placements = batch_split(v)
        ways = math.prod(v.device_mesh.size(k) for k, p in enumerate(placements)
                         if p.is_shard())
        if rows.shape[0] % ways == 0:
            rows = rows.redistribute(v.device_mesh, placements)
    return rows


def _view_groups(src, dst):
    """The dims of a reshape from ``src`` to ``dst`` in groups ``(src dims,
    dst dims)`` of equal products, in order (size-1 dims join a group)."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [i] if i < len(src) else [], [j] if j < len(dst) else []
        a = src[i] if i < len(src) else 1
        b = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                gi.append(i)
                i += 1
            else:
                b *= dst[j]
                gj.append(j)
                j += 1
        groups.append((gi, gj))
    return groups


def _placements_for_view(x: DTensor, shape: tuple) -> list:
    """``x``'s placements, gathered over the mesh dims whose shard a reshape
    to ``shape`` cannot keep (see `reshape`)."""
    keep = list(x.placements)
    for gi, gj in _view_groups(tuple(x.shape), shape):
        major = next((d for d in gi if x.shape[d] > 1), gi[0] if gi else None)
        first = next((d for d in gj if shape[d] > 1), gj[0] if gj else None)
        for m, p in enumerate(keep):
            if not p.is_shard() or p.dim not in gi:
                continue
            n = math.prod(x.device_mesh.size(k) for k, q in enumerate(keep)
                          if q.is_shard() and q.dim == p.dim)
            if p.dim != major or first is None or shape[first] % n:
                keep[m] = Replicate()
    return keep


def _view(x: DTensor, shape: tuple) -> DTensor:
    keep = _placements_for_view(x, shape)
    if keep != list(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """`reshape` of a DTensor, whose backward reshapes the gradient back
    the same way (gathering what that view cannot keep sharded)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _view(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _view(grad, ctx.in_shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor sharded on a dim the reshape splits
    or merges where DTensor cannot keep the shard (a head axis split into
    groups that do not divide the mesh, an inner dim merged) is first
    gathered over those mesh dims, as an SPMD partitioner reshards there;
    so is its gradient on the way back."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(x.numel() // known if s == -1 else s for s in shape)
    return _Reshape.apply(x, tuple(shape))


def replicate_dim(x, dim: int):
    """A DTensor ``x`` gathered over the mesh dims that shard its ``dim``;
    ``x`` itself where nothing shards it, or where it is plain."""
    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p == Shard(dim) else p for p in x.placements])


def unbind(x) -> tuple:
    """``torch.unbind(x)`` along dim 0.  A DTensor is gathered along dim 0
    if that is sharded, and each device unbinds its block, where DTensor
    would gather it whole."""
    if not isinstance(x, DTensor):
        return torch.unbind(x)
    x = replicate_dim(x, 0)
    out = [Shard(p.dim - 1) if p.is_shard() else p for p in x.placements]
    return local_block(torch.unbind, (x,), (x.placements,), tuple(out for _ in range(x.shape[0])))


def stack(xs) -> torch.Tensor:
    """``torch.stack(xs)`` along a new dim 0.  DTensors placed alike are
    stacked per device, where DTensor would gather them whole."""
    if not isinstance(xs[0], DTensor):
        return torch.stack(xs)
    pl = xs[0].placements
    return local_block(lambda *t: torch.stack(t), tuple(xs), (pl,) * len(xs),
                       tuple(Shard(p.dim + 1) if p.is_shard() else p for p in pl))


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` (a plain tensor) reduced by ``op`` over ``group``, a ``(mesh,
    mesh dim)`` pair."""
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(t, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


def to_local(x) -> torch.Tensor:
    """This device's block of a DTensor ``x``; ``x`` itself where plain."""
    return x.to_local() if isinstance(x, DTensor) else x


def like(x, block: torch.Tensor):
    """``block`` as a DTensor laid out as ``x`` (of ``x``'s global shape);
    ``block`` itself where ``x`` is plain."""
    if not isinstance(x, DTensor):
        return block
    return DTensor.from_local(block, x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_dims(x) -> tuple:
    """The mesh dims that shard a DTensor ``x`` (none for a plain tensor)."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard())


def sum_over(t: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """A plain ``t`` summed over the mesh dims ``dims`` (``t`` where none)."""
    for d in dims:
        t = all_reduce(t, "sum", (mesh, d))
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``t`` over the mesh dims ``groups``.  Its gradient is the
    incoming one, the same on every device of the groups: each device's
    ``t`` adds to the sum once."""

    @staticmethod
    def forward(ctx, t, groups):
        for g in groups:
            t = all_reduce(t, "sum", g)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def shard_index(mesh, dims: Sequence[int]) -> int:
    """This device's block of a tensor dim split over the mesh dims
    ``dims`` (outer first), as DTensor numbers the blocks."""
    coord = mesh.get_coordinate()
    index = 0
    for d in dims:
        index = index * mesh.size(d) + coord[d]
    return index


class VocabShards:
    """One device's view of a vocabulary split over the mesh dims ``dims``
    (outer first) of ``mesh``, ``local`` columns to a device: what a
    log-normaliser and a target's logit over the whole vocabulary take from
    this device's logits."""

    def __init__(self, mesh, dims: Sequence[int], local: int):
        self.groups = [(mesh, d) for d in dims]
        self.local = local
        self.offset = shard_index(mesh, dims) * local

    def logz_gold(self, logits: torch.Tensor, tgt: torch.Tensor):
        """(logsumexp over the whole vocabulary, the logit at ``tgt``) from
        this device's ``logits`` [..., local]: the max, the sum of
        exponentials and the target's logit (zero off its shard) each
        all-reduced over the shards."""
        m = logits.amax(dim=-1).detach()
        for g in self.groups:
            m = all_reduce(m, "max", g)
        total = _AllReduceSum.apply(torch.exp(logits - m[..., None]).sum(dim=-1), self.groups)
        t = tgt - self.offset
        here = (t >= 0) & (t < self.local)
        gold = torch.gather(logits, -1, torch.clamp(t, 0, self.local - 1)[..., None])[..., 0]
        gold = _AllReduceSum.apply(torch.where(here, gold, 0.0), self.groups)
        return m + torch.log(total), gold
