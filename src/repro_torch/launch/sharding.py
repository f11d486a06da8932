"""Sharding rules: logical axes -> mesh axes, and path-based parameter specs.
Counterpart of `repro.launch.sharding`: the same plan, rule for rule.

Parallelism plan (Megatron-style TP x DP, EP for MoE, sequence-sharded KV
caches for decode):

  batch      -> ("pod", "data")     data parallel (pod axis is outer-DP)
  heads/mlp/vocab/expert -> "model" tensor/expert parallel
  cache seq  -> "model"             flash-decode over the model axis
  (long_500k, batch=1: cache seq -> ("pod","data","model") — all 512 ways)

Column-parallel linears: wq, w_uq/w_uk/w_uv, w_gate/w_up, shared_*, lm_head,
w_z/w_x/w_dt.  Row-parallel: wo, w_down, out_proj, shared_down.  Replicated:
wk/wv (GQA KV heads < model-axis size for every assigned arch), w_dq/w_dkv
(MLA latents), router, B/C projections, norms.

``ternary_packed`` params shard exactly like their dense counterparts
("packed" ~ w, "scale" ~ b).

The port has no SPMD partitioner.  A spec is a `P` (the reference's
``PartitionSpec``) and a leaf's placement a `Sharding` (its
``NamedSharding``), which says what one device of the mesh holds: the
dry-run's bytes per device, and the DTensor placements of the leaf.  On a
planned mesh backed by a fake process group (`launch.mesh.fake_device_mesh`)
`distribute_meta` lays a tree of meta tensors out as DTensors, and the
shard function of `make_shard_fn` redistributes an activation to its
logical axes' spec: the counterpart of ``with_sharding_constraint``.  It is
the identity on one real device or an unbacked planned mesh, and raises on
a mesh of several real devices: tensor-parallel execution of the LM is not
ported.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten

if TYPE_CHECKING:  # the model imports the plan's placements: no import back
    from repro_torch.models.config import ModelConfig, ShapeConfig

# projection name -> parallelism kind
_COL = {"wq", "w_uq", "w_uk", "w_uv", "w_gate", "w_up", "shared_gate",
        "shared_up", "lm_head", "w_z", "w_x", "w_dt"}
_ROW = {"wo", "w_down", "out_proj", "shared_down"}
_REP = {"wk", "wv", "w_dq", "w_dkv", "router", "w_B", "w_C"}


class P(tuple):
    """A partition spec: one entry per leading dim of a leaf — ``None``
    (replicated), a mesh axis name, or a tuple of them.  Trailing dims
    not named are replicated.  As the reference's, a one-axis tuple reads
    as that axis and an empty one as ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axis_product(sizes: Dict[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return sizes[entry]
    n = 1
    for a in entry:
        n *= sizes[a]
    return n


class Sharding:
    """A leaf laid over ``mesh`` by ``spec`` (the reference's
    ``NamedSharding``): what one device holds of it."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's block (a dim that does not divide is
        rounded up, as a padded placement would be)."""
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        out = list(shape)
        for i, e in enumerate(self.spec):
            n = _axis_product(sizes, e)
            out[i] = -(-out[i] // n)
        return tuple(out)

    def placements(self) -> tuple:
        """The spec as DTensor placements, one per mesh axis: ``Shard(d)``
        where an entry of tensor dim ``d`` names the axis (a tuple entry
        shards that dim over each of its axes, outer first), else
        ``Replicate()`` (so is an axis of size 1)."""
        out = [Replicate()] * len(self.mesh.axis_names)
        for d, e in enumerate(self.spec):
            for axis in (() if e is None else (e,) if isinstance(e, str) else e):
                i = self.mesh.axis_names.index(axis)
                if self.mesh.devices.shape[i] > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def bytes_per_device(self, leaf) -> int:
        """One device's bytes of ``leaf`` (a tensor, meta or real)."""
        n = 1
        for d in self.shard_shape(leaf.shape):
            n *= d
        return n * leaf.element_size()

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.spec!r})"


class ShardingRules:
    """Resolves logical axis names and parameter paths to partition specs
    for a given mesh.  ``logical`` maps a logical axis to mesh axis (or
    tuple)."""

    def __init__(self, mesh, *, batch_axes=None, cache_seq_axes=("model",),
                 fsdp: bool = True, moe_ep: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        # moe_ep: weight-stationary expert parallelism for serving — expert
        # banks shard over (data x model) and stay resident; activations
        # (tiny at decode) move instead of re-gathering the expert weights
        # every token
        self.moe_ep = moe_ep
        names = mesh.axis_names
        dp = tuple(a for a in ("pod", "data") if a in names)
        self.batch_axes = batch_axes if batch_axes is not None else dp
        self.logical: Dict[str, Any] = {
            "batch": self.batch_axes if self.batch_axes else None,
            "seq": None,
            # Megatron-style sequence parallelism on the residual stream;
            # the shard-fn divisibility guard disables it for decode (S=1)
            # and smoke shapes
            "res_seq": "model",
            "embed": None,
            "heads": "model",
            "kv_heads": None,
            "mlp": "model",
            "vocab": "model",
            "expert": "model",
            "cache_seq": cache_seq_axes,
            # MoE activation layout: tokens grouped by batch (data-sharded)
            # by default; moe_ep serving flips to experts-on-data with
            # replicated (tiny) decode tokens so expert weights stay resident
            "moe_tokens": (self.batch_axes if not moe_ep else None),
            "moe_experts": (None if not moe_ep else "data"),
        }

    # ---- activations -------------------------------------------------------
    def spec(self, *names: Optional[str]) -> P:
        return P(*[self.logical.get(n) if n else None for n in names])

    def _axes_size(self, logical_name) -> int:
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return _axis_product(sizes, self.logical.get(logical_name))

    def make_shard_fn(self):
        """The activation-constraint function the model steps take as
        ``shard``: ``shard(x, *logical_names)``.  As the reference's, it
        skips the constraint (returns ``x``) when any named dim does not
        divide its axes' size.  On a planned mesh backed by a fake process
        group it redistributes a DTensor ``x`` to ``spec(*names)``.  On one
        real device or an unbacked planned mesh a constraint changes no
        value, and it returns ``x``.  On a mesh of several real devices it
        raises: tensor-parallel execution is not ported, and the steps never
        compute unsharded where a plan asks for shards."""
        mesh = self.mesh
        if not mesh.abstract and mesh.size > 1:
            raise NotImplementedError(
                f"{mesh!r} has {mesh.size} devices: tensor-parallel execution of "
                "the LM across devices is not ported; run on one device "
                "(--device cuda:0, or CUDA_VISIBLE_DEVICES with one card)"
            )
        rules = self

        def shard(x, *names):
            if mesh.device_mesh is None or not isinstance(x, DTensor):
                return x
            for dim, nm in enumerate(names):
                if nm is None:
                    continue
                size = rules._axes_size(nm)
                if size > 1 and x.shape[dim] % size != 0:
                    return x
            placements = Sharding(mesh, rules.spec(*names)).placements()
            return x.redistribute(mesh.device_mesh, placements)

        return shard

    # ---- parameters --------------------------------------------------------
    def param_spec(self, path: Tuple[str, ...], leaf) -> P:
        """Sharding for one parameter leaf, identified by its tree path."""
        parts = [p for p in path]
        name = parts[-1]                      # w | b | packed | scale | table | g ...
        proj = parts[-2] if len(parts) >= 2 else ""
        scanned = any(p.startswith("seg") for p in parts)

        def wrap(spec_tail: Tuple) -> P:
            lead = (None,) if scanned else ()
            return P(*lead, *spec_tail)

        # embeddings
        if proj == "embed" and name == "table":
            return P(self.logical["vocab"], None)
        # MoE expert banks: tensor-parallel experts — moe_d_ff shards over
        # "model", experts/d_model pick up FSDP via _fixup.  moe_ep
        # (serving): experts additionally shard over "data" and stay
        # resident.
        if name in ("w_up", "w_gate") and proj == "moe":     # [E, D, F]
            return wrap(("data" if self.moe_ep else None, None, "model"))
        if name == "w_down" and proj == "moe":               # [E, F, D]
            return wrap(("data" if self.moe_ep else None, "model", None))
        # mamba per-head vectors
        if name in ("A_log", "D", "dt_bias") or (name == "norm_g" and proj == "mamba"):
            return wrap(("model",))
        if name in ("conv_x_w",):
            return wrap((None, "model"))
        if name in ("conv_x_b",):
            return wrap(("model",))
        if name in ("conv_B_w", "conv_C_w"):
            return wrap((None, None))
        if name in ("conv_B_b", "conv_C_b"):
            return wrap((None,))
        # linears
        kind = None
        if proj in _COL:
            kind = "col"
        elif proj in _ROW:
            kind = "row"
        elif proj in _REP:
            kind = "rep"
        if kind is None and name in ("w", "b", "packed", "scale"):
            kind = "rep"
        if kind == "col":
            if name in ("w", "packed"):
                return wrap((None, "model"))
            if name in ("b", "scale"):
                return wrap(("model",))
        if kind == "row":
            if name in ("w", "packed"):
                return wrap(("model", None))
            if name in ("b", "scale"):
                return wrap((None,))
        # replicated linears, norms and everything else
        return wrap(tuple(None for _ in range(leaf.ndim - (1 if scanned else 0))))

    def _fixup(self, spec: P, leaf, fsdp: bool = True) -> P:
        """(1) Drop sharded dims that don't divide (an uneven argument
        placement — e.g. vocab 50280 on a 16-way axis).  (2) FSDP/ZeRO:
        shard the largest remaining replicated dim over the DP axes so
        params + optimizer state scale with the FULL device count."""
        shape = getattr(leaf, "shape", ())
        entries = list(spec) + [None] * (len(shape) - len(spec))
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        entries = [
            e if (e is None or shape[i] % _axis_product(sizes, e) == 0) else None
            for i, e in enumerate(entries)
        ]
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        if dp and fsdp:
            dp_n = _axis_product(sizes, dp)
            # pick the largest unsharded, divisible dim for FSDP
            cands = [
                (shape[i], i) for i, e in enumerate(entries)
                if e is None and shape[i] % dp_n == 0 and shape[i] >= dp_n
            ]
            if cands:
                _, i = max(cands)
                entries[i] = dp if len(dp) > 1 else dp[0]
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    def param_pspecs(self, params_tree, *, fsdp: Optional[bool] = None):
        fsdp = self.fsdp if fsdp is None else fsdp

        def f(path, leaf):
            keys = tuple(_key_name(k) for k in path)
            spec = self.param_spec(keys, leaf)
            return self._fixup(spec, leaf, fsdp=fsdp)

        return tree_map_with_path(f, params_tree)

    def param_shardings(self, params_tree):
        return self._shardings(params_tree, self.param_pspecs(params_tree))

    # ---- caches -------------------------------------------------------------
    def cache_pspecs(self, cache_tree, cfg: ModelConfig):
        ba = self.logical["batch"]
        cs = self.logical["cache_seq"]

        def f(path, leaf):
            keys = [str(_key_name(k)) for k in path]
            name = keys[-1]
            if name == "len":
                return P()
            if name == "enc_out":
                return P(ba, None, None)
            # all per-layer caches are stacked: leading [n_steps] axis
            if name in ("k", "v"):          # [L, B, S, KV, hd]
                return P(None, ba, cs, None, None)
            if name in ("ckv", "krope"):    # [L, B, S, r]
                return P(None, ba, cs, None)
            if name == "h":                  # [L, B, H, P, N]
                return P(None, ba, "model", None, None)
            if name == "conv_x":             # [L, B, K-1, di]
                return P(None, ba, None, "model")
            if name in ("conv_B", "conv_C"):
                return P(None, ba, None, None)
            return P(*[None] * leaf.ndim)

        return tree_map_with_path(
            lambda p, l: self._fixup(f(p, l), l, fsdp=False), cache_tree
        )

    def cache_shardings(self, cache_tree, cfg: ModelConfig):
        return self._shardings(cache_tree, self.cache_pspecs(cache_tree, cfg))

    def _shardings(self, tree, specs):
        """A `Sharding` per leaf of ``tree`` from its spec tree."""
        return tree_unflatten(tree, [Sharding(self.mesh, s) for s in spec_leaves(specs)])


# ---------------------------------------------------------------------------
# Placements of the model's per-device blocks
# ---------------------------------------------------------------------------
# Where the model runs a block on each device's local tensors
# (`models/spmd.local_block`), the plan decides how its operands meet: the
# choices an SPMD partitioner makes for the reference.

def weights_beside(x_placements: tuple, w: DTensor, dim: int) -> tuple:
    """The placements of a weight used beside an activation placed as
    ``x_placements``: its tensor-parallel shard of ``dim`` kept over the
    mesh dims that do not split the activation; replicated (all-gathered,
    as FSDP gathers a weight) everywhere else."""
    return tuple(wp if (wp == Shard(dim) and not xp.is_shard()) else Replicate()
                 for xp, wp in zip(x_placements, w.placements))


# Where an activation sharded along a dim it does not contract (a sequence)
# meets a tensor-parallel weight, one of them crosses that mesh dim: the
# activation is gathered (Megatron's sequence parallelism, which spares the
# reshard of the output that the next constraint would force) unless its
# block is more than this many times the weight's block there (the weight
# after its FSDP gathers): a decode's sharded cache against a small
# projection, a long sequence against a small weight.  At 1 the smaller
# block moves.  `scripts/dryrun_torch_vs_reference.py --sweep-gather` holds
# values from 0 up against the reference's SMOKE cells on (1, 4) and (2, 4)
# meshes (its reading is in `PERF.md`).
GATHER_ACTIVATION_UP_TO = 1


def matmul_placements(x: DTensor, w: DTensor, w_in: int, w_out: int):
    """Placements ``(x, w, out)`` of ``x @ w`` run per device, with ``w``'s
    contracted dim ``w_in`` and output dim ``w_out``, per mesh dim as an
    SPMD partitioner lays out Megatron's linears: where ``x`` is sharded on
    its batch ``x`` keeps it and ``w`` is gathered (FSDP); else a
    column-parallel ``w`` (sharded on ``w_out``) meets a replicated ``x``
    and gives an output sharded on its last dim, and a row-parallel ``w``
    (sharded on ``w_in``) meets ``x`` sharded on its last dim and gives a
    partial sum (an ``x`` sharded along a sequence is gathered for them, see
    `GATHER_ACTIVATION_UP_TO`); ``x`` sharded on another dim it does not
    contract keeps it beside a gathered ``w``; anything else is
    replicated."""
    last = x.ndim - 1
    fsdp = math.prod(x.device_mesh.size(i) for i, (p, q) in
                     enumerate(zip(x.placements, w.placements)) if p == Shard(0) and q.is_shard())
    keep_x = x._local_tensor.nbytes > GATHER_ACTIVATION_UP_TO * fsdp * w._local_tensor.nbytes
    xp, wp, op = [], [], []
    for p, q in zip(x.placements, w.placements):
        outer = p.is_shard() and p.dim != last
        if p == Shard(0) or (outer and (keep_x or not q.is_shard())):
            xp.append(p), wp.append(Replicate()), op.append(p)
        elif q == Shard(w_out):
            xp.append(Replicate()), wp.append(q), op.append(Shard(last))
        elif q == Shard(w_in):
            xp.append(Shard(last)), wp.append(q), op.append(Partial())
        else:
            xp.append(Replicate()), wp.append(Replicate()), op.append(Replicate())
    return tuple(xp), tuple(wp), tuple(op)


def vector_beside(wp: tuple, w_out: int) -> tuple:
    """The placements of a per-output vector (a bias, a scale) of a weight
    placed as ``wp``: sharded where the weight's output dim is."""
    return tuple(Shard(0) if p == Shard(w_out) else Replicate() for p in wp)


def einsum_placements(eq: str, a: DTensor, b: DTensor):
    """Placements ``(a, b, out)`` of a two-operand einsum ``eq`` run per
    device.  Per mesh dim one index letter is split: the one the larger
    operand shards there (a cache stays put, the small query moves), else
    the other's.  An operand that holds the letter is sharded on it (from
    replicated, a local cut), one that does not is replicated; the output
    is sharded on the letter, or a partial sum where it is contracted."""
    ins, out = eq.replace(" ", "").split("->")
    ea, eb = ins.split(",")
    big, small = (a, ea), (b, eb)
    if math.prod(b._local_tensor.shape) > math.prod(a._local_tensor.shape):
        big, small = small, big
    ap, bp, op = [], [], []
    for i in range(a.device_mesh.ndim):
        letter = None
        for x, e in (big, small):
            p = x.placements[i]
            if p.is_shard() and letter is None:
                letter = e[p.dim]
        for e, acc in ((ea, ap), (eb, bp)):
            acc.append(Shard(e.index(letter)) if letter and letter in e else Replicate())
        op.append(Replicate() if letter is None else
                  Shard(out.index(letter)) if letter in out else Partial())
    return tuple(ap), tuple(bp), tuple(op)


def distribute_meta(tree, shardings):
    """``tree`` (meta tensors at their global shapes) as meta DTensors on
    the backed mesh of ``shardings`` (a `Sharding` per leaf): each leaf's
    local tensor is one device's block."""
    def one(x, s):
        local = torch.empty(s.shard_shape(x.shape), dtype=x.dtype, device="meta")
        return DTensor.from_local(local, s.mesh.device_mesh, s.placements(),
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_unflatten(tree, [one(x, s) for x, s in
                                 zip(tree_leaves(tree), tree_leaves(shardings))])


def spec_leaves(specs):
    """The `P` leaves of a spec tree in leaf order (a `P` is a tuple,
    which the plain walk would descend into)."""
    return tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))


def _key_name(k) -> str:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return f"i{k.idx}"
    return str(k)


def rules_for_cell(mesh, cfg: ModelConfig, shape: ShapeConfig,
                   **opts) -> ShardingRules:
    """Pick batch/cache-seq axes for a given (arch x shape) cell.

    If the global batch doesn't divide the DP axes (long_500k has batch=1),
    batch replicates and the cache sequence takes every mesh axis instead.
    ``opts`` forward sharding variants (fsdp=, moe_ep=).
    """
    names = mesh.axis_names
    sizes = dict(zip(names, mesh.devices.shape))
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = _axis_product(sizes, dp)
    if shape.global_batch % dp_size == 0:
        return ShardingRules(mesh, batch_axes=dp, cache_seq_axes="model", **opts)
    # batch too small: shard sequence over everything
    return ShardingRules(mesh, batch_axes=(), cache_seq_axes=tuple(names), **opts)
