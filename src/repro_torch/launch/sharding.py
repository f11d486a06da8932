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
dry-run's bytes per device.  The shard function of `make_shard_fn` is the
identity on one device or a planned mesh, and raises on a mesh of several
real devices: tensor-parallel execution of the LM is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten

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
        ``shard``.  On one device or a planned mesh a constraint changes no
        value, so it returns ``x`` — as the reference's does wherever its
        guard skips a dim that does not divide.  On a mesh of several real
        devices it raises: tensor-parallel execution is not ported, and the
        steps never compute unsharded where a plan asks for shards."""
        mesh = self.mesh
        if not mesh.abstract and mesh.size > 1:
            raise NotImplementedError(
                f"{mesh!r} has {mesh.size} devices: tensor-parallel execution of "
                "the LM across devices is not ported; run on one device "
                "(--device cuda:0, or CUDA_VISIBLE_DEVICES with one card)"
            )

        def shard(x, *names):
            return x

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
