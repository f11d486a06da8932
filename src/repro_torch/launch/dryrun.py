"""Dry-run of every (arch x shape x mesh) cell on meta DTensors: what one
device of a production mesh computes, holds and sends.  Counterpart of
`repro.launch.dryrun`.

The reference lowers and compiles each cell under GSPMD on 512 forced host
devices.  The port backs the planned mesh with a fake process group
(`launch.mesh.fake_device_mesh`: ``mesh.size`` ranks, this process rank 0,
collectives that move nothing), lays the cell's meta arguments out as
DTensors by the sharding plan (`launch.sharding.distribute_meta`), runs the
step once with the plan's activation constraints, and reads, under one
`DeviceBook` dispatch mode that sees every op on each device's local
tensors:

    flops          one device's FLOPs, from the local shapes through
                   `torch.utils.flop_counter`'s formulas: replicated work
                   counts on every device, as the reference's
                   ``cost_analysis``; ``flops_global`` beside it is
                   `FlopCounterMode`'s count at the global shapes
    bytes_accessed each op's local input and output bytes, summed
                   (``bytes_accessed_kind: "unfused"``: XLA's figure is
                   after fusion)
    argument_bytes one device's bytes of every argument leaf under the
                   plan — exact
    alias_bytes    the bytes of the argument the reference donates (the
                   train state; the decode cache)
    output_bytes   one device's bytes of the step's outputs
    temp_bytes     the peak of local bytes allocated and alive while the
                   step runs (``temp_bytes_kind: "per_device"``), each
                   allocation counted as the most the CUDA caching
                   allocator books for it (`booked_bytes`)
    collectives    the reference's schema (``bytes_by_kind``, ``counts``,
                   ``total_bytes``): each collective DTensor issues, by its
                   result bytes on one device
    fits           argument_bytes + temp_bytes <= the card's own memory
                   (``device``); null with ``--device cpu``

The collectives are DTensor's redistributions, not an SPMD partitioner's
choice: the shard function (`ShardingRules.make_shard_fn`) places the
activations where the reference constrains them, and DTensor's sharding
propagation moves the rest.  ``probe`` extrapolates FLOPs, bytes and
collective bytes from two reduced-depth configs as the reference does
(`probe_configs`), so `benchmarks/roofline.py` finds its fields.

Artifacts land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__quant][__variant].json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import json
import multiprocessing
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCH_IDS, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.launch.sharding import P, Sharding, distribute_meta, rules_for_cell
from repro_torch.launch.steps import (
    input_specs,
    prefill_cache_len,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    train_state_specs,
)
from repro_torch.models.config import SHAPES
from repro_torch.models.model import cache_spec, init_cache, init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# the CUDA caching allocator hands out blocks in multiples of 512 bytes, and
# leaves a block of the large pool unsplit when less than 1 MiB would remain
ALLOC_GRANULE = 512
ALLOC_UNSPLIT = 1 << 20

TEMP_BYTES_KIND = "per_device"
BYTES_ACCESSED_KIND = "unfused"

# the reference's collective kinds, and the functional collectives DTensor
# issues for four of them (``wait_tensor`` and ``_wrap_tensor_autograd``
# move nothing; a transform between two sharded dims is an
# ``all_to_all_single``, see `launch.mesh.fake_device_mesh`)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {"_c10d_functional.all_reduce": "all-reduce",
                   "_c10d_functional.all_gather_into_tensor": "all-gather",
                   "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
                   "_c10d_functional.all_to_all_single": "all-to-all",
                   "_c10d_functional.wait_tensor": None,
                   "_c10d_functional._wrap_tensor_autograd": None}


def accum_for(cfg, shape) -> int:
    """Gradient-accumulation microbatching for the big trains: global batch
    stays 256, activations scale with the microbatch."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 6144 and cfg.is_moe:
        return 8
    if cfg.ssm_state and cfg.d_model >= 4096:
        return 8
    if cfg.d_model >= 6144:
        return 4
    if cfg.ssm_state or cfg.d_model >= 5120:
        return 2
    return 1


def build_cell(cfg, shape, mesh, *, force_accum: Optional[int] = None,
               sharding_opts: Optional[dict] = None):
    """Returns ``(step, args, shardings, donate_argnums, rules)``: the step,
    its meta arguments at the global shapes, a `Sharding` per argument leaf
    (the same tree as ``args``) and the argument the reference donates.  On
    a mesh backed by a fake process group the step's shard function places
    activations, and a prefill builds its cache laid out by the plan."""
    rules = rules_for_cell(mesh, cfg, shape, **(sharding_opts or {}))
    shard = rules.make_shard_fn()
    specs = input_specs(cfg, shape)
    ba = rules.logical["batch"]

    def batch_shardings(batch):
        return {k: Sharding(mesh, P(ba, None) if k in ("tokens", "targets")
                            else P(ba, None, None)) for k in batch}

    if shape.kind == "train":
        accum = force_accum if force_accum is not None else accum_for(cfg, shape)
        step = make_train_step(cfg, AdamWConfig(), shard=shard, accum_steps=accum,
                               donate=True)
        state = train_state_specs(cfg)
        args = (state, specs["batch"])
        shardings = (rules.param_shardings(state), batch_shardings(specs["batch"]))
        return step, args, shardings, (0,), rules  # donate state

    # params in bf16 for inference cells
    params = init_params(cfg, None, dtype=torch.bfloat16, device="meta")
    param_shardings = rules.param_shardings(params)
    if shape.kind == "prefill":
        # the in-step cache, laid out by the plan: its spec is built here,
        # outside the step, so only the blocks the step allocates are booked
        spec = cache_spec(cfg, shape.global_batch, prefill_cache_len(cfg, shape.seq_len),
                          torch.bfloat16)
        spec_shardings = rules.cache_shardings(spec, cfg)

        def cache_init(cfg, batch, max_len, dtype, device=None):
            if mesh.device_mesh is None:
                return init_cache(cfg, batch, max_len, dtype, device=device)
            return distribute_meta(spec, spec_shardings)

        step = make_prefill_step(cfg, shape.seq_len, shard=shard, cache_init=cache_init)
        args = (params, specs["batch"])
        return step, args, (param_shardings, batch_shardings(specs["batch"])), (), rules

    step = make_decode_step(cfg, shard=shard)
    args = (params, specs["tokens"], specs["cache"])
    shardings = (param_shardings, Sharding(mesh, P(ba, None)),
                 rules.cache_shardings(specs["cache"], cfg))
    return step, args, shardings, (2,), rules  # donate cache


def output_shardings(cfg, shape, rules, outputs, arg_shardings):
    """A `Sharding` per output leaf, as the reference's out_shardings: the
    new state as the old, metrics replicated; logits over (batch, vocab on
    "model" when it divides); a cache by the cache rules."""
    mesh = rules.mesh
    if shape.kind == "train":
        _, metrics = outputs
        return arg_shardings[0], {k: Sharding(mesh, P()) for k in metrics}
    model_size = dict(zip(mesh.axis_names, mesh.devices.shape))["model"]
    logits = Sharding(mesh, P(rules.logical["batch"],
                              "model" if cfg.vocab_size % model_size == 0 else None))
    return logits, rules.cache_shardings(outputs[1], cfg)


def tree_bytes(tree, shardings) -> int:
    """One device's bytes of every leaf of ``tree`` under ``shardings``."""
    return sum(s.bytes_per_device(x)
               for x, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def booked_bytes(nbytes: int) -> int:
    """The most the CUDA caching allocator books for a request of
    ``nbytes``: rounded up to ``ALLOC_GRANULE``, and above 1 MiB the rest of
    a block too small to split (under ``ALLOC_UNSPLIT``)."""
    if nbytes == 0:
        return 0
    booked = -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE
    return booked + ALLOC_UNSPLIT if nbytes > ALLOC_UNSPLIT else booked


def count_flops(step, args) -> int:
    """`FlopCounterMode`'s count of one call of ``step(*args)``."""
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return int(fc.get_total_flops())


class LiveBytes(TorchDispatchMode):
    """The peak of bytes allocated inside the mode and still alive.  Each
    op's non-aliasing outputs add their storage's `booked_bytes`; a
    `weakref.finalize` on the storage subtracts them when it is freed, so a
    view keeps its base's bytes alive."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        for r, o in zip(rets, out if len(rets) > 1 else (out,)):
            if r.alias_info is not None:
                continue
            for t in (o if isinstance(o, (list, tuple)) else (o,)):
                if not isinstance(t, torch.Tensor):
                    continue
                storage = t.untyped_storage()
                nbytes = booked_bytes(storage.nbytes())
                self.live += nbytes
                weakref.finalize(storage, self._free, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def peak_temp_bytes(step, args) -> int:
    """The most bytes ``step(*args)`` holds at once beyond its arguments
    (plain tensors: one device that holds the whole step)."""
    with LiveBytes() as live:
        step(*args)
    return live.peak


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class DeviceBook(LiveBytes):
    """`LiveBytes` over one device's local tensors, and beside it that
    device's FLOPs, unfused bytes accessed and collectives.  An op on
    DTensors is handed on (``NotImplemented``) to DTensor, which runs it as
    local ops and collectives that come back here.  An op of DTensor's
    sharding propagation, which builds fake tensors of the global shapes to
    learn an op's output shapes (the first time it meets the op), is run
    and not booked: no device runs it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.bytes_by_kind = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.calls = []  # (kind, result bytes) of each collective, in order

    def collectives(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_kind.values())}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
                or any(issubclass(t, FakeTensor) for t in types)):
            return func(*args, **(kwargs or {}))
        name = f"{func.namespace}.{func._opname}"
        if func.namespace.startswith("_c10d_functional") or name in _COLLECTIVE_OPS:
            if name not in _COLLECTIVE_OPS:
                raise NotImplementedError(f"collective {func} is none of {COLLECTIVES}")
            kind = _COLLECTIVE_OPS[name]
            if kind is None:
                # a wait, or a wrapper that hands its input back (on meta
                # tensors it returns a new one, which no device allocates)
                return func(*args, **(kwargs or {}))
            out = super().__torch_dispatch__(func, types, args, kwargs)
            nbytes = sum(t.nbytes for t in _tensors(out))
            self.bytes_by_kind[kind] += nbytes
            self.counts[kind] += 1
            self.calls.append((kind, nbytes))
            return out
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **(kwargs or {}), out_val=out))
        rets = func._schema.returns
        if not all(r.alias_info is not None and not r.alias_info.is_write for r in rets):
            self.bytes_accessed += sum(t.nbytes for t in _tensors(args))
            self.bytes_accessed += sum(t.nbytes for t in _tensors(out))
        return out


def analyze_cell(cfg, shape, mesh, *, sharding_opts: Optional[dict] = None,
                 force_accum: Optional[int] = None) -> dict:
    """FLOPs, bytes and collectives per device of one cell, run once on
    meta DTensors on the planned ``mesh`` backed by a fake process group
    (see the module docstring); on a mesh of one real device, on its plain
    meta arguments.  ``flops_global`` is counted first, on the plain step
    at the global shapes."""
    t0 = time.perf_counter()
    step, args, *_ = build_cell(cfg, shape, mesh, force_accum=force_accum,
                                sharding_opts=sharding_opts)
    flops_global = count_flops(step, args)
    with fake_device_mesh(mesh) if mesh.abstract else contextlib.nullcontext():
        step, args, shardings, donate, rules = build_cell(
            cfg, shape, mesh, force_accum=force_accum, sharding_opts=sharding_opts)
        dargs = args if mesh.device_mesh is None else distribute_meta(args, shardings)
        with implicit_replication(), DeviceBook() as book:
            outputs = step(*dargs)
        trace_s = time.perf_counter() - t0
        out_bytes = tree_bytes(outputs, output_shardings(cfg, shape, rules, outputs,
                                                         shardings))
        del outputs, dargs
    return {
        "trace_s": trace_s,
        "flops": book.flops,
        "flops_global": flops_global,
        "bytes_accessed": book.bytes_accessed,
        "bytes_accessed_kind": BYTES_ACCESSED_KIND,
        "accum_steps": force_accum if force_accum is not None else accum_for(cfg, shape),
        "memory_analysis": {
            "argument_bytes": tree_bytes(args, shardings),
            "output_bytes": out_bytes,
            "temp_bytes": book.peak,
            "alias_bytes": sum(tree_bytes(args[i], shardings[i]) for i in donate),
        },
        "temp_bytes_kind": TEMP_BYTES_KIND,
        "collectives": book.collectives(),
    }


def probe_configs(cfg):
    """Two reduced-depth configs (p1, p2) + the unit count of the full
    model, for linear extrapolation of per-layer costs:
        total = f(p1) + (units_full - units_p1) * (f(p2) - f(p1))."""
    if cfg.is_hybrid:
        per = cfg.attn_layer_period
        p1 = dc.replace(cfg, n_layers=per, scan_unroll=True)
        p2 = dc.replace(cfg, n_layers=2 * per, scan_unroll=True)
        return p1, p2, cfg.n_layers // per, 1
    if cfg.is_encdec:
        assert cfg.n_layers == cfg.n_enc_layers
        p1 = dc.replace(cfg, n_layers=1, n_enc_layers=1, scan_unroll=True)
        p2 = dc.replace(cfg, n_layers=2, n_enc_layers=2, scan_unroll=True)
        return p1, p2, cfg.n_layers, 1
    if cfg.first_dense_layers:
        fd = cfg.first_dense_layers
        p1 = dc.replace(cfg, n_layers=fd + 1, scan_unroll=True)
        p2 = dc.replace(cfg, n_layers=fd + 2, scan_unroll=True)
        return p1, p2, cfg.n_layers - fd, 1
    p1 = dc.replace(cfg, n_layers=1, scan_unroll=True)
    p2 = dc.replace(cfg, n_layers=2, scan_unroll=True)
    return p1, p2, cfg.n_layers, 1


def probe_extrapolate(cfg, shape, mesh, sharding_opts=None) -> dict:
    """Whole-model FLOPs, bytes accessed and collective bytes per device
    extrapolated from the two probes (each at accum 1, as the
    reference's)."""
    p1, p2, units_full, units_p1 = probe_configs(cfg)
    vals = []
    for p in (p1, p2):
        r = analyze_cell(p, shape, mesh, sharding_opts=sharding_opts, force_accum=1)
        vals.append({"flops": r["flops"], "bytes": r["bytes_accessed"],
                     "coll": r["collectives"]["bytes_by_kind"],
                     "coll_total": r["collectives"]["total_bytes"]})
    mult = units_full - units_p1

    def ext(a, b):
        return a + mult * (b - a)

    return {
        "flops": ext(vals[0]["flops"], vals[1]["flops"]),
        "bytes": ext(vals[0]["bytes"], vals[1]["bytes"]),
        "collective_bytes": {k: ext(vals[0]["coll"][k], vals[1]["coll"][k])
                             for k in vals[0]["coll"]},
        "collective_total": ext(vals[0]["coll_total"], vals[1]["coll_total"]),
        "probe_raw": vals,
        "units_full": units_full,
    }


def card_capacity(device) -> Optional[dict]:
    """``{"name", "hbm_bytes"}`` of a CUDA device, or None for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    return {"name": props.name, "hbm_bytes": int(props.total_memory)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str = "none", force: bool = False, verbose: bool = True,
             variant: str = "", overrides: Optional[dict] = None,
             sharding_opts: Optional[dict] = None, device=None,
             out_dir: Optional[Path] = None, shape=None) -> dict:
    """One cell's artifact (read back when it exists, unless ``force``).
    ``variant``/``overrides`` name a configuration variant, written to its
    own artifact.  ``device`` (default ``cuda``) gives the capacity ``fits``
    is held to; ``cpu`` gives none.  ``shape`` overrides ``SHAPES[shape_name]``
    (a smaller `ShapeConfig` of the same kind)."""
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    qtag = f"__{quant}" if quant != "none" else ""
    vtag = f"__{variant}" if variant else ""
    out_path = Path(out_dir or OUT_DIR) / f"{arch}__{shape_name}__{mesh_tag}{qtag}{vtag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    card = card_capacity(device)
    cfg = get_config(arch, quant=quant, **(overrides or {}))
    shape = shape or SHAPES[shape_name]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag, "quant": quant,
        "variant": variant,
        "applicable": shape_applicable(cfg, shape),
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
    }
    if not result["applicable"]:
        result["status"] = "skipped_inapplicable"
        result["reason"] = "long_500k needs sub-quadratic sequence mixing (full attention arch)"
        _write(out_path, result)
        return result

    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        result.update(analyze_cell(cfg, shape, mesh, sharding_opts=sharding_opts))
        # per-layer probe extrapolation (single-pod roofline mesh only —
        # the multi-pod pass is the shardability proof)
        probe = None
        if not multi_pod:
            try:
                probe = probe_extrapolate(cfg, shape, mesh, sharding_opts)
            except Exception as pe:  # noqa: BLE001 — a failed probe is data
                probe = {"error": f"{type(pe).__name__}: {pe}"}
        mem = result["memory_analysis"]
        result.update(
            status="ok", probe=probe, device=card,
            fits=(None if card is None else
                  mem["argument_bytes"] + mem["temp_bytes"] <= card["hbm_bytes"]),
        )
        if verbose:
            gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
            fits = "" if card is None else f", fits {card['name']}: {result['fits']}"
            print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: OK "
                  f"(trace {result['trace_s']:.1f}s, {gib:.2f} GiB/dev{fits}, "
                  f"{result['flops']:.3e} FLOPs, collectives "
                  f"{result['collectives']['total_bytes'] / 2**30:.3f} GiB)", flush=True)
    except Exception as e:  # noqa: BLE001 — dry-run failures are data
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: FAIL {e}", flush=True)
    _write(out_path, result)
    return result


def _write(path: Path, obj: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1, default=str))


def _run_job(job, kwargs) -> dict:
    arch, shape, multi_pod = job
    return run_cell(arch, shape, multi_pod=multi_pod, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "ternary", "ternary_packed"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="whose memory `fits` is held to: cuda (default; an error "
                         "without a card) or cpu (fits: null)")
    ap.add_argument("--out-dir", default=None,
                    help=f"artifact directory (default {OUT_DIR})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    jobs = [(a, s, mp) for mp in meshes for a, s in cells]
    kwargs = dict(quant=args.quant, force=args.force, device=args.device,
                  out_dir=args.out_dir)
    if args.jobs > 1:
        # spawned, not forked: a parent that asked the card for its capacity
        # has initialised CUDA, which a forked child cannot use
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_run_job, jobs, [kwargs] * len(jobs)))
    else:
        results = [_run_job(job, kwargs) for job in jobs]
    return 1 if any(r["status"] == "error" for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
