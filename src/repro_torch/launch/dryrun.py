"""Dry-run of every (arch x shape x mesh) cell on meta tensors: what one
device of a production mesh computes and holds, without the mesh.
Counterpart of `repro.launch.dryrun`.

The reference lowers and compiles each cell under GSPMD on 512 forced host
devices.  The port has no SPMD partitioner; it runs the cell's step once on
meta tensors (shapes and dtypes, no storage, no card) and reads:

    flops          `FlopCounterMode` over one call at the global batch,
                   divided by the mesh size (the reference's per-device
                   figure); ``flops_global`` beside it
    argument_bytes one device's bytes of every argument leaf under the
                   cell's sharding plan (`launch/sharding.py`) — exact
    alias_bytes    the bytes of the argument the reference donates (the
                   train state; the decode cache)
    output_bytes   one device's bytes of the step's outputs
    temp_bytes     the peak of bytes allocated and alive while the step
                   runs at the per-device batch (global / data-parallel
                   size), each allocation counted as the most the CUDA
                   caching allocator books for it (`booked_bytes`).  The
                   model axis does not split activations here: an upper
                   bound
    fits           argument_bytes + temp_bytes <= the card's own memory
                   (``device``); null with ``--device cpu``

``probe`` extrapolates FLOPs from two reduced-depth configs as the
reference does (`probe_configs`), so `benchmarks/roofline.py` finds its
fields; the port runs every layer in a Python loop, so probe and full
count agree on dense configs.  There are no HLO and no collectives to
parse: ``collectives`` is null, with the reason.

Artifacts land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__quant][__variant].json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--jobs 8]
"""
from __future__ import annotations

import argparse
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import P, Sharding, rules_for_cell
from repro_torch.launch.steps import (
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    train_state_specs,
)
from repro_torch.models.config import SHAPES
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves, tree_unflatten

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# the CUDA caching allocator hands out blocks in multiples of 512 bytes, and
# leaves a block of the large pool unsplit when less than 1 MiB would remain
ALLOC_GRANULE = 512
ALLOC_UNSPLIT = 1 << 20

TEMP_BYTES_KIND = "upper_bound_model_axis_unsplit"
COLLECTIVES_REASON = ("the port has no SPMD partitioner whose program could be parsed "
                      "for collectives")


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
    its meta arguments at the global batch, a `Sharding` per argument leaf
    (the same tree as ``args``) and the argument the reference donates."""
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
        step = make_prefill_step(cfg, shape.seq_len, shard=shard)
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


def local_args(args, shardings, rules):
    """Meta arguments at one device's batch: every non-parameter argument
    (the batch, the decode tokens and cache) with each dim laid over the
    batch axes cut to its block.  Parameters and the train state keep
    their full shape: the model axis splits nothing here."""
    ba = P(rules.logical["batch"])[0]  # as a spec entry reads it

    def cut(x, s):
        spec = list(s.spec) + [None] * (x.ndim - len(s.spec))
        shape = [blk if ba is not None and e == ba else d
                 for d, e, blk in zip(x.shape, spec, s.shard_shape(x.shape))]
        return torch.empty(shape, dtype=x.dtype, device="meta")

    out = [args[0]]
    for a, s in zip(args[1:], shardings[1:]):
        out.append(tree_unflatten(a, [cut(x, sh) for x, sh in
                                      zip(tree_leaves(a), tree_leaves(s))]))
    return tuple(out)


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
    """The most bytes ``step(*args)`` holds at once beyond its arguments."""
    with LiveBytes() as live:
        step(*args)
    return live.peak


def analyze_cell(cfg, shape, mesh, *, sharding_opts: Optional[dict] = None) -> dict:
    """FLOPs and bytes per device of one cell (see the module docstring)."""
    step, args, shardings, donate, rules = build_cell(cfg, shape, mesh,
                                                      sharding_opts=sharding_opts)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        outputs = step(*args)
    flops_global = int(fc.get_total_flops())
    out_bytes = tree_bytes(outputs, output_shardings(cfg, shape, rules, outputs, shardings))
    del outputs
    temp = peak_temp_bytes(step, local_args(args, shardings, rules))
    return {
        "trace_s": time.perf_counter() - t0,
        "flops": flops_global / mesh.size,
        "flops_global": flops_global,
        "accum_steps": accum_for(cfg, shape),
        "memory_analysis": {
            "argument_bytes": tree_bytes(args, shardings),
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": sum(tree_bytes(args[i], shardings[i]) for i in donate),
        },
        "temp_bytes_kind": TEMP_BYTES_KIND,
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
    """Whole-model FLOPs per device extrapolated from the two probes (each
    at accum 1, as the reference's)."""
    p1, p2, units_full, units_p1 = probe_configs(cfg)
    raw = []
    for p in (p1, p2):
        step, args, *_ = build_cell(p, shape, mesh, force_accum=1,
                                    sharding_opts=sharding_opts)
        raw.append(count_flops(step, args))
    total = raw[0] + (units_full - units_p1) * (raw[1] - raw[0])
    return {
        "flops": total / mesh.size,
        "bytes": None, "collective_bytes": None, "collective_total": None,
        "probe_raw": [{"flops": f / mesh.size} for f in raw],
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
            status="ok", probe=probe, collectives=None,
            collectives_reason=COLLECTIVES_REASON, device=card,
            fits=(None if card is None else
                  mem["argument_bytes"] + mem["temp_bytes"] <= card["hbm_bytes"]),
        )
        if verbose:
            gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
            fits = "" if card is None else f", fits {card['name']}: {result['fits']}"
            print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: OK "
                  f"(trace {result['trace_s']:.1f}s, {gib:.2f} GiB/dev{fits}, "
                  f"{result['flops']:.3e} FLOPs)", flush=True)
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
