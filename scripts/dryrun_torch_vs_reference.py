"""The port's per-device dry-run (`repro_torch.launch.dryrun`) against the
reference's GSPMD compile of the same cells, on small planned meshes.

The reference's cells are compiled in a process of their own, on host
devices forced by its own ``XLA_FLAGS`` (they never reach this process),
with every scan unrolled (``scan_unroll=True``), so each layer's dots and
collectives stand in the compiled HLO once as they run.  From each
compiled cell it reads the argument and temp bytes of ``memory_analysis``,
the collectives by kind (`repro.launch.dryrun.parse_collective_bytes`) and
the FLOPs of its dot instructions (``dot_flops``: 2 x the output's elements
x the contracted size, from the HLO's shapes; ``cost_analysis`` counts
elementwise work too, which the port's FLOP count leaves out).  The port's
cells come from `analyze_cell` on planned meshes of the same shapes.

Usage:
    PYTHONPATH=src python scripts/dryrun_torch_vs_reference.py [--arch gemma-2b] [--meshes 1x4,16x16]
    PYTHONPATH=src python scripts/dryrun_torch_vs_reference.py --sweep-gather 0,1,2,4,8,16,1e9
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
MESHES = ((1, 1), (1, 4), (2, 4))

# (seq_len, global_batch) of the SMOKE cells, one per step kind
SMOKE_SHAPES = {"train": ("train_4k", 16, 4), "prefill": ("prefill_32k", 16, 2),
                "decode": ("decode_32k", 16, 2)}

REFERENCE = r"""
import dataclasses, json, re, sys
import jax
import numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as ref
from repro.configs import get_config
from repro.models.config import ShapeConfig


def dot_flops(text):
    shapes = {}
    defn = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*[a-z0-9]+\[([0-9,]*)\]")
    for line in text.splitlines():
        m = defn.match(line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    dot = re.compile(r"=\s*[a-z0-9]+\[([0-9,]*)\]\S*\s+dot\(%([\w.\-]+),\s*%[\w.\-]+\)"
                     r".*lhs_contracting_dims=\{([0-9,]*)\}")
    total = 0
    for line in text.splitlines():
        m = dot.search(line)
        if m:
            out = int(np.prod([int(d) for d in m.group(1).split(",") if d]))
            lhs = shapes[m.group(2)]
            k = int(np.prod([lhs[int(d)] for d in m.group(3).split(",") if d]))
            total += 2 * out * k
    return total


arch, meshes, shapes = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config(arch, smoke=True), scan_unroll=True)
out = {}
for shape_mesh in meshes:
    n = int(np.prod(shape_mesh))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape_mesh), ("data", "model"))
    for kind, (name, seq, batch) in shapes.items():
        with mesh:
            step, args, in_sh, donate, out_sh = ref.build_cell(
                cfg, ShapeConfig(name, seq, batch, kind), mesh)
            compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=donate).lower(*args).compile()
        text = compiled.as_text()
        assert " while(" not in text, "a loop left in the unrolled cell"
        mem = compiled.memory_analysis()
        out["x".join(map(str, shape_mesh)) + " " + kind] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "flops": dot_flops(text),
            "collectives": ref.parse_collective_bytes(text),
        }
print(json.dumps(out))
"""


def reference_cells(arch: str = "gemma-2b", meshes=MESHES, kinds=KINDS) -> dict:
    """``{"<d>x<m> <kind>": {argument_bytes, temp_bytes, flops, collectives}}``
    of the reference's SMOKE cells compiled under GSPMD on forced host
    devices, in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{max(a * b for a, b in meshes)}",
               PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([arch, [list(m) for m in meshes],
                      {k: SMOKE_SHAPES[k] for k in kinds}])
    out = subprocess.run([sys.executable, "-c", REFERENCE, arg], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_cells(arch: str = "gemma-2b", meshes=MESHES, kinds=KINDS) -> dict:
    """The same cells from the port's `analyze_cell` on planned meshes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import planned_mesh
    from repro_torch.models.config import ShapeConfig

    cfg = get_config(arch, smoke=True)
    out = {}
    for shape_mesh in meshes:
        for kind in kinds:
            r = dryrun.analyze_cell(cfg, ShapeConfig(*SMOKE_SHAPES[kind], kind),
                                    planned_mesh(tuple(shape_mesh), ("data", "model")))
            out["x".join(map(str, shape_mesh)) + " " + kind] = {
                "argument_bytes": r["memory_analysis"]["argument_bytes"],
                "temp_bytes": r["memory_analysis"]["temp_bytes"],
                "flops": r["flops"], "collectives": r["collectives"]}
    return out


def ratios(port: dict, ref: dict, mesh: str, kind: str) -> dict:
    """Port over reference on one cell: collective bytes, and the model's
    split of temp bytes (temp on (1, 1) over temp on the mesh)."""
    p, r = port[f"{mesh} {kind}"], ref[f"{mesh} {kind}"]
    split = ((port[f"1x1 {kind}"]["temp_bytes"] / p["temp_bytes"])
             / (ref[f"1x1 {kind}"]["temp_bytes"] / r["temp_bytes"]))
    coll = p["collectives"]["total_bytes"] / max(r["collectives"]["total_bytes"], 1)
    return {"temp_split": split, "collectives": coll}


def _table(port: dict, ref: dict) -> None:
    for key in port:
        p, r = port[key], ref[key]
        print(f"{key:12s} args {p['argument_bytes']}/{r['argument_bytes']}  "
              f"flops {p['flops']}/{r['flops']}  temp {p['temp_bytes']}/{r['temp_bytes']}  "
              f"collectives {p['collectives']['total_bytes']}/"
              f"{r['collectives']['total_bytes']}  (port/reference)")
        print(f"{'':12s} port {p['collectives']['bytes_by_kind']}")
        print(f"{'':12s} ref  {r['collectives']['bytes_by_kind']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--meshes", default="1x1,1x4,2x4",
                    help="(data)x(model) meshes of the table, comma-separated")
    ap.add_argument("--sweep-gather", default=None,
                    help="comma-separated values of sharding.GATHER_ACTIVATION_UP_TO: "
                         "the port's ratios to the reference at each")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    if not args.sweep_gather:
        meshes = [tuple(int(n) for n in m.split("x")) for m in args.meshes.split(",")]
        _table(port_cells(args.arch, meshes), reference_cells(args.arch, meshes))
        return 0
    ref = reference_cells(args.arch)
    from repro_torch.launch import sharding

    for value in [float(v) for v in args.sweep_gather.split(",")]:
        sharding.GATHER_ACTIVATION_UP_TO = value
        port = port_cells(args.arch)
        cells = [(m, k) for m in ("1x4", "2x4") for k in KINDS]
        rs = {f"{m} {k}": ratios(port, ref, m, k) for m, k in cells}
        worst = max(abs(math.log(v)) for r in rs.values() for v in r.values())
        print(json.dumps({"gather_activation_up_to": value, "worst_log_ratio": worst,
                          "ratios": rs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
