"""Roofline analysis of the PyTorch/CUDA port's dry-run artifacts
(``experiments/dryrun_torch/*.json``) against NVIDIA H100 peaks.

Counterpart of ``benchmarks/roofline.py``.  Per (arch x shape) on the
single-pod 16x16 mesh:

    compute term    = FLOPs / 989e12                [s]
    memory term     = bytes / 3.35e12               [s]
    collective term = collective_bytes / 450e9      [s]

FLOPs, bytes and collective bytes come from the artifact's ``probe`` (the
reduced-depth extrapolation of `repro_torch.launch.dryrun`), else its
top-level fields.  All three are PER DEVICE, so each term divides by ONE
card's peak; MODEL_FLOPS is global and divides by all 256 cards.

Hardware (one H100 SXM, NVIDIA's data sheet, dense): 989 TFLOP/s bf16, 3.35
TB/s HBM3, and NVLink 4 at 900 GB/s per card counting both directions, so
450 GB/s each way.  A 256-card mesh spans 32 nodes of 8 cards, and every
collective whose group leaves a node runs over the slower network between
them: the collective term is a **lower bound**.

Conventions (the reference's, but for the last):
  * MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill/decode), N = active params;
  * ``bytes`` is the dry-run's unfused count (each op's inputs and outputs),
    an upper bound of what a fused step moves;
  * ``bw_fraction`` is not capped at 1 (the reference caps it): a share
    above 1 means a byte or time count is wrong, and shows.

It reads JSON and runs nothing on a device (as the reference):

    python3 benchmarks/roofline_torch.py [--art-dir DIR]   # the table over the artifacts
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.models.config import SHAPES  # noqa: E402

PEAK_FLOPS = 989e12        # bf16 FLOP/s, one H100 SXM (dense)
HBM_BW = 3.35e12           # bytes/s, one H100 SXM
# bytes/s one way per card: NVLink 4, 900 GB/s both directions (H100 SXM data sheet)
LINK_BW = 450e9
CHIPS = 256

ART_DIR = REPO_ROOT / "experiments" / "dryrun_torch"


def model_flops(n_active: int, tokens: int, kind: str) -> float:
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def load_cell(arch: str, shape: str, mesh: str = "pod16x16", quant: str = "none",
              art_dir: Path = ART_DIR) -> Optional[dict]:
    qtag = f"__{quant}" if quant != "none" else ""
    p = Path(art_dir) / f"{arch}__{shape}__{mesh}{qtag}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def roofline_row(r: dict) -> Optional[Dict]:
    """The roofline terms of one artifact."""
    if r.get("status") != "ok":
        return None
    shape = SHAPES[r["shape"]]
    probe = r.get("probe") or {}
    flops = probe.get("flops") or r.get("flops")          # per device
    hbm_bytes = probe.get("bytes") or r.get("bytes_accessed")
    coll = probe.get("collective_total", (r.get("collectives") or {}).get("total_bytes", 0))
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mf = model_flops(r["n_active_params"], tokens, shape.kind)
    mf_per_dev = mf / CHIPS
    step_time = max(terms.values())
    useful_frac = mf_per_dev / max(flops, 1.0)
    # compute-roofline fraction: useful model FLOPs per device over what the
    # card could do in the bound step time (the MFU analogue)
    frac = mf_per_dev / (step_time * PEAK_FLOPS) if step_time > 0 else 0.0
    # bandwidth-roofline fraction: the irreducible bytes (active params, plus
    # the cache arguments in decode) over the bytes the bound time moves
    min_bytes = 2 * r["n_active_params"] / CHIPS  # bf16 weights / device
    m = r["memory_analysis"]
    if shape.kind == "decode":
        min_bytes += max(m["argument_bytes"] - min_bytes, 0)  # + cache args
    bw_frac = (min_bytes / HBM_BW) / step_time if step_time > 0 else 0.0
    return dict(
        arch=r["arch"], shape=r["shape"],
        t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
        dominant=dominant, model_flops=mf, hlo_flops_per_dev=flops,
        useful_ratio=useful_frac, roofline_fraction=frac,
        bw_fraction=bw_frac,
        mem_gib=(m["argument_bytes"] + m["temp_bytes"]) / 2**30,
        collectives_by_kind=probe.get("collective_bytes"),
    )


def _status_row(arch: str, shape: str, r: Optional[dict]) -> Dict:
    if r is None:
        return {"arch": arch, "shape": shape, "status": "missing"}
    if r["status"] == "skipped_inapplicable":
        return {"arch": arch, "shape": shape, "status": "skipped"}
    row = roofline_row(r)
    if row is None:
        return {"arch": arch, "shape": shape, "status": "error"}
    row["status"] = "ok"
    return row


def full_table(mesh: str = "pod16x16", quant: str = "none",
               art_dir: Path = ART_DIR) -> List[Dict]:
    from repro_torch.configs import ARCH_IDS

    return [_status_row(arch, shape, load_cell(arch, shape, mesh, quant, art_dir))
            for arch in ARCH_IDS for shape in SHAPES]


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'comp(ms)':>9s} {'mem(ms)':>9s} "
           f"{'coll(ms)':>9s} {'bound':>6s} {'useful':>7s} {'roofl%':>7s} "
           f"{'bw%':>6s} {'GiB':>6s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:24s} {r['shape']:12s} [{r['status']}]")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['t_compute']*1e3:9.4f} "
            f"{r['t_memory']*1e3:9.4f} {r['t_collective']*1e3:9.4f} "
            f"{r['dominant'][:6]:>6s} {r['useful_ratio']:7.2f} "
            f"{r['roofline_fraction']*100:6.1f}% {r['bw_fraction']*100:5.1f}% "
            f"{r['mem_gib']:6.2f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--art-dir", type=Path, default=ART_DIR,
                    help=f"artifact directory (default {ART_DIR})")
    args = ap.parse_args(argv)
    rows = full_table(art_dir=args.art_dir)
    print(f"[roofline] H100 SXM peaks: {PEAK_FLOPS:.3g} FLOP/s bf16, {HBM_BW:.3g} B/s HBM, "
          f"{LINK_BW:.3g} B/s link (collective term a lower bound)")
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
