"""The paper's tables and figures from the PyTorch/CUDA port's CUTIE model,
the silicon sweep, and the bitsim exactness gate on the card.

Counterpart of ``benchmarks/paper_tables.py`` with its functions, flags and
``BENCH_silicon`` schema:

  * table1()         — Table 1: CIFAR-10 comparison vs [8]/[9];
  * fig5()           — energy/inference + inferences/s vs voltage;
  * fig6()           — peak energy efficiency + peak throughput vs voltage;
  * dvs_tcn_soa_comparison() — the §8 comparisons;
  * silicon_sweep()  — registry nets x voltage corners x {analytic, sim};
                       ``--silicon`` writes them to ``BENCH_silicon_torch.json``
                       (never over the reference's ``BENCH_silicon.json``,
                       which the rows equal row for row).

The layer lists come from the `repro_torch.api` registry graphs, lowered
through `export_conv_layers`: host arithmetic about the 22 nm chip, the same
on every device.  ``--bitsim-check`` is the exactness gate: on the
paper-size nets, ``bitsim`` == ``ref`` for the batch forward, a streamed
clip == its batch forward, and the ``.cutie`` round trip (assemble ->
loads -> bitsim forward with no graph object) lands on the same logits —
run on ``--device`` (the card by default).

    python3 benchmarks/paper_tables_torch.py                  # print the tables
    python3 benchmarks/paper_tables_torch.py --silicon        # write BENCH_silicon_torch.json
    python3 benchmarks/paper_tables_torch.py --bitsim-check   # exactness gate (exit 1 on a mismatch)

Gate the sweep with ``python3 scripts/check_bench_regression.py --silicon
BENCH_silicon.json BENCH_silicon_torch.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import export_conv_layers, get_graph, silicon_report  # noqa: E402
from repro_torch.core.cutie_arch import (  # noqa: E402
    PAPER,
    CutieHW,
    apply_calibration,
    calibrate,
    evaluate_network,
    voltage_sweep,
)
from repro_torch.device import device_meta, resolve_device  # noqa: E402
from repro_torch.sim import reconcile  # noqa: E402

HW = CutieHW()

CIFAR_GRAPH = get_graph("cifar10_tnn")
DVS_GRAPH = get_graph("dvs_cnn_tcn")


def table1():
    """Table 1 comparison rows; returns list of (name, value, paper)."""
    r05 = silicon_report(CIFAR_GRAPH, v=0.5, hw=HW)
    r09 = silicon_report(CIFAR_GRAPH, v=0.9, hw=HW)
    cal = r05.calibration
    return [
        ("peak_eff_0.5V_TOp/s/W", r05.peak_eff_topsw, PAPER["peak_eff_0v5_topsw"]),
        ("peak_eff_0.9V_TOp/s/W", r09.peak_eff_topsw, PAPER["peak_eff_0v9_topsw"]),
        ("peak_tput_0.5V_TOp/s", r05.ideal.peak_tput_tops_paper, PAPER["peak_tput_0v5_tops"]),
        ("peak_tput_0.9V_TOp/s", r09.ideal.peak_tput_tops_paper, PAPER["peak_tput_0v9_tops"]),
        ("cifar_energy_uJ(calibrated)", r05.energy_uj, PAPER["cifar_energy_uj"]),
        ("cifar_inf_per_s(calibrated)", r05.inf_per_s, PAPER["cifar_inf_per_s"]),
        ("cifar_energy_uJ(ideal)", r05.ideal.energy_j * 1e6, PAPER["cifar_energy_uj"]),
        ("soa_improvement_vs_[8]",
         PAPER["peak_eff_0v5_topsw"] / PAPER["soa_binary_10nm_topsw"], 1.67),
        ("energy_vs_[9]_13.86uJ", PAPER["soa_cifar_energy_uj"][0] / r05.energy_uj, 13.86 / 2.72),
        ("energy_vs_[8]_3.2uJ", PAPER["soa_cifar_energy_uj"][1] / r05.energy_uj, 3.2 / 2.72),
        ("calib_cycle_overhead", cal.cycle_overhead, None),
        ("calib_energy_overhead", cal.energy_overhead, None),
    ]


def fig5(steps: int = 9):
    """Voltage sweep rows: (net, V, uJ/inf, inf/s) — calibrated model."""
    out = []
    for graph, label, per_class in ((CIFAR_GRAPH, "cifar10", 1.0), (DVS_GRAPH, "dvs", 5.0)):
        layers = export_conv_layers(graph)
        r05 = evaluate_network(label, layers, HW, 0.5)
        # the paper counts CNN passes as 'inferences' for DVS (the TCN memory
        # amortizes the window); graph.paper_inf_per_s holds the
        # per-classification target
        cal = calibrate(r05, graph.paper_inf_per_s, graph.paper_energy_uj)
        for r in voltage_sweep(layers, HW, label, steps=steps):
            rc = apply_calibration(r, cal)
            out.append((label, round(r.v, 3), rc.energy_j * 1e6, rc.inf_per_s * per_class))
    return out


def fig6(steps: int = 9):
    """(V, peak TOp/s/W, peak TOp/s) for the CIFAR first-layer burst."""
    layers = export_conv_layers(CIFAR_GRAPH)
    return [(round(r.v, 3), r.peak_layer_eff_topsw_paper, r.peak_tput_tops_paper)
            for r in voltage_sweep(layers, HW, "cifar10", steps=steps)]


def dvs_tcn_soa_comparison():
    """§8 comparisons: energy/op vs the TCN KWS accelerator [10] and the
    energy ratios vs TrueNorth [2] / Loihi [11]."""
    rep = silicon_report(DVS_GRAPH, v=0.5, hw=HW)
    ours_topsw = rep.eff_topsw
    kws_lo, kws_hi = PAPER["soa_tcn_kws_topsw"]
    return [
        ("dvs_avg_eff_TOp/s/W", ours_topsw, None),
        ("vs_kws_accel_low", ours_topsw / kws_lo, "5-15x claimed"),
        ("vs_kws_accel_high", ours_topsw / kws_hi, None),
        ("truenorth_energy_ratio", PAPER["truenorth_energy_ratio"], 3250.0),
        ("loihi_energy_ratio", PAPER["loihi_energy_ratio"], 63.4),
    ]


# ---------------------------------------------------------------------------
# Registry nets x voltage corners x {analytic, sim}  ->  BENCH_silicon_torch.json
# ---------------------------------------------------------------------------

SILICON_NETS = (
    "cifar10_tnn", "dvs_cnn_tcn", "cifar10_tnn_wide",
    "cifar10_tnn_smoke", "dvs_cnn_tcn_smoke", "cifar10_tnn_wide_smoke",
)
SILICON_CORNERS = (0.5, 0.65, 0.8)
BITSIM_NETS = ("cifar10_tnn", "dvs_cnn_tcn", "cifar10_tnn_wide")
SILICON_OUT = REPO_ROOT / "BENCH_silicon_torch.json"  # beside the reference's, never over it


def silicon_sweep(nets=SILICON_NETS, corners=SILICON_CORNERS):
    """One row per (net, V, source): cycles and energy under the analytic
    formula and under the `repro_torch.sim` execution plan, plus the 0.5 V
    reconciliation (``divergence_at_0v5``) — the reference's rows."""
    rows = []
    for net in nets:
        graph = get_graph(net)
        rec = reconcile(graph, hw=HW)
        for v in corners:
            for source in ("analytic", "sim"):
                rep = silicon_report(graph, v=v, hw=HW, source=source)
                rows.append({
                    "net": net,
                    "v": v,
                    "source": source,
                    "cycles": rep.ideal.cycles,
                    "ideal_energy_uj": rep.ideal.energy_j * 1e6,
                    "ideal_inf_per_s": rep.ideal.inf_per_s,
                    "energy_uj": rep.energy_uj,
                    "inf_per_s": rep.inf_per_s,
                    "calibrated": rep.calibrated is not None,
                    "analytic_schedulable": rec["analytic_schedulable"],
                    "divergence_at_0v5": rec["divergence"],
                    "stall_cycles": rec["stall_cycles"],
                })
    return rows


def write_silicon_bench(out: Path, dev: torch.device, nets=SILICON_NETS,
                        corners=SILICON_CORNERS) -> int:
    rows = silicon_sweep(nets, corners)
    payload = {
        "meta": {
            "schema": "BENCH_silicon.v1",
            "nets": list(nets),
            "corners": list(corners),
            "device": device_meta(dev),
            "torch_version": torch.__version__,
            "generated_unix": int(time.time()),
            "note": (
                "deterministic model output (host arithmetic about the 22 nm "
                "chip, no device measured) - regenerate with 'python3 "
                "benchmarks/paper_tables_torch.py --silicon'; equal row for row "
                "to the reference's BENCH_silicon.json and gated by "
                "scripts/check_bench_regression.py --silicon"
            ),
        },
        "results": rows,
    }
    out.write_text(json.dumps(payload, indent=2) + "\n")
    print(f"[silicon] wrote {out} ({len(rows)} rows)", flush=True)
    return 0


def check_bitsim_exactness(dev: torch.device, nets=BITSIM_NETS, seed: int = 0) -> int:
    """The exactness gate: ``backend="bitsim"`` bit-equal to ``"ref"`` on the
    paper-size registry nets — the batch forward everywhere, a streamed clip
    == its batch forward on the temporal net, and the ``.cutie`` round trip
    (assemble -> loads -> bitsim forward, no graph object) landing on the
    same logits.  Returns 1 on any mismatch, else 0."""
    from repro_torch import artifact
    from repro_torch.api import get_net

    failures = 0
    with torch.no_grad():
        for idx, name in enumerate(nets):
            prog = get_net(name)
            g = prog.graph
            rng = np.random.default_rng([seed, idx])
            if g.is_temporal:
                x = (rng.random((1, 3, *g.input_hw, g.input_ch)) < 0.05).astype(np.float32)
            else:
                x = np.sign(rng.standard_normal((1, *g.input_hw, g.input_ch))).astype(np.float32)
            x = torch.from_numpy(x).to(dev)
            params = prog.init(torch.Generator().manual_seed(seed + 1), device=dev)
            dep = prog.quantize(params, calib=x)
            got = dep.forward(x, backend="bitsim")
            exact = bool(torch.equal(got, dep.forward(x, backend="ref")))
            print(f"[sim-check] {name}: bitsim==ref {'OK' if exact else 'MISMATCH'}",
                  flush=True)
            failures += 0 if exact else 1
            if g.is_temporal:
                session = dep.stream(batch=1, backend="bitsim")
                for t in range(x.shape[1]):
                    logits = session.step(x[:, t])
                s_exact = bool(torch.equal(logits, got))
                print(f"[sim-check] {name}: stream==batch {'OK' if s_exact else 'MISMATCH'}",
                      flush=True)
                failures += 0 if s_exact else 1
            data = dep.to_artifact_bytes()
            loaded = artifact.loads(data, device=dev)
            a_exact = bool(torch.equal(loaded.forward(x, backend="bitsim"), got)
                           and artifact.reassemble(artifact.disassemble(data)) == data)
            print(f"[sim-check] {name}: artifact==graph {'OK' if a_exact else 'MISMATCH'}",
                  flush=True)
            failures += 0 if a_exact else 1
    return 1 if failures else 0


def _print_tables() -> None:
    for label, rows in (("Table 1", table1()), ("DVS/TCN SoA", dvs_tcn_soa_comparison())):
        print(f"== {label} ==")
        for name, value, paper in rows:
            ref = "" if paper is None else f"   (paper: {paper})"
            print(f"  {name:32s} {value:12.4g}{ref}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--silicon", action="store_true",
                    help="write the nets x corners x sources sweep JSON")
    ap.add_argument("--bitsim-check", action="store_true",
                    help="bitsim-vs-ref bit-exactness on the paper-size nets")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error when no CUDA device is "
                         "available) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", type=Path, default=SILICON_OUT,
                    help="output path for --silicon")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.bitsim_check:
        return check_bitsim_exactness(dev, BITSIM_NETS, args.seed)
    if args.silicon:
        return write_silicon_bench(args.out, dev)
    _print_tables()
    return 0


if __name__ == "__main__":
    sys.exit(main())
