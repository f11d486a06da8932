"""`repro_torch.sim`, `repro_torch.core.cutie_arch`, `kernels.autotune` and the
silicon report, held against the reference on the CPU.

The compiler and the cost model are plain Python in both packages, so every
comparison here is **equality**: `ExecutionPlan.to_dict()`, `count_plan`,
`kernel_block_plan`, `reconcile` and every `silicon_report` field, for every
registry net; and the committed ``BENCH_silicon.json`` rows (the reference's
sweep output) reproduced by the port.

The ``bitsim`` backend runs on deploy tables handed over as numpy to both
packages (`repro_torch.convert` on the port's side): its logits must equal
the port's ``ref``/``fused``/``kernel`` logits and the reference's
``bitsim`` logits (ternary/0-1 inputs, so every sum is exact in float32),
batch and stream.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import sim as jsim
from repro.api.program import DeployedProgram as DeployedJ
from repro.core.cutie_arch import CutieHW as CutieHWJ
from repro.kernels.autotune import kernel_block_plan as blocks_j
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch import sim as tsim
from repro_torch.core import cutie_arch as tarch
from repro_torch.kernels.autotune import kernel_block_plan as blocks_t

ROOT = Path(__file__).resolve().parent.parent
NETS = japi.list_nets()
CORNERS = (0.5, 0.65, 0.8)
SMOKE_NETS = ["cifar10_tnn_smoke", "cifar10_tnn_wide_smoke", "dvs_cnn_tcn_smoke",
              "kws_tcn_smoke"]
BACKENDS = ("fused", "kernel", "ref", "bitsim")


def _tables_np(x):
    """Deploy tables as numpy arrays (tensors) and Python scalars."""
    if isinstance(x, dict):
        return {k: _tables_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables_np(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _tables_jnp(x):
    if isinstance(x, dict):
        return {k: _tables_jnp(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tables_jnp(v) for v in x]
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _inputs(graph, seed, batch=2, frames=4):
    """Seeded numpy inputs: 0/1 event frames for the two-polarity nets,
    trits otherwise."""
    rng = np.random.RandomState(seed)
    lead = (batch, frames) if graph.is_temporal else (batch,)
    shape = (*lead, *graph.input_hw, graph.input_ch)
    if graph.input_ch == 2:
        return (rng.rand(*shape) < 0.05).astype(np.float32)
    return rng.randint(-1, 2, shape).astype(np.float32)


def _reference(name, seed=0, learn_thresholds=False):
    """Calibrated deploy tables (quantized by the port, whose calibration
    forward is fast here), handed as numpy to BOTH packages: the reference's
    `DeployedProgram` and the port's through `convert`.  Returns (reference
    program, port program, input)."""
    prog = tapi.get_net(name)
    params = prog.init(torch.Generator().manual_seed(seed), learn_thresholds=learn_thresholds,
                       device="cpu")
    if learn_thresholds == "per_channel":
        # non-uniform vectors, so a scalar path cannot fake it
        params["thresh"]["conv"] = [
            t + torch.linspace(-0.2, 0.4, t.shape[0]) for t in params["thresh"]["conv"]]
    x = _inputs(prog.graph, seed + 1)
    tables = _tables_np(prog.quantize(params, calib=torch.from_numpy(x)).tables)
    dep = DeployedJ(japi.get_graph(name), _tables_jnp(tables))
    port = convert.deployed_from_reference_tables(name, tables, device="cpu")
    return dep, port, x


def _exact(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want))


def _report_dict(rep):
    return {"graph_name": rep.graph_name, "v": rep.v, "source": rep.source,
         "ideal": dataclasses.asdict(rep.ideal),
         "calibrated": None if rep.calibrated is None else dataclasses.asdict(rep.calibrated),
         "calibration": None if rep.calibration is None else (
             rep.calibration.cycle_overhead, rep.calibration.energy_overhead,
             rep.calibration.consistent)}


# ---------------------------------------------------------------------------
# the compiler and the cost model: plain Python, equal for every net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_plan_and_counts_equal_reference(name):
    g_t, g_j = tapi.get_graph(name), japi.get_graph(name)
    plan_t, plan_j = tsim.lower(g_t), jsim.lower(g_j)
    assert plan_t.to_dict() == plan_j.to_dict()
    assert tsim.ExecutionPlan.from_dict(json.loads(json.dumps(plan_t.to_dict()))) == plan_t
    assert ([dataclasses.asdict(c) for c in tsim.count_plan(plan_t)]
            == [dataclasses.asdict(c) for c in jsim.count_plan(plan_j)])
    assert ([dataclasses.asdict(c) for c in tsim.inference_counts(plan_t)]
            == [dataclasses.asdict(c) for c in jsim.inference_counts(plan_j)])
    assert tsim.reconcile(g_t) == jsim.reconcile(g_j)
    assert tapi.export_conv_layers(g_t) == [
        tarch.ConvLayer(**dataclasses.asdict(l)) for l in japi.export_conv_layers(g_j)]


@pytest.mark.parametrize("name", NETS)
def test_kernel_block_plan_equal_reference(name):
    got = blocks_t(tsim.lower(tapi.get_graph(name)))
    want = blocks_j(jsim.lower(japi.get_graph(name)))
    assert {k: [dataclasses.asdict(b) for b in v] for k, v in got.items()} == \
           {k: [dataclasses.asdict(b) for b in v] for k, v in want.items()}


def test_small_array_tiling_and_stall_params_equal_reference():
    hw_t, hw_j = tarch.CutieHW(n_ocu=8, max_cin=8), CutieHWJ(n_ocu=8, max_cin=8)
    for name in ("cifar10_tnn_wide", "dvs_cnn_tcn"):
        plan_t = tsim.lower(tapi.get_graph(name), hw_t)
        plan_j = jsim.lower(japi.get_graph(name), hw_j)
        assert plan_t.to_dict() == plan_j.to_dict()
        params_t = tsim.SimParams(fmap_bank_bytes=512)
        params_j = jsim.SimParams(fmap_bank_bytes=512)
        got = tsim.count_plan(plan_t, hw_t, params_t)
        want = jsim.count_plan(plan_j, hw_j, params_j)
        assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
        assert sum(c.stall_cycles for c in got) > 0


@pytest.mark.parametrize("source", ["analytic", "sim"])
@pytest.mark.parametrize("name", NETS)
def test_silicon_report_equal_reference(name, source):
    for v in CORNERS:
        got = tapi.silicon_report(tapi.get_graph(name), v=v, source=source)
        want = japi.silicon_report(japi.get_graph(name), v=v, source=source)
        assert _report_dict(got) == _report_dict(want)
        assert got.summary() == want.summary()


def _bench_rows():
    return json.loads((ROOT / "BENCH_silicon.json").read_text())["results"]


@pytest.mark.parametrize("row", _bench_rows(),
                         ids=lambda r: f"{r['net']}-{r['v']}-{r['source']}")
def test_committed_bench_silicon_rows_reproduced(row):
    """The field mapping of `benchmarks/paper_tables.py --silicon`."""
    g = tapi.get_graph(row["net"])
    rep = tapi.silicon_report(g, v=row["v"], source=row["source"])
    rec = tsim.reconcile(g)
    got = {
        "net": row["net"], "v": row["v"], "source": row["source"],
        "cycles": rep.ideal.cycles, "ideal_energy_uj": rep.ideal.energy_j * 1e6,
        "ideal_inf_per_s": rep.ideal.inf_per_s, "energy_uj": rep.energy_uj,
        "inf_per_s": rep.inf_per_s, "calibrated": rep.calibrated is not None,
        "analytic_schedulable": rec["analytic_schedulable"],
        "divergence_at_0v5": rec["divergence"], "stall_cycles": rec["stall_cycles"],
    }
    assert got == row


def test_cifar_corner_is_the_paper():
    for source in ("analytic", "sim"):
        rep = tapi.get_net("cifar10_tnn").silicon_report(v=0.5, source=source)
        assert abs(rep.energy_uj - tarch.PAPER["cifar_energy_uj"]) < 1e-9
        assert abs(rep.inf_per_s - tarch.PAPER["cifar_inf_per_s"]) < 1e-6
        assert round(rep.peak_eff_topsw) == 1036 and rep.calibration.consistent
    assert tapi.registry.PAPER is tarch.PAPER
    with pytest.raises(ValueError, match="unknown silicon source"):
        tapi.silicon_report(tapi.get_graph("cifar10_tnn"), source="magic")


# ---------------------------------------------------------------------------
# bitsim and the images, on the reference's own tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMOKE_NETS)
def test_bitsim_equal_every_backend_and_reference_bitsim(name):
    dep, port, x = _reference(name)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want = dep.forward(xj, backend="bitsim")
    logits = {b: port.forward(xt, backend=b) for b in BACKENDS}
    for b, y in logits.items():
        _exact(y, want)
    if port.graph.is_temporal:
        session = port.stream(batch=2, backend="bitsim")
        for t in range(x.shape[1]):
            streamed = session.step(xt[:, t])
        _exact(streamed, logits["bitsim"])
    assert port.execution_plan().to_dict() == dep.execution_plan().to_dict()
    assert {k: [dataclasses.asdict(b) for b in v] for k, v in port.kernel_blocks.items()} == \
           {k: [dataclasses.asdict(b) for b in v] for k, v in dep.kernel_blocks.items()}


@pytest.mark.parametrize("name", ["cifar10_tnn_smoke", "dvs_cnn_tcn_smoke"])
def test_weight_images_and_sparsity_priced_report_equal_reference(name):
    dep, port, _ = _reference(name)
    mem_t, mem_j = port._bitsim().memory, dep._bitsim().memory
    assert mem_t.to_dict() == mem_j.to_dict()
    for img_t, img_j, lp in zip(mem_t.images, mem_j.images, port.execution_plan().weight_layers()):
        assert img_t.weight_sparsity(lp.c_in) == img_j.weight_sparsity(lp.c_in)
    for v in CORNERS:
        got = port.silicon_report(v=v, source="sim")
        want = dep.silicon_report(v=v, source="sim")
        assert _report_dict(got) == _report_dict(want)


def test_per_channel_thresholds_round_trip_and_execute():
    """Per-OCU threshold vectors: the images carry float32 [C_out] vectors
    through to_dict/from_dict, and bitsim reads the same constants the fused
    epilogue receives."""
    dep, port, x = _reference("cifar10_tnn_smoke", learn_thresholds="per_channel")
    mem = port._bitsim().memory
    thr = mem.images[0].threshold
    assert isinstance(thr, np.ndarray) and thr.dtype == np.float32 and thr.ndim == 1
    wire = json.loads(json.dumps({"plan": port.execution_plan().to_dict(),
                                  "memory": mem.to_dict()}))
    back = tsim.WeightMemory.from_dict(wire["memory"])
    assert back.to_dict() == mem.to_dict()
    assert back.images[0].threshold.dtype == np.float32
    ex = tsim.PlanExecutor(tsim.ExecutionPlan.from_dict(wire["plan"]), back)
    xt = torch.from_numpy(x)
    want = dep.forward(jnp.asarray(x), backend="bitsim")
    _exact(ex.spatial_forward(xt), want)
    _exact(port.forward(xt, backend="fused"), want)


def test_forced_tiling_stays_exact():
    """A tiny OCU array splits every layer into many tile passes; the
    partial sums across C_in tiles must not change a bit."""
    dep, port, x = _reference("cifar10_tnn_wide_smoke")
    plan = tsim.lower(port.graph, tarch.CutieHW(n_ocu=4, max_cin=4))
    assert max(len(lp.tiles) for lp in plan.layers) > 4
    mem = tsim.WeightMemory.from_tables(plan, port.tables, port.graph.act_threshold)
    xt = torch.from_numpy(x)
    _exact(tsim.PlanExecutor(plan, mem).spatial_forward(xt), port.forward(xt, backend="ref"))
    for backend in ("fused", "kernel", "ref"):
        ex = tsim.PlanExecutor(plan, mem, backend=backend)
        _exact(ex.spatial_forward(xt), port.forward(xt, backend="ref"))


def test_backend_names():
    assert tapi.BACKENDS == ("fused", "kernel", "ref", "bitsim")
    with pytest.raises(ValueError, match="called 'kernel' here"):
        tapi.check_backend("pallas")
    with pytest.raises(ValueError, match="no counterpart"):
        tapi.check_backend("interpret")


@pytest.mark.parametrize("backend", ["bitsim", "kernel"])
def test_pool_and_session_serve_the_new_backends(backend):
    """`SessionPool` and `StreamSession` take the new backends through
    `check_backend`: every pooled logit equals its lone session's, and both
    equal the fused pool's."""
    from repro_torch.serving import SessionPool

    _, port, _ = _reference("dvs_cnn_tcn_nano")
    g = port.graph
    frames = (np.random.RandomState(3).rand(2, 5, *g.input_hw, g.input_ch) < 0.1
              ).astype(np.float32)
    pool = SessionPool(port, 2, backend=backend)
    fused = SessionPool(port, 2, backend="fused")
    sessions = [port.stream(batch=1, backend=backend) for _ in range(2)]
    for sid in ("a", "b"):
        pool.admit(sid)
        fused.admit(sid)
    for t in range(frames.shape[1]):
        step = {"a": frames[0, t], "b": frames[1, t]}
        out, want = pool.step(step), fused.step(step)
        for i, sid in enumerate(("a", "b")):
            lone = sessions[i].step(torch.from_numpy(frames[i:i + 1, t]))[0]
            _exact(out[sid], lone.numpy())
            _exact(out[sid], want[sid])


def test_launch_serve_prints_the_silicon_line_on_a_new_backend(capsys):
    """The launcher's silicon-report line (the reference launcher's), on
    the ``bitsim`` backend."""
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--dvs", "--net", "dvs_cnn_tcn_nano", "--pool", "2",
                            "--streams", "3", "--frames", "3", "--device", "cpu",
                            "--backend", "bitsim"])
    out = capsys.readouterr().out
    assert rc == 0 and "0 mismatches" in out
    g = japi.get_graph("dvs_cnn_tcn_nano")
    rep = japi.silicon_report(g, v=0.5)
    assert (f"CUTIE @0.5V would run each sensor at "
            f"{rep.inf_per_s * g.passes_per_inference:.0f} frames/s, "
            f"{rep.energy_uj:.2f} uJ/classification") in out
