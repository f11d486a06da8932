"""`repro_torch.api` held against `repro.api` on the CPU, small registry nets.

The deploy path is compared on the reference's OWN tables: the reference
quantizes (with and without calibration), its tables are handed across as
numpy through `repro_torch.convert`, and the port's logits must be
**equal** to the reference's — batch forward and frame-by-frame stream,
``fused`` and ``ref`` backends (the temporal nets, with clips longer than the
ring, are in tests/test_torch_program_temporal.py).  Every
inter-layer tensor of these nets is ternary or dyadic, so all sums are exact
in float32 and equality is the contract, not a tolerance.

`quantize` itself re-derives order-dependent float reductions (the TWN
threshold mean, alpha, the calibration std), so it is compared at stated
tolerances from handed-over params: packed bytes equal (any trit within one
ulp of its threshold would be named — none on these seeds), scales
``rtol=1e-6``, ``bn_sd`` ``rtol=1e-4`` (a population std over up to ~10^5
float32 values, computed two-pass by XLA and by Welford in PyTorch).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api.program import _ring_window, effective_scale

SPATIAL_NETS = ["cifar10_tnn_smoke", "cifar10_tnn_wide_smoke"]


def _tree_np(x):
    """The reference's params/tables as numpy (arrays) and Python scalars."""
    if isinstance(x, dict):
        return {k: _tree_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree_np(v) for v in x]
    return np.array(x) if hasattr(x, "shape") else x


def _inputs(graph, seed, batch=2, frames=None):
    """Seeded numpy inputs: 0/1 event frames (temporal, multi-channel),
    trits otherwise — what the registry's pipelines produce."""
    rng = np.random.RandomState(seed)
    h, w = graph.input_hw
    if graph.is_temporal:
        shape = (batch, frames, h, w, graph.input_ch)
        if graph.input_ch == 2:
            return (rng.rand(*shape) < 0.05).astype(np.float32)
        return rng.randint(-1, 2, shape).astype(np.float32)
    return rng.randint(-1, 2, (batch, h, w, graph.input_ch)).astype(np.float32)


def _reference(name, calibrated, frames=None, seed=0):
    prog = japi.get_net(name)
    params = prog.init(jax.random.PRNGKey(seed))
    x = _inputs(prog.graph, seed + 1, frames=frames)
    dep = prog.quantize(params, calib=jnp.asarray(x) if calibrated else None)
    return prog, params, dep, x


def _port_of(name, dep):
    return convert.deployed_from_reference_tables(name, _tree_np(dep.tables), device="cpu")


def _exact(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want))


@pytest.mark.parametrize("calibrated", [True, False], ids=["calib", "fan_in"])
@pytest.mark.parametrize("name", SPATIAL_NETS)
def test_spatial_nets_logits_equal_reference(name, calibrated):
    _, _, dep, x = _reference(name, calibrated)
    port = _port_of(name, dep)
    assert port.device == torch.device("cpu")
    want = dep.forward(jnp.asarray(x), backend="fused")
    fused = port.forward(torch.from_numpy(x), backend="fused")
    ref = port.forward(torch.from_numpy(x), backend="ref")
    assert fused.dtype == torch.float32
    _exact(fused, want)
    _exact(ref, dep.forward(jnp.asarray(x), backend="ref"))
    _exact(fused, ref)


def test_effective_scale_both_folds_equal_reference():
    """THE fold: bn_sd form and the fan-in form (padded C_in for conv,
    unpadded taps*C for TCN), same float32 values as the reference."""
    from repro.api.program import effective_scale as eff_j

    rng = np.random.RandomState(2)
    scale = (np.abs(rng.randn(12)) + 0.1).astype(np.float32)
    sd = (np.abs(rng.randn(12)) + 0.01).astype(np.float32)
    for fan_in in (36, 27, 3 * 9, 9 * 96, 25 * 4):
        _exact(effective_scale({"scale": torch.from_numpy(scale)}, fan_in),
               eff_j({"scale": jnp.asarray(scale)}, fan_in))
    _exact(effective_scale({"scale": torch.from_numpy(scale),
                            "bn_sd": torch.from_numpy(sd)}, 36),
           eff_j({"scale": jnp.asarray(scale), "bn_sd": jnp.asarray(sd)}, 36))


@pytest.mark.parametrize("name", ["cifar10_tnn_smoke", "dvs_cnn_tcn_smoke", "kws_tcn_smoke"])
def test_quantize_from_handed_over_params(name):
    prog_j, params, dep, x = _reference(
        name, True, frames=japi.get_graph(name).tcn_steps if name != "cifar10_tnn_smoke" else None)
    prog_t = tapi.get_net(name)
    params_t = convert.params_from_reference(_tree_np(params), device="cpu")
    port = prog_t.quantize(params_t, calib=torch.from_numpy(x))
    for kind in ("conv", "tcn"):
        assert len(port.tables[kind]) == len(dep.tables[kind])
        for mine, theirs in zip(port.tables[kind], dep.tables[kind]):
            assert set(mine) == set(theirs)
            differ = np.argwhere(mine["packed"].numpy() != np.asarray(theirs["packed"]))
            assert differ.size == 0, f"{name} {kind}: packed bytes differ at {differ[:4]}"
            np.testing.assert_allclose(mine["scale"].numpy(), np.asarray(theirs["scale"]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(mine["bn_sd"].numpy(), np.asarray(theirs["bn_sd"]),
                                       rtol=1e-4, atol=1e-7)
            assert mine["threshold"] == theirs["threshold"]
            assert mine.get("pool") == theirs.get("pool")
            assert mine.get("dilation") == theirs.get("dilation")
    _exact(port.tables["fc"]["t"], dep.tables["fc"]["t"])
    np.testing.assert_allclose(port.tables["fc"]["scale"].numpy(),
                               np.asarray(dep.tables["fc"]["scale"]), rtol=1e-6, atol=0)
    # and the QAT forward values agree to float round-off on the calib batch
    got = prog_t.forward_qat(params_t, torch.from_numpy(x))
    want = np.asarray(prog_j.forward_qat(params, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_learned_per_channel_thresholds_fold_into_tables_and_run():
    """init(learn_thresholds="per_channel") -> quantize folds the clamped
    [c_out] vectors; fused == ref with per-channel comparator constants, and
    the reference agrees on the carried-over tables."""
    name = "dvs_cnn_tcn_nano"
    prog_j = japi.get_net(name)
    params = prog_j.init(jax.random.PRNGKey(3), learn_thresholds="per_channel")
    rng = np.random.RandomState(4)
    for kind in ("conv", "tcn"):
        params["thresh"][kind] = [
            jnp.asarray(rng.uniform(0.0, 1.2, t.shape).astype(np.float32))
            for t in params["thresh"][kind]
        ]
    x = _inputs(prog_j.graph, 5, frames=5)
    dep = prog_j.quantize(params, calib=jnp.asarray(x))
    port = _port_of(name, dep)
    want = dep.forward(jnp.asarray(x), backend="fused")
    _exact(port.forward(torch.from_numpy(x), backend="fused"), want)
    _exact(port.forward(torch.from_numpy(x), backend="ref"), want)
    # the port's own fold of the same learned values
    mine = tapi.get_net(name).quantize(
        convert.params_from_reference(_tree_np(params), device="cpu"))
    for kind in ("conv", "tcn"):
        for a, b in zip(mine.tables[kind], dep.tables[kind]):
            _exact(a["threshold"], b["threshold"])


def test_init_shapes_std_and_determinism():
    prog = tapi.get_net("dvs_cnn_tcn_smoke")
    ref_params = japi.get_net("dvs_cnn_tcn_smoke").init(jax.random.PRNGKey(0))
    p1 = prog.init(torch.Generator().manual_seed(7), device="cpu")
    p2 = prog.init(torch.Generator().manual_seed(7), device="cpu")
    for kind in ("conv", "tcn"):
        for a, b, r in zip(p1[kind], p2[kind], ref_params[kind]):
            assert tuple(a["w"].shape) == tuple(r["w"].shape)
            assert torch.equal(a["w"], b["w"])
    assert tuple(p1["fc"]["w"].shape) == tuple(ref_params["fc"]["w"].shape)
    wide = tapi.get_net("dvs_cnn_tcn").init(torch.Generator().manual_seed(0), device="cpu")
    w = wide["conv"][3]["w"]   # [3, 3, 96, 96]: std (2 / (9*96)) ** 0.5
    assert float(w.std()) == pytest.approx((2.0 / (9 * 96)) ** 0.5, rel=0.05)
    assert float(wide["fc"]["w"].std()) == pytest.approx(0.05, rel=0.1)
    th = prog.init(torch.Generator().manual_seed(0), learn_thresholds=True, device="cpu")
    assert th["thresh"]["conv"][0].ndim == 0 and float(th["thresh"]["tcn"][0]) == 0.5
    with pytest.raises(ValueError, match="learn_thresholds"):
        prog.init(torch.Generator().manual_seed(0), learn_thresholds="nope", device="cpu")


def test_port_end_to_end_fused_equals_ref_and_stream_equals_batch():
    """The port on its own: init -> quantize(calib) -> forward; no reference."""
    prog = tapi.get_net("dvs_cnn_tcn_micro")
    x = torch.from_numpy(_inputs(prog.graph, 9, frames=8))
    dep = prog.quantize(prog.init(torch.Generator().manual_seed(1), device="cpu"), calib=x)
    fused = dep.forward(x, backend="fused")
    assert torch.isfinite(fused).all() and tuple(fused.shape) == (2, prog.graph.n_classes)
    assert torch.equal(fused, dep.forward(x, backend="ref"))
    session = dep.stream(batch=2)
    for t in range(x.shape[1]):
        logits = session.step(x[:, t])
    assert torch.equal(logits, fused)
    session.reset()
    assert session.steps_seen == 0 and float(session.state.ring.buf.abs().sum()) == 0.0


def test_ring_window_matches_reference():
    from repro.api.program import _ring_window as ring_j

    f = np.random.RandomState(0).randn(2, 5, 3).astype(np.float32)
    for steps in (3, 5, 8):
        _exact(_ring_window(torch.from_numpy(f), steps), ring_j(jnp.asarray(f), steps))


def test_registry_and_graphs_match_reference():
    # the reference's registry is process-global and other test files register
    # scratch nets into it, so hold the port to the seeded names
    assert tapi.list_nets() == sorted([
        "cifar10_tnn", "cifar10_tnn_smoke", "cifar10_tnn_wide", "cifar10_tnn_wide_smoke",
        "cutie_cifar10", "cutie_dvs", "dvs_cnn_tcn", "dvs_cnn_tcn_micro",
        "dvs_cnn_tcn_nano", "dvs_cnn_tcn_smoke", "kws_tcn", "kws_tcn_smoke",
    ])
    assert set(tapi.list_nets()) <= set(japi.list_nets())
    for name in tapi.list_nets():
        gt, gj = tapi.get_graph(name), japi.get_graph(name)
        assert gt.name == gj.name and gt.conv_pool_plan() == gj.conv_pool_plan()
        assert [tuple(vars(l).values()) for l in gt.layers] == \
               [tuple(vars(l).values()) for l in gj.layers]
        for field in ("input_hw", "input_ch", "n_classes", "tcn_steps", "act_threshold",
                      "weight_nu", "passes_per_inference", "paper_energy_uj",
                      "paper_inf_per_s"):
            assert getattr(gt, field) == getattr(gj, field), (name, field)
    with pytest.raises(KeyError, match="unknown net"):
        tapi.get_net("nope")


def test_backends_and_entry_point_errors():
    assert tapi.BACKENDS == ("fused", "kernel", "ref", "bitsim")
    for backend in tapi.BACKENDS:
        tapi.check_backend(backend)
    for reference_only in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="not available in repro_torch"):
            tapi.check_backend(reference_only)
    with pytest.raises(ValueError, match="called 'kernel' here"):
        tapi.check_backend("pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.check_backend("cuda")
    prog = tapi.get_net("cifar10_tnn_smoke")
    dep = prog.quantize(prog.init(torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="no TCN memory to stream"):
        dep.stream()
    with pytest.raises(ValueError, match="no TCN memory to pool"):
        dep.serve(2)
    with pytest.raises(ValueError, match="unknown backend"):
        dep.forward(torch.zeros(1, 16, 16, 3), backend="bogus")
    with pytest.raises(ValueError, match="unknown deploy-table key"):
        convert.deployed_from_reference_tables(
            "cifar10_tnn_smoke", {"conv": [{"bogus": 1}], "tcn": [], "fc": {}}, device="cpu")


def test_cuda_is_never_silently_replaced_by_the_cpu():
    """device="cuda" (the default of every entry point) on a host without a
    CUDA device raises; nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal cannot be shown")
    from repro_torch import resolve_device

    prog = tapi.get_net("dvs_cnn_tcn_nano")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        prog.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        convert.deployed_from_reference_tables(
            "dvs_cnn_tcn_nano", {"conv": [], "tcn": [], "fc": {}})
    assert resolve_device("cpu") == torch.device("cpu")
