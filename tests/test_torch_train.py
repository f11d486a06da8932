"""`repro_torch.train` (QAT training) held against `repro.train` on the CPU.

Inputs are made with numpy from a seed; params and train states are the
reference's, handed across as numpy (`repro_torch.convert`), because
`jax.random` cannot be regenerated in PyTorch.  Float reductions run in
another order in XLA and in PyTorch, so gradients and updates are compared
at tolerances stated in each test's docstring; forward values of the
elementwise ternarizers are compared for equality.

Learned thresholds are compared at values drawn from [0.6, 0.9], not at the
0.5 they start from.  At t = 0.5 the lower edge of the reference's
threshold-surrogate window ``||x| - t| <= 0.5`` lies at x = 0, where it
multiplies by ``sign(x)``; pre-activations that are zero up to round-off
(sums of +-alpha that cancel) then take sign 0 or +-1 depending on the
summation order, and the threshold gradient of a layer moves by up to its
own size (cifar10_tnn_smoke, seed 0: 4-326 such elements per layer, all
within 2e-7 of zero).  The port computes the same surrogate (the STE tests
below hold it on inputs away from zero); the sensitivity is the
reference's and is recorded in ROADMAP.md, queue 3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.program import CutieProgram as ProgramJ
from repro.api.registry import get_graph as get_graph_j
from repro.core import ternary as JT
from repro.data.pipeline import pipeline_for_net as pipeline_j
from repro.optim import adamw as JO
from repro.train import cross_entropy as cross_entropy_j
from repro.train import evaluate as evaluate_j
from repro.train import init_train_state as init_train_state_j
from repro.train import make_qat_step as make_qat_step_j
from repro.train import schedules as JS
from repro_torch import convert
from repro_torch.api.program import CutieProgram
from repro_torch.api.registry import get_graph
from repro_torch.core import ternary as TT
from repro_torch.data.pipeline import pipeline_for_net
from repro_torch.launch import train as launch_train
from repro_torch.launch.ft import run_with_restarts
from repro_torch.models import cutie_net
from repro_torch.optim import adamw as TO
from repro_torch.train import (
    cross_entropy,
    evaluate,
    init_train_state,
    make_qat_step,
    schedules,
    train,
)
from repro_torch.tree import tree_leaves

QUIET = dict(log=lambda *_: None)


def _np_tree(x):
    """A reference tree (params, states, tables) as numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, x)


def _progs(net, per_channel=True):
    gj, gt = get_graph_j(net), get_graph(net)
    if per_channel:
        gj = dataclasses.replace(gj, qat_per_channel=True)
        gt = dataclasses.replace(gt, qat_per_channel=True)
    return ProgramJ(gj), CutieProgram(gt)


def _assert_close_tree(got_leaves, want_leaves, rtol, atol_frac):
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        w = np.asarray(w)
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"leaf {i} {w.shape}")


# ---------------------------------------------------------------------------
# the straight-through estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, (0, 1, 2), 0], ids=["all", "per_ocu", "axis0"])
def test_ste_weights_forward_and_vjp_equal_reference(axis):
    """Forward ``alpha * ternary(w)``: trits equal, alpha within rtol=1e-6
    (a float32 mean and sum in another order); the clip-STE VJP passes the
    cotangent through unchanged — equal."""
    rng = np.random.RandomState(3)
    w = rng.randn(3, 3, 8, 6).astype(np.float32) if axis != 0 else \
        rng.randn(24, 10).astype(np.float32)
    g = rng.randn(*w.shape).astype(np.float32)
    yj, vjp = jax.vjp(lambda v: JT.ste_ternary_weights(v, 0.7, axis), jnp.asarray(w))
    (dwj,) = vjp(jnp.asarray(g))
    wt = torch.tensor(w, requires_grad=True)
    yt = TT.ste_ternary_weights(wt, 0.7, axis)
    (dwt,) = torch.autograd.grad(yt, wt, torch.from_numpy(g))
    np.testing.assert_array_equal(np.sign(yt.detach().numpy()), np.sign(np.asarray(yj)))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(dwt.numpy(), np.asarray(dwj))


@pytest.mark.parametrize("kind", ["scalar", "per_channel", "python_float"])
def test_ste_acts_forward_and_vjp_equal_reference(kind):
    """Forward trits and ``dx`` equal (elementwise); the threshold's
    surrogate gradient within rtol=1e-5 (a float32 sum over up to 640
    terms).  A Python-float threshold takes no gradient."""
    rng = np.random.RandomState(5)
    x = (1.5 * rng.randn(4, 5, 4, 8)).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    t = {"scalar": np.float32(0.55), "per_channel": (0.4 + 0.3 * rng.rand(8)).astype(np.float32),
         "python_float": 0.6}[kind]
    xt = torch.tensor(x, requires_grad=True)
    if kind == "python_float":
        yj, vjp = jax.vjp(lambda v: JT.ste_ternary_acts(v, t), jnp.asarray(x))
        (dxj,) = vjp(jnp.asarray(g))
        yt = TT.ste_ternary_acts(xt, t)
        (dxt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    else:
        yj, vjp = jax.vjp(JT.ste_ternary_acts, jnp.asarray(x), jnp.asarray(t))
        dxj, dtj = vjp(jnp.asarray(g))
        tt = torch.tensor(t, requires_grad=True)
        yt = TT.ste_ternary_acts(xt, tt)
        dxt, dtt = torch.autograd.grad(yt, (xt, tt), torch.from_numpy(g))
        assert dtt.shape == tt.shape
        np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(dxt.numpy(), np.asarray(dxj))


def test_threshold_without_grad_and_clamp_band():
    """A tensor threshold that does not require grad takes none; the clamp
    keeps its gradient inside the band and zeroes it outside."""
    x = torch.randn(4, 6, requires_grad=True)
    t = torch.tensor(0.5)
    (dx,) = torch.autograd.grad(TT.ste_ternary_acts(x, t).sum(), x)
    assert dx.shape == x.shape and t.grad is None
    th = torch.tensor([0.3, 0.01, 5.0], requires_grad=True)
    (dth,) = torch.autograd.grad(TT.clamp_threshold(th).sum(), th)
    np.testing.assert_array_equal(dth.numpy(), [1.0, 0.0, 0.0])


def test_threshold_vjp_direction_as_reference():
    """The reference's direction check: raising t kills activations just
    above it, so for +0.6 at t = 0.5 d out / d t is negative."""
    x = torch.tensor([0.6, 2.0])
    t = torch.tensor(0.5, requires_grad=True)
    (dt,) = torch.autograd.grad(TT.ste_ternary_acts(x, t).sum(), t)
    assert float(dt) < 0


# ---------------------------------------------------------------------------
# one QAT step: loss and every gradient leaf
# ---------------------------------------------------------------------------

def _with_thresholds(params, learn, seed=11):
    """Learned thresholds drawn from [0.6, 0.9] (see the module docstring)."""
    if not learn:
        return params
    rng = np.random.RandomState(seed)
    params["thresh"] = {
        kind: [jnp.asarray(np.asarray(0.6 + 0.3 * rng.rand(*np.shape(t)), np.float32))
               for t in ts]
        for kind, ts in params["thresh"].items()
    }
    return params


@pytest.mark.parametrize("learn", [False, True, "per_channel"],
                         ids=["fixed", "learned", "per_channel"])
@pytest.mark.parametrize("net", ["cifar10_tnn_smoke", "dvs_cnn_tcn_nano"])
def test_one_qat_step_loss_and_grads_match_reference(net, learn):
    """From the reference's params: loss within rtol=1e-5, every gradient
    leaf within rtol=1e-4, atol=1e-6 * max|g_ref| of its leaf (float32
    convolutions, std and sums in another order)."""
    pj, pt = _progs(net)
    params = _with_thresholds(pj.init(jax.random.PRNGKey(0), learn_thresholds=learn), learn)
    x, y = pipeline_j(pj.graph, 4, seed=0).next_batch()
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: cross_entropy_j(pj.forward_qat(p, x), y)))(params)
    ptree = convert.params_from_reference(_np_tree(params), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(ptree)]
    loss_t = cross_entropy(pt.forward_qat(ptree, torch.from_numpy(np.array(x))),
                           torch.from_numpy(np.array(y)))
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    _assert_close_tree(grads_t, jax.tree_util.tree_leaves(grads_j), 1e-4, 1e-6)


@pytest.mark.parametrize("net", ["cifar10_tnn_smoke", "dvs_cnn_tcn_nano"])
def test_three_qat_steps_match_reference(net):
    """Three `make_qat_step` steps from the reference's state on the same
    batches: loss, accuracy, grad_norm and lr within rtol=1e-5 every step;
    params within rtol=1e-5 plus atol = 0.01 * lr * 3 (Adam's first updates
    are about lr * sign(g), so a gradient element within round-off of zero
    may move by a fraction of lr), moments within rtol=1e-4, atol=1e-6 *
    max of the leaf."""
    pj, pt = _progs(net)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
    state_j = init_train_state_j(pj, jax.random.PRNGKey(0))
    state_t = convert.train_state_from_reference(_np_tree(state_j), device="cpu")
    step_j = jax.jit(make_qat_step_j(pj, JO.AdamWConfig(**kw)))
    step_t = make_qat_step(pt, TO.AdamWConfig(**kw))
    pipe = pipeline_j(pj.graph, 4, seed=1)
    for i in range(3):
        batch = pipe.batch_at(i)
        state_j, m_j = step_j(state_j, batch)
        state_t, m_t = step_t(state_t, tuple(np.array(a) for a in batch))
        for key in ("loss", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(state_t["opt"].step) == int(state_j["opt"].step) == 3
    for got, want in zip(tree_leaves(state_t["params"]),
                         jax.tree_util.tree_leaves(state_j["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=0.01 * kw["lr"] * 3)
    for moment in ("m", "v"):
        _assert_close_tree(tree_leaves(getattr(state_t["opt"], moment)),
                           jax.tree_util.tree_leaves(getattr(state_j["opt"], moment)),
                           1e-4, 1e-6)


def test_qat_step_leaves_its_input_state_untouched():
    """The step is a function of its state: the given state's tensors keep
    their values, so a checkpoint taken before a step stays valid."""
    _, pt = _progs("cifar10_tnn_smoke")
    state = init_train_state(pt, torch.Generator().manual_seed(0), device="cpu")
    before = [t.clone() for t in tree_leaves(state)]
    step = make_qat_step(pt, TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4))
    new, metrics = step(state, pipeline_for_net(pt.graph, 4, seed=0).next_batch())
    assert set(metrics) == {"loss", "accuracy", "grad_norm", "lr"}
    for a, b in zip(before, tree_leaves(state)):
        assert torch.equal(a, b)
    assert not torch.equal(new["params"]["fc"]["w"], state["params"]["fc"]["w"])


# ---------------------------------------------------------------------------
# the optimizer and the schedules
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": rng.randn(3, 4), "b": rng.randn(5), "c": {"d": rng.randn(2, 2, 2)},
            "e": [rng.randn(4, 1)]}


@pytest.mark.parametrize("grad_clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(grad_clip):
    """Six `adamw_update` steps through warmup and the cosine tail, with
    and without clipping, decay only on ndim >= 2 leaves: params, moments,
    lr and grad_norm within rtol=1e-6 (atol 1e-7 for moments near 0)."""
    rng = np.random.RandomState(0)
    params = {k: v for k, v in _opt_tree(rng).items()}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
                  grad_clip=grad_clip, min_lr_frac=0.2)
    as_j = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731
    as_t = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32), t)
    pj, pt = as_j(params), as_t(params)
    sj, st = JO.adamw_init(pj), TO.adamw_init(pt)
    assert st.step.dtype == torch.int32 and st.step.ndim == 0
    for i in range(6):
        grads = _opt_tree(rng)
        pj, sj, info_j = JO.adamw_update(JO.AdamWConfig(**cfg_kw), pj, as_j(grads), sj)
        pt, st, info_t = TO.adamw_update(TO.AdamWConfig(**cfg_kw), pt, as_t(grads), st)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), rtol=1e-6)
        for got, want in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        for m in ("m", "v"):
            for got, want in zip(tree_leaves(getattr(st, m)),
                                 jax.tree_util.tree_leaves(getattr(sj, m))):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_adamw_decays_matrices_only_and_skips_frozen_leaves():
    """With zero gradients only weight decay moves a leaf: the ndim >= 2
    leaf shrinks, the vector stays, a uint8 leaf passes through with
    scalar zero moments (the reference's rules)."""
    params = {"w": torch.ones(2, 2), "b": torch.ones(3), "q": torch.ones(4, dtype=torch.uint8)}
    st = TO.adamw_init(params)
    assert st.m["q"].shape == () and st.m["w"].dtype == torch.float32
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = TO.adamw_update(TO.AdamWConfig(lr=0.1, warmup_steps=0), params, zeros, st)
    assert (new["w"] < 1).all() and torch.equal(new["b"], params["b"])
    assert torch.equal(new["q"], params["q"]) and new["q"].dtype == torch.uint8


def test_lr_schedule_matches_reference():
    """Warmup, cosine decay and the min_lr floor past total_steps, step by
    step: rtol=1e-6."""
    cfg_j = JO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    cfg_t = TO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        want = float(JO.lr_schedule(cfg_j, jnp.asarray(s, jnp.int32)))
        got = float(TO.lr_schedule(cfg_t, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestSchedules:
    """The reference's schedule cases, and both packages' segments equal."""

    def test_piecewise_lookup_and_segments(self):
        s = schedules.PiecewiseConstant(boundaries=(10, 20), values=(0.4, 0.6, 0.7))
        assert s(0) == 0.4 and s(9) == 0.4
        assert s(10) == 0.6 and s(19) == 0.6
        assert s(20) == 0.7 and s(10**6) == 0.7
        assert s.final == 0.7
        assert s.segments(25) == [(0, 10, 0.4), (10, 20, 0.6), (20, 25, 0.7)]
        assert s.segments(15) == [(0, 10, 0.4), (10, 15, 0.6)]

    def test_anneal_reaches_target(self):
        s = schedules.anneal(0.7, 100)
        assert s(0) == pytest.approx(0.7 * 0.6)
        assert s(99) == pytest.approx(0.7)
        assert s.final == pytest.approx(0.7)
        vals = [s(i) for i in range(100)]
        assert vals == sorted(vals), "anneal must be monotone"

    def test_merged_segments_cover_and_align(self):
        a = schedules.PiecewiseConstant(boundaries=(10,), values=(1.0, 2.0))
        b = schedules.PiecewiseConstant(boundaries=(15,), values=(5.0, 6.0))
        assert schedules.merged_segments(20, a, b) == [
            (0, 10, (1.0, 5.0)), (10, 15, (2.0, 5.0)), (15, 20, (2.0, 6.0)),
        ]

    def test_resolve_specs(self):
        assert schedules.resolve("const", 0.7, 10).final == 0.7
        assert schedules.resolve("0.55", 0.7, 10)(3) == 0.55
        assert schedules.resolve("anneal", 0.7, 10).final == pytest.approx(0.7)
        with pytest.raises(ValueError):
            schedules.resolve("bogus", 0.7, 10)

    @pytest.mark.parametrize("total", [7, 100, 1000])
    def test_merged_segments_equal_reference(self, total):
        got = schedules.merged_segments(
            total, schedules.anneal(0.7, total), schedules.anneal(0.5, total, start_frac=0.6))
        want = JS.merged_segments(
            total, JS.anneal(0.7, total), JS.anneal(0.5, total, start_frac=0.6))
        assert got == want


# ---------------------------------------------------------------------------
# restarts, train(), evaluate
# ---------------------------------------------------------------------------

def test_run_with_restarts_after_a_fault_equals_an_uninterrupted_run(tmp_path):
    """A fault at step 5 restores the step-4 checkpoint and replays steps
    4..: the committed losses and the final params are identical to an
    uninterrupted run (exactly-once data through the pipeline cursor)."""
    _, pt = _progs("cifar10_tnn_smoke")
    cfg = TO.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=8, weight_decay=0.0)
    init = lambda: init_train_state(pt, torch.Generator().manual_seed(2), device="cpu")  # noqa: E731

    def run(ckpt, injector=None):
        step = make_qat_step(pt, cfg)
        return run_with_restarts(lambda: step, init, pipeline_for_net(pt.graph, 4, seed=3),
                                 ckpt_dir=ckpt, n_steps=8, ckpt_every=4,
                                 fault_injector=injector, **QUIET)

    crashed = []

    def injector(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    clean, hist_clean = run(tmp_path / "a")
    faulty, hist = run(tmp_path / "b", injector)
    assert hist["restarts"] == 1 and hist["resumed_from"] == [4]
    assert hist["losses"][:5] + hist["losses"][6:] == hist_clean["losses"][:5] + \
        hist_clean["losses"][5:]
    assert hist["losses"][-4:] == hist_clean["losses"][-4:]
    for a, b in zip(tree_leaves(faulty), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_resume_is_bit_identical(tmp_path):
    """Train 8 steps straight vs 4 + restore + 4: identical losses on the
    overlap and bit-identical params (the reference's contract)."""
    kw = dict(steps=8, batch=8, lr=1e-3, seed=3, ckpt_every=4, eval_batches=1,
              device="cpu", **QUIET)
    full = train("cifar10_tnn_smoke", ckpt_dir=tmp_path / "a", **kw)
    half = train("cifar10_tnn_smoke", ckpt_dir=tmp_path / "b", **{**kw, "steps": 4})
    resumed = train("cifar10_tnn_smoke", ckpt_dir=tmp_path / "b", **kw)
    assert half.losses == full.losses[:4]
    assert resumed.losses == full.losses[4:]
    for got, want in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(got, want)


def test_train_resume_at_completion_is_graceful(tmp_path):
    kw = dict(steps=4, batch=8, lr=1e-3, seed=1, ckpt_every=2, eval_batches=1,
              device="cpu", **QUIET)
    first = train("cifar10_tnn_smoke", ckpt_dir=tmp_path, **kw)
    again = train("cifar10_tnn_smoke", ckpt_dir=tmp_path, **kw)
    assert len(first.losses) == 4 and again.losses == []
    assert again.loss_decreased
    assert "no new steps" in again.summary()
    assert again.gate(gap_bound=1.0) == []


def test_train_end_to_end_decreases_loss(tmp_path):
    rep = train("cifar10_tnn_smoke", steps=60, batch=32, lr=3e-3, ckpt_dir=tmp_path,
                ckpt_every=30, eval_batches=2, device="cpu", **QUIET)
    assert rep.loss_decreased and len(rep.losses) == 60
    e = rep.final_eval
    assert 0.0 <= e.qat_accuracy <= 1.0 and 0.0 <= e.deployed_accuracy <= 1.0
    assert e.backend == "fused"
    assert rep.deployed.device == torch.device("cpu")
    assert rep.deployed.silicon_report().ideal.energy_j > 0
    assert rep.summary()


def test_train_segments_with_learned_thresholds_and_anneal(tmp_path):
    """The segmented path: an annealed nu gives several segments with an
    eval at each inner boundary; learned per-channel thresholds come back
    in the report and fold into the tables."""
    rep = train("cifar10_tnn_smoke", steps=8, batch=8, lr=3e-3, ckpt_dir=tmp_path,
                ckpt_every=4, eval_batches=2, nu_schedule="anneal",
                thresholds="learned", device="cpu", **QUIET)
    assert len(rep.losses) == 8 and rep.evals and all(s < 8 for s, _ in rep.evals)
    assert rep.learned_thresholds is not None
    assert len(rep.learned_thresholds["conv"]) == len(rep.deployed.tables["conv"])


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train("cifar10_tnn_smoke", steps=1, **QUIET)


def test_evaluate_on_handed_tables_gives_reference_hits():
    """`evaluate` on the reference's own deploy tables and params: the
    same QAT and deployed hit counts on the same held-out batches, and the
    training cursor untouched."""
    pj, pt = _progs("cifar10_tnn_smoke")
    params = pj.init(jax.random.PRNGKey(4))
    pipe_j = pipeline_j(pj.graph, 16, seed=2)
    dep_j = pj.quantize(params, calib=pipe_j.batch_at(0)[0])
    want = evaluate_j(pj, params, pipe_j, deployed=dep_j, n_batches=2)
    pipe_t = pipeline_for_net(pt.graph, 16, seed=2)
    dep_t = convert.deployed_from_reference_tables(
        pt.graph, _np_tree(dep_j.tables), device="cpu")
    got = evaluate(pt, convert.params_from_reference(_np_tree(params), device="cpu"),
                   pipe_t, deployed=dep_t, n_batches=2)
    assert pipe_t.state.step == 0
    assert (got.n_examples, got.backend) == (want.n_examples, "fused")
    assert got.qat_accuracy == want.qat_accuracy
    assert got.deployed_accuracy == want.deployed_accuracy


# ---------------------------------------------------------------------------
# the legacy shim and the launcher
# ---------------------------------------------------------------------------

def test_cutie_net_shim_matches_program():
    """The legacy surface builds the registry's CIFAR graph and runs the
    program's QAT and deploy paths (equal outputs)."""
    cfg = dataclasses.replace(cutie_net.CIFAR_TNN, channels=8, input_hw=(16, 16))
    params = cutie_net.init_cutie_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.sign(np.random.RandomState(0).randn(2, 16, 16, 3)).astype(np.float32))
    prog = CutieProgram(cutie_net._graph(cfg))
    assert torch.equal(cutie_net.cnn_forward_qat(params, cfg, x), prog.forward_qat(params, x))
    dep = cutie_net.quantize_for_deploy(params, cfg, calib=x)
    assert torch.equal(cutie_net.cnn_forward_deploy(dep, cfg, x),
                       prog.quantize(params, calib=x).forward(x, backend="fused"))
    ring = cutie_net.make_stream(cutie_net.DVS_CNN_TCN, batch=2, device="cpu")
    assert tuple(ring.buf.shape) == (2, 24, 96)


def test_launcher_runs_on_cpu_and_writes_a_trace(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --steps 20`` exits
    cleanly; its ``--trace`` document nests properly and holds the loop's
    spans."""
    from repro_torch.obs import load, validate_nesting

    trace = tmp_path / "t.json"
    report = launch_train.main(["--net", "cifar10_tnn_smoke", "--steps", "20",
                                "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                                "--eval-batches", "1", "--trace", str(trace)])
    assert len(report.losses) == 20
    doc = load(str(trace))
    assert validate_nesting(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"train.segment", "train.steps", "train.quantize", "train.eval"} <= names
    assert launch_train.SMOKE_GAP_BOUND == 0.15
    assert launch_train.smoke_recipe("dvs_cnn_tcn") == {"steps": 100, "lr": 5e-3, "batch": 8}
