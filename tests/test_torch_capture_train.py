"""The QAT train step and the eval forwards as the port captures them, on
the CPU: `make_qat_step(..., donate=True)` (the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``) and the generalised
`repro_torch.capture.CapturedStep` that `train` and `evaluate` wrap them in.

On the CPU a `CapturedStep` runs its function eagerly over the same static
arguments it would capture on the card, so what these tests pin is the
capture's precondition: the donated step writes its state in place, bit for
bit as the undonated one computes it, every state tensor keeps its address,
and the step makes no host sync and no tensor from Python data (either
would be a host round trip, or a capture failure, on the card).  Tolerances
against the reference are those of `test_torch_train.py`'s three-step test;
everything within the port is compared bit for bit.  The ``gpu``-marked
test at the end repeats captured == eager on the card.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.api.program import CutieProgram as ProgramJ
from repro.api.registry import get_graph as get_graph_j
from repro.data.pipeline import pipeline_for_net as pipeline_j
from repro.optim import adamw as JO
from repro.train import init_train_state as init_train_state_j
from repro.train import make_qat_step as make_qat_step_j
from repro_torch import convert
from repro_torch.api.program import CutieProgram
from repro_torch.api.registry import get_graph
from repro_torch.capture import CapturedStep
from repro_torch.data.pipeline import pipeline_for_net
from repro_torch.kernels.ref import deterministic_float32
from repro_torch.launch.ft import run_with_restarts
from repro_torch.optim import adamw as TO
from repro_torch.train import init_train_state, make_qat_step, train
from repro_torch.train.evaluate import evaluate
from repro_torch.tree import tree_leaves, tree_map

QUIET = dict(log=lambda *_: None)
NETS = ["cifar10_tnn_smoke", "dvs_cnn_tcn_nano"]
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)


def _prog(net):
    return CutieProgram(dataclasses.replace(get_graph(net), qat_per_channel=True))


def _state(prog, learn=False, seed=0):
    return init_train_state(prog, torch.Generator().manual_seed(seed),
                            learn_thresholds=learn, device="cpu")


def _batches(prog, n, seed=1, batch=2):
    pipe = pipeline_for_net(prog.graph, batch, seed=seed)
    return [tuple(torch.from_numpy(a) for a in pipe.batch_at(i)) for i in range(n)]


def _clone(tree):
    return tree_map(torch.clone, tree)


class HostSyncs(TorchDispatchMode):
    """Records every op that reads a tensor on the host
    (``aten._local_scalar_dense``) or makes one from Python data
    (``aten.lift_fresh``: a host-to-device copy on the card)."""

    BAD = ("_local_scalar_dense", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name.startswith(self.BAD):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# the donated step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learned"])
@pytest.mark.parametrize("net", NETS)
def test_donated_qat_step_equals_undonated_bit_for_bit(net, learn):
    """Three steps (two of the temporal net): loss, every metric, params,
    m, v and the step counter."""
    prog = _prog(net)
    plain = make_qat_step(prog, TO.AdamWConfig(**OPT))
    donated = make_qat_step(prog, TO.AdamWConfig(**OPT), donate=True)
    a = _state(prog, learn)
    b = _clone(a)
    n = 2 if prog.graph.is_temporal else 3
    for i, batch in enumerate(_batches(prog, n)):
        a, ma = plain(a, batch)
        b, mb = donated(b, batch)
        assert set(ma) == set(mb) == {"loss", "accuracy", "grad_norm", "lr"}
        for key in ma:
            assert torch.equal(ma[key], mb[key]), (i, key)
    assert int(b["opt"].step) == n
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learned"])
def test_donated_qat_state_keeps_its_addresses(learn):
    """The capture's precondition: the returned state holds the given
    tensors, and no leaf (params, m, v, the int32 step) moves."""
    prog = _prog("cifar10_tnn_smoke")
    step = make_qat_step(prog, TO.AdamWConfig(**OPT), donate=True)
    state = _state(prog, learn)
    leaves = tree_leaves(state)
    ptrs = [x.data_ptr() for x in leaves]
    for batch in _batches(prog, 3):
        state, _ = step(state, batch)
        assert all(x is y for x, y in zip(tree_leaves(state), leaves))
        assert [x.data_ptr() for x in tree_leaves(state)] == ptrs


@pytest.mark.parametrize("net", ["cifar10_tnn_smoke"])
def test_donated_qat_step_matches_reference_jitted_donated_step(net):
    """The port's donated step against ``jax.jit(step, donate_argnums=(0,))``
    from the reference's state on the same batches, at
    `test_three_qat_steps_match_reference`'s tolerances: metrics within
    rtol=1e-5, params rtol=1e-5 + atol 0.01 * lr * 3, moments rtol=1e-4 and
    atol=1e-6 * max of the leaf."""
    gj = dataclasses.replace(get_graph_j(net), qat_per_channel=True)
    pj, pt = ProgramJ(gj), _prog(net)
    state_j = init_train_state_j(pj, jax.random.PRNGKey(0))
    state_t = convert.train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, state_j), device="cpu")
    step_j = jax.jit(make_qat_step_j(pj, JO.AdamWConfig(**OPT)), donate_argnums=(0,))
    step_t = make_qat_step(pt, TO.AdamWConfig(**OPT), donate=True)
    pipe = pipeline_j(pj.graph, 4, seed=1)
    for i in range(3):
        batch = pipe.batch_at(i)
        state_j, m_j = step_j(state_j, batch)
        state_t, m_t = step_t(state_t, tuple(torch.from_numpy(np.array(a)) for a in batch))
        for key in ("loss", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(state_t["opt"].step) == int(state_j["opt"].step) == 3
    for got, want in zip(tree_leaves(state_t["params"]),
                         jax.tree_util.tree_leaves(state_j["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=0.01 * OPT["lr"] * 3)
    for moment in ("m", "v"):
        for got, want in zip(tree_leaves(getattr(state_t["opt"], moment)),
                             jax.tree_util.tree_leaves(getattr(state_j["opt"], moment))):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-6 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learned"])
@pytest.mark.parametrize("net", NETS)
def test_warm_donated_qat_step_makes_no_host_sync(net, learn):
    """The second call of the donated step (the one the card captures, after
    an eager warm-up) reads nothing on the host and makes no tensor from
    Python data."""
    prog = _prog(net)
    step = make_qat_step(prog, TO.AdamWConfig(**OPT), donate=True)
    state = _state(prog, learn)
    b0, b1 = _batches(prog, 2)
    state, _ = step(state, b0)
    with HostSyncs() as mode:
        step(state, b1)
    assert mode.seen == []


@pytest.mark.parametrize("net", NETS)
def test_eval_forwards_make_no_host_sync(net):
    """The two forwards `evaluate` captures: the QAT forward and the
    deployed forward on ``fused`` (K1's plain version here)."""
    prog = _prog(net)
    params = _state(prog)["params"]
    (x, _), = _batches(prog, 1)
    deployed = prog.quantize(params, calib=x)
    with torch.no_grad():
        for fwd in (lambda: prog.forward_qat(params, x),
                    lambda: deployed.forward(x, backend="fused")):
            fwd()
            with HostSyncs() as mode:
                fwd()
            assert mode.seen == []


# ---------------------------------------------------------------------------
# CapturedStep off the card
# ---------------------------------------------------------------------------

def test_captured_step_on_the_cpu_runs_eagerly_with_tree_outputs():
    """Held arguments are adopted (the state comes back as the same
    tensors), inputs are copied into the step's own buffers (the caller's
    tensor may change afterwards), a tree comes back, ``builds`` is 1."""
    calls = []

    def fn(state, x):
        calls.append(x)
        state["acc"].add_(x.sum())
        return state, {"out": x * 2, "acc": state["acc"] + 0}

    step = CapturedStep(fn, "cpu", inputs=(1,))
    state = {"acc": torch.zeros(())}
    x = torch.arange(3.0)
    s1, m1 = step(state, x)
    x.fill_(10.0)       # the caller reuses its tensor
    s2, m2 = step(state, np.arange(3, dtype=np.float32))
    assert s1["acc"] is s2["acc"] is state["acc"] and float(state["acc"]) == 6.0
    assert calls[0] is calls[1] and calls[0] is not x   # one static input
    assert torch.equal(m1["out"], torch.tensor([0.0, 2.0, 4.0]))
    assert float(m1["acc"]) == 3.0 and float(m2["acc"]) == 6.0
    assert step.builds == 1 and not step.captured


def test_captured_step_copies_other_held_tensors_in_and_refuses_new_shapes():
    """A held argument given as other tensors (a restored checkpoint, a new
    prefill's cache) is copied into the adopted ones bit for bit; a shape or
    dtype the step was not built for raises."""
    step = CapturedStep(lambda s, x: (s, s["w"] @ x), "cpu", inputs=(1,))
    held = {"w": torch.randn(3, 3, generator=torch.Generator().manual_seed(0))}
    step(held, torch.ones(3))
    other = {"w": torch.randn(3, 3, generator=torch.Generator().manual_seed(1))}
    s, y = step(other, torch.ones(3))
    assert s["w"] is held["w"] and torch.equal(held["w"], other["w"])
    assert torch.equal(y, other["w"] @ torch.ones(3))
    with pytest.raises(ValueError, match="built for"):
        step(held, torch.ones(4))
    with pytest.raises(ValueError, match="built for"):
        step(held, torch.ones(3, dtype=torch.float64))
    with pytest.raises(TypeError, match="takes 2 arguments"):
        step(held)


def test_captured_donated_steps_equal_the_undonated_step_on_the_cpu():
    """`train`'s wrapping — `CapturedStep(make_qat_step(..., donate=True),
    inputs=(1,))` fed numpy batches — gives the undonated step's bits."""
    prog = _prog("cifar10_tnn_smoke")
    plain = make_qat_step(prog, TO.AdamWConfig(**OPT))
    step = CapturedStep(make_qat_step(prog, TO.AdamWConfig(**OPT), donate=True), "cpu",
                        inputs=(1,))
    a = _state(prog)
    b = _clone(a)
    pipe = pipeline_for_net(prog.graph, 4, seed=1)
    for i in range(3):
        batch = pipe.batch_at(i)
        a, ma = plain(a, tuple(torch.from_numpy(v) for v in batch))
        b, mb = step(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# restarts, resume, segments
# ---------------------------------------------------------------------------

def test_fault_restart_through_the_captured_step_equals_an_uninterrupted_run(tmp_path):
    """A fault at step 5 restores the step-4 checkpoint: the restore hands
    the captured step new tensors, which it copies into its state.  The
    committed losses and final params equal an uninterrupted run of the
    plain undonated step, bit for bit."""
    prog = _prog("cifar10_tnn_smoke")
    cfg = TO.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=8, weight_decay=0.0)
    init = lambda: _state(prog, seed=2)  # noqa: E731

    def run(ckpt, step, injector=None):
        return run_with_restarts(lambda: step, init, pipeline_for_net(prog.graph, 4, seed=3),
                                 ckpt_dir=ckpt, n_steps=8, ckpt_every=4,
                                 fault_injector=injector, **QUIET)

    crashed = []

    def injector(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    clean, hist_clean = run(tmp_path / "a", make_qat_step(prog, cfg))
    captured = CapturedStep(make_qat_step(prog, cfg, donate=True), "cpu", inputs=(1,))
    faulty, hist = run(tmp_path / "b", captured, injector)
    assert hist["restarts"] == 1 and hist["resumed_from"] == [4]
    assert hist["losses"][:5] + hist["losses"][6:] == hist_clean["losses"]
    assert captured.builds == 1
    for a, b in zip(tree_leaves(faulty), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_builds_one_step_per_segment(tmp_path):
    """An annealed, learned-threshold run has several schedule segments:
    one step build each, as the reference re-jits per segment."""
    from repro_torch.train import schedules

    rep = train("cifar10_tnn_smoke", steps=6, batch=4, lr=1e-3, seed=0, ckpt_dir=tmp_path,
                ckpt_every=3, eval_batches=1, nu_schedule="anneal", thresholds="learned",
                device="cpu", **QUIET)
    segs = schedules.merged_segments(
        6, schedules.resolve("anneal", get_graph("cifar10_tnn_smoke").weight_nu, 6),
        schedules.constant(get_graph("cifar10_tnn_smoke").act_threshold))
    assert len(segs) > 1 and rep.step_builds == len(segs)
    assert len(rep.losses) == 6 and all(np.isfinite(rep.losses))


def test_evaluate_through_captured_forwards_equals_the_plain_forwards():
    """`evaluate`'s hits equal those of the plain forwards on its batches."""
    from repro_torch.train.evaluate import eval_batches

    prog = _prog("cifar10_tnn_smoke")
    params = _state(prog)["params"]
    pipe = pipeline_for_net(prog.graph, 8, seed=0)
    rep = evaluate(prog, params, pipe, n_batches=2)
    batches = eval_batches(pipe, 2)
    deployed = prog.quantize(params, calib=torch.from_numpy(batches[0][0]))
    hq = hd = n = 0
    with torch.no_grad():
        for x, y in batches:
            xt = torch.from_numpy(x)
            hq += int((prog.forward_qat(params, xt).argmax(-1).numpy() == y).sum())
            hd += int((deployed.forward(xt, backend="fused").argmax(-1).numpy() == y).sum())
            n += len(y)
    assert (rep.qat_accuracy, rep.deployed_accuracy, rep.n_examples) == (hq / n, hd / n, n)


# ---------------------------------------------------------------------------
# on the card: the captured step == the eager step
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learned"])
def test_captured_qat_step_equals_eager_step_on_the_card(learn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph")
    prog = _prog("cifar10_tnn_smoke")
    a = init_train_state(prog, torch.Generator().manual_seed(0), learn_thresholds=learn,
                         device="cuda")
    b = _clone(a)
    plain = make_qat_step(prog, TO.AdamWConfig(**OPT))
    step = CapturedStep(make_qat_step(prog, TO.AdamWConfig(**OPT), donate=True), "cuda",
                        inputs=(1,))
    pipe = pipeline_for_net(prog.graph, 4, seed=1)
    for i in range(4):
        batch = pipe.batch_at(i)
        a, ma = plain(a, tuple(torch.from_numpy(v).cuda() for v in batch))
        b, mb = step(b, batch)
        assert torch.equal(ma["loss"], mb["loss"])
    assert step.captured and step.builds == 1
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "kernel", "ref", "bitsim"])
def test_captured_eval_equals_plain_forwards_on_the_card(backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured forwards are CUDA graphs")
    prog = _prog("cifar10_tnn_smoke")
    params = init_train_state(prog, torch.Generator().manual_seed(0), device="cuda")["params"]
    pipe = pipeline_for_net(prog.graph, 8, seed=0)
    rep = evaluate(prog, params, pipe, n_batches=3, backend=backend)
    from repro_torch.train.evaluate import eval_batches

    batches = eval_batches(pipe, 3)
    deployed = prog.quantize(params, calib=torch.from_numpy(batches[0][0]).cuda())
    hq = hd = n = 0
    with torch.no_grad(), deterministic_float32():
        for x, y in batches:
            xt = torch.from_numpy(x).cuda()
            hq += int((prog.forward_qat(params, xt).argmax(-1).cpu().numpy() == y).sum())
            hd += int((deployed.forward(xt, backend=backend).argmax(-1).cpu().numpy()
                       == y).sum())
            n += len(y)
    assert (rep.qat_accuracy, rep.deployed_accuracy) == (hq / n, hd / n)
