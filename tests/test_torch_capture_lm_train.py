"""The LM train step as the port captures it, on the CPU:
`make_train_step(..., donate=True)` wrapped in a
`repro_torch.capture.CapturedStep` (the counterpart of the reference's
``jax.jit(step, donate_argnums=(0,))`` in `launch/train_lm.py`) for the ten
architectures at their SMOKE size, with gradient accumulation and with
ternary gradient compression, and the restart path that restores a
checkpoint into the state the captured step holds.

On the CPU a `CapturedStep` runs its function eagerly over the same static
arguments it would capture on the card, so what these tests pin is the
capture's precondition: the donated step writes its whole state in place —
params, m, v, the step counter and the compression residuals — bit for bit
as the undonated one computes it, every state tensor keeps its address, the
warm step makes no host sync, and a restart allocates no second state.
Within the port everything is compared bit for bit; against the reference
at `test_torch_lm_train.py`'s tolerances (loss and aux rtol = atol = 1e-5,
grad norm 1e-4, the first moment rtol 1e-3, atol 1e-5).  Captured == eager
on the card is `test_torch_capture_lm_train_card.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_capture_train import HostSyncs

from repro import configs as RC
from repro.launch import steps as RS
from repro.optim import adamw as RA
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.capture import CapturedStep
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.data import LMTokenPipeline
from repro_torch.launch import steps as TS
from repro_torch.launch import train_lm
from repro_torch.launch.ft import run_with_restarts
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TCmp
from repro_torch.tree import tree_leaves, tree_map

B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
QUIET = dict(log=lambda *_: None)
# arch, accum_steps, compress_grads: the ten architectures, then gemma-2b
# accumulating and compressing
CASES = ([(arch, 1, False) for arch in TC.ARCH_IDS]
         + [("gemma-2b", 2, False), ("gemma-2b", 1, True)])
CASE_IDS = [f"{a}-accum{n}{'-compress' if c else ''}" for a, n, c in CASES]


class Syncs(HostSyncs):
    """`HostSyncs`, and the ops whose output shape depends on the data (a
    device-to-host read of a count on the card)."""

    BAD = HostSyncs.BAD + ("nonzero", "masked_select", "unique")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: SMOKE-sized steps run as fast on one,
    and the suite's parallel workers share the host's cores (eight threads
    each would oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe(cfg, seed=3):
    return LMTokenPipeline(
        cfg.vocab_size, S, B, seed=seed,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model, enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0)


def _state(cfg, compress, seed=1):
    return TS.make_train_state(cfg, torch.Generator().manual_seed(seed), compress=compress,
                               device="cpu")


def _steps(cfg, accum, compress, opt=OPT):
    kw = dict(compress_grads=compress, accum_steps=accum)
    return (TS.make_train_step(cfg, TA.AdamWConfig(**opt), **kw),
            CapturedStep(TS.make_train_step(cfg, TA.AdamWConfig(**opt), donate=True, **kw),
                         "cpu", inputs=(1,)))


def _ptrs(tree):
    return [x.data_ptr() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the donated, captured step within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum,compress", CASES, ids=CASE_IDS)
def test_captured_donated_lm_step_equals_undonated_bit_for_bit(arch, accum, compress):
    """Three steps through `train_lm`'s wrapping — numpy batches into a
    `CapturedStep` over the donating step — against the plain undonated
    step from the same state: every metric and every state leaf (params,
    m, v, the step counter, the residuals) the same bits; the returned
    state is the held one."""
    cfg = TC.get_config(arch, smoke=True)
    plain, step = _steps(cfg, accum, compress)
    a = _state(cfg, compress)
    b = tree_map(torch.clone, a)
    pipe = _pipe(cfg)
    for i in range(3):
        batch = pipe.next_batch()
        a, ma = plain(a, batch)
        b, mb = step(b, batch)
        assert sorted(ma) == sorted(mb)
        for key in ma:
            assert torch.equal(ma[key], mb[key]), (i, key)
    assert step.builds == 1 and not step.captured
    assert all(x is y for x, y in zip(tree_leaves(b), tree_leaves(step.held(0))))
    assert int(b.opt.step) == 3 and (b.residuals is None) == (not compress)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,accum,compress", [
    ("gemma-2b", 1, True), ("gemma-2b", 2, True), ("deepseek-v2-lite-16b", 1, True),
    ("jamba-v0.1-52b", 2, True), ("mamba2-370m", 1, False)])
def test_donated_lm_state_keeps_every_address(arch, accum, compress):
    """The capture's precondition: after a warm step every `TrainState`
    leaf — the compression residuals included — is the tensor it was, at
    the address it had."""
    cfg = TC.get_config(arch, smoke=True)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), compress_grads=compress,
                              accum_steps=accum, donate=True)
    state = _state(cfg, compress)
    leaves, ptrs = tree_leaves(state), _ptrs(state)
    pipe = _pipe(cfg)
    for _ in range(2):
        state, _ = step(state, pipe.next_batch())
        assert all(x is y for x, y in zip(tree_leaves(state), leaves))
        assert _ptrs(state) == ptrs
    if compress:
        assert any(bool(r.abs().sum() > 0) for r in tree_leaves(state.residuals))


def test_donated_compression_writes_residuals_in_place_with_the_same_bits():
    """`compress_with_feedback(..., donate=True)`: the same trits, scales
    and residual bits as the copying path, the residuals written into the
    given tensors, a non-float leaf's passed through."""
    r = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(r.standard_normal((37, 5)).astype(np.float32)),
             "b": torch.from_numpy(r.standard_normal(8).astype(np.float32)),
             "c": torch.tensor(0.5)}
    res = tree_map(lambda g: g * 0.1 if g.ndim else torch.zeros(()), grads)
    given = tree_map(torch.clone, res)
    ptrs = _ptrs(given)
    cc, rc = TCmp.compress_with_feedback(grads, res)
    cd, rd = TCmp.compress_with_feedback(grads, given, donate=True)
    assert all(x is y for x, y in zip(tree_leaves(rd), tree_leaves(given)))
    assert _ptrs(rd) == ptrs
    for x, y in zip(tree_leaves(rc), tree_leaves(rd)):
        assert torch.equal(x, y)
    is_c = lambda x: isinstance(x, TCmp.CompressedGrad)  # noqa: E731
    for x, y in zip(tree_leaves(cc, is_c), tree_leaves(cd, is_c)):
        if is_c(x):
            assert torch.equal(x.packed, y.packed) and torch.equal(x.scale, y.scale)
        else:
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(res), tree_leaves(
        tree_map(lambda g: g * 0.1 if g.ndim else torch.zeros(()), grads))))


@pytest.mark.parametrize("arch,accum,compress", CASES, ids=CASE_IDS)
def test_warm_donated_lm_step_makes_no_host_sync(arch, accum, compress):
    """The second call of the donated step (the one the card captures,
    after its eager warm-up, on the batch buffers `CapturedStep` holds)
    reads nothing on the host, makes no tensor from Python data and no
    tensor whose shape depends on the data."""
    cfg = TC.get_config(arch, smoke=True)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), compress_grads=compress,
                              accum_steps=accum, donate=True)
    state = _state(cfg, compress)
    pipe = _pipe(cfg)
    b0, b1 = ({k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
              for _ in range(2))
    state, _ = step(state, b0)
    with Syncs() as mode:
        step(state, b1)
    assert mode.seen == []


# ---------------------------------------------------------------------------
# against the reference's jitted, donating step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum,compress", [
    ("gemma-2b", 1, False), ("mamba2-370m", 1, False), ("deepseek-v2-lite-16b", 1, False),
    ("gemma-2b", 2, False), ("gemma-2b", 1, True)])
def test_captured_lm_step_matches_reference_jitted_donated_step(arch, accum, compress):
    """Two steps of the captured step against ``jax.jit(make_train_step(...),
    donate_argnums=(0,))`` from the reference's state on the same batches:
    each step's loss and aux (rtol = atol = 1e-5) and grad norm (1e-4), and
    the first moment after both (rtol 1e-3, atol 1e-5)."""
    cfg_j = RC.get_config(arch, smoke=True)
    cfg_t = TC.get_config(arch, smoke=True)
    state_j = RS.make_train_state(cfg_j, jax.random.PRNGKey(7), compress=compress)
    state_t = convert.lm_train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, state_j), device="cpu")
    step_j = jax.jit(RS.make_train_step(cfg_j, RA.AdamWConfig(**OPT), compress_grads=compress,
                                        accum_steps=accum), donate_argnums=(0,))
    _, step_t = _steps(cfg_t, accum, compress)
    pipe = _pipe(cfg_t, seed=11)
    for i in range(2):
        batch = pipe.next_batch()
        state_j, mj = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, mt = step_t(state_t, batch)
        assert sorted(mt) == sorted(mj)
        for k in mt:
            tol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=tol, atol=tol,
                                       err_msg=f"step {i} {k}")
    assert int(state_t.opt.step) == int(state_j.opt.step) == 2
    for a, b in zip(tree_leaves(state_t.opt.m), jax.tree_util.tree_leaves(state_j.opt.m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# restarts: the checkpoint restored into the held state
# ---------------------------------------------------------------------------

def test_restore_checkpoint_in_place_writes_the_target_tensors(tmp_path):
    """``in_place=True`` copies every leaf into the target's own tensor (a
    bfloat16 leaf and a 0-d int32 counter too) and returns the target."""
    g = torch.Generator().manual_seed(0)
    saved = {"w": torch.randn(3, 4, generator=g), "h": torch.randn(5, generator=g).bfloat16(),
             "n": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path, 1, saved)
    target = tree_map(torch.zeros_like, saved)
    ptrs = _ptrs(target)
    got, meta = restore_checkpoint(tmp_path, target, in_place=True)
    assert got is target and meta["step"] == 1 and _ptrs(target) == ptrs
    for x, y in zip(tree_leaves(saved), tree_leaves(target)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_fault_restart_restores_into_the_captured_lm_state(tmp_path, compress):
    """A fault at step 5 of a captured run (checkpoints every 4 steps)
    restores step 4 into the state the step holds: `init_state` runs once,
    every held leaf keeps its address across the restore, the step is
    built once, and the committed losses and the final state equal an
    uninterrupted run of the plain undonated step bit for bit."""
    cfg = TC.get_config("gemma-2b", smoke=True)
    opt = dict(OPT, total_steps=8)
    plain, step = _steps(cfg, 1, compress, opt)
    inits = []

    def init():
        inits.append(1)
        return _state(cfg, compress, seed=2)

    def run(ckpt, fn, injector=None):
        return run_with_restarts(lambda: fn, init, _pipe(cfg, seed=4), ckpt_dir=ckpt,
                                 n_steps=8, ckpt_every=4, fault_injector=injector, **QUIET)

    clean, hist_clean = run(tmp_path / "a", plain)
    inits.clear()
    ptrs = []

    def injector(i):
        if i == 5 and not ptrs:
            ptrs.append(_ptrs(step.held(0)))
            raise RuntimeError("simulated node failure")

    faulty, hist = run(tmp_path / "b", step, injector)
    assert hist["restarts"] == 1 and hist["resumed_from"] == [4]
    assert len(inits) == 1 and step.builds == 1
    assert all(x is y for x, y in zip(tree_leaves(faulty), tree_leaves(step.held(0))))
    assert _ptrs(faulty) == ptrs[0]
    assert hist["losses"][:5] + hist["losses"][6:] == hist_clean["losses"]
    for a, b in zip(tree_leaves(faulty), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_lm_launcher_restart_reuses_the_one_step(tmp_path, monkeypatch):
    """`train_lm.main` on the CPU with an injected fault: one step build,
    one train state made (the restart restores into the held one), and the
    resumed run ends in the bits of an uninterrupted one."""
    made = []
    make = train_lm.make_train_state

    def counted(*a, **kw):
        made.append(1)
        return make(*a, **kw)

    monkeypatch.setattr(train_lm, "make_train_state", counted)
    argv = ["--smoke", "--device", "cpu", "--steps", "8", "--ckpt-every", "3",
            "--batch", "2", "--seq", "16", "--compress-grads"]
    crashed = []

    def injector(i):
        if i == 4 and not crashed:
            crashed.append(i)
            raise RuntimeError("simulated node failure")

    state, hist = train_lm.main(argv + ["--ckpt-dir", str(tmp_path / "a")],
                                fault_injector=injector)
    assert crashed == [4] and hist["resumed_from"] == [3] and hist["restarts"] == 1
    assert hist["step_builds"] == 1 and len(made) == 1
    straight, hist2 = train_lm.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert hist2["step_builds"] == 1 and hist2["restarts"] == 0
    assert hist["losses"][:3] + hist["losses"][4:] == hist2["losses"]
    for a, b in zip(tree_leaves(state), tree_leaves(straight)):
        assert torch.equal(a, b)
