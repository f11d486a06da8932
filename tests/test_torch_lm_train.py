"""The port's LM training step (`repro_torch.launch.steps`), its token
pipeline, ternary gradient compression, specs and checkpoints held against
the reference's on the CPU.

Train states are the reference's (``jax.random`` init, handed across as
numpy through `convert.lm_train_state_from_reference`); batches come from
both packages' `LMTokenPipeline`, which must agree bit for bit.  The whole
step is compared on what it computes from the gradients, not on the new
params: after AdamW's first step an update is about ``±lr * sign(g)``, so a
gradient of +1e-9 in one package and -1e-9 in the other would move a
param 2 * lr apart.  So the step's loss, aux and grad norm (rtol = atol =
1e-5 / 1e-4) and its first moment ``m = 0.1 * clipped grads`` (rtol 1e-3,
atol 1e-5: the gradients' tolerance of `test_torch_lm_loss.py` times 0.1)
are compared, and `adamw_update` / `compress_with_feedback` are held to
the reference on identical gradients handed across as numpy (rtol = atol =
1e-6: the same float32 arithmetic; trits and counts exact).
``donate=True`` and ``donate=False`` must give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.ckpt import checkpoint as JC
from repro.data import pipeline as RP
from repro.launch import steps as RS
from repro.models import model as RM
from repro.models.config import SHAPES as SHAPES_J
from repro.optim import adamw as RA
from repro.optim import compress as RCmp
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.data import LMTokenPipeline, pipeline_for
from repro_torch.launch import steps as TS
from repro_torch.models.config import SHAPES as SHAPES_T
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TCmp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TOL_EXACT_MATH = 1e-6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _extras_kw(cfg):
    return dict(frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
                d_model=cfg.d_model, enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "internvl2-76b", "seamless-m4t-medium"])
def test_lm_token_pipeline_is_the_reference_bit_for_bit(arch):
    cfg = RC.get_config(arch, smoke=True)
    ref = RP.LMTokenPipeline(cfg.vocab_size, 24, 3, seed=5, **_extras_kw(cfg))
    port = LMTokenPipeline(cfg.vocab_size, 24, 3, seed=5, **_extras_kw(cfg))
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            a = np.asarray(want[k])
            assert got[k].dtype == a.dtype and got[k].shape == a.shape
            np.testing.assert_array_equal(got[k], a)
    assert port.state.step == ref.state.step == 3
    np.testing.assert_array_equal(port.batch_at(1)["targets"],
                                  np.asarray(ref.batch_at(1)["targets"]))


def test_pipeline_for_matches_reference_cell():
    cfg_j, cfg_t = RC.get_config("internvl2-76b"), TC.get_config("internvl2-76b")
    for name in ("train_4k", "prefill_32k"):
        ref = RP.pipeline_for(cfg_j, SHAPES_J[name], seed=2)
        port = pipeline_for(cfg_t, SHAPES_T[name], seed=2)
        assert (port.vocab, port.seq, port.batch, port.frontend_seq, port.d_model,
                port.enc_seq) == (ref.vocab, ref.seq, ref.batch, ref.frontend_seq,
                                  ref.d_model, ref.enc_seq)


# ---------------------------------------------------------------------------
# ternary gradient compression
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    r = np.random.default_rng(seed)
    return {"a": {"w": r.standard_normal((37, 5)).astype(np.float32)},
            "b": r.standard_normal((8,)).astype(np.float32) * 1e-3,
            "c": np.array(0.5, np.float32),             # 0-d: passes through
            "d": r.standard_normal((2, 3, 7)).astype(np.float32)}


def test_compress_with_feedback_matches_reference_on_identical_grads():
    grads = _grad_tree(0)
    res = jax.tree_util.tree_map(lambda a: a * np.float32(0.1), _grad_tree(1))
    cj, rj = RCmp.compress_with_feedback(jax.tree_util.tree_map(jnp.asarray, grads),
                                         jax.tree_util.tree_map(jnp.asarray, res))
    tt = lambda tree: tree_map(lambda a: torch.from_numpy(np.array(a)), tree)  # noqa: E731
    ct, rt = TCmp.compress_with_feedback(tt(grads), tt(res))
    is_c = lambda x: isinstance(x, RCmp.CompressedGrad)  # noqa: E731
    leaves_j = jax.tree_util.tree_leaves(cj, is_leaf=is_c)
    leaves_t = tree_leaves(ct, lambda x: isinstance(x, TCmp.CompressedGrad))
    assert len(leaves_j) == len(leaves_t) == 4
    for a, b in zip(leaves_t, leaves_j):
        if is_c(b):
            assert a.n == b.n and a.packed.dtype == torch.uint8
            np.testing.assert_array_equal(a.packed.numpy(), np.asarray(b.packed))
            np.testing.assert_allclose(float(a.scale), float(b.scale), rtol=TOL_EXACT_MATH)
        else:
            assert float(a) == float(b)
    for a, b in zip(tree_leaves(rt), jax.tree_util.tree_leaves(rj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL_EXACT_MATH,
                                   atol=TOL_EXACT_MATH)
    dt = TCmp.decompress(ct, tt(grads))
    dj = RCmp.decompress(cj, jax.tree_util.tree_map(jnp.asarray, grads))
    for a, b in zip(tree_leaves(dt), jax.tree_util.tree_leaves(dj)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL_EXACT_MATH,
                                   atol=TOL_EXACT_MATH)


def test_compression_feedback_loses_no_mass_and_wire_bytes_match():
    grads = tree_map(torch.from_numpy, _grad_tree(2))
    res = TCmp.init_residuals(grads)
    assert float(res["c"]) == 0.0 and res["c"].ndim == 0
    cg, new_res = TCmp.compress_with_feedback(grads, res)
    dec = TCmp.decompress(cg, grads)
    for g, d, r in zip(tree_leaves(grads), tree_leaves(dec), tree_leaves(new_res)):
        if g.ndim:   # g + 0 == what went out + what stays behind
            torch.testing.assert_close(d + r, g, rtol=0, atol=1e-6)
    assert TCmp.wire_bytes(grads) == RCmp.wire_bytes(
        jax.tree_util.tree_map(jnp.asarray, _grad_tree(2)))


# ---------------------------------------------------------------------------
# AdamW on identical gradients (an LM params tree)
# ---------------------------------------------------------------------------

def test_adamw_update_matches_reference_on_identical_grads():
    cfg_j = RC.get_config("gemma-2b", smoke=True)
    params_j = RM.init_params(cfg_j, jax.random.PRNGKey(3))
    r = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: r.standard_normal(p.shape).astype(np.float32) * 0.3, _np(params_j))
    ocj, oct_ = RA.AdamWConfig(**OPT), TA.AdamWConfig(**OPT)
    state_j = RA.adamw_init(params_j)
    update_j = jax.jit(lambda p, g, s: RA.adamw_update(ocj, p, g, s))
    params_t = convert.lm_params_from_reference(_np(params_j), device="cpu")
    state_t = TA.adamw_init(params_t)
    for _ in range(3):   # moments and bias corrections past the first step
        params_j, state_j, mj = update_j(params_j, grads, state_j)
        params_t, state_t, mt = TA.adamw_update(
            oct_, params_t, convert.lm_params_from_reference(grads, device="cpu"), state_t)
        grads = jax.tree_util.tree_map(lambda g: g * np.float32(0.7), grads)
    assert int(state_t.step) == int(state_j.step) == 3
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=TOL_EXACT_MATH)
    for a, b in zip(tree_leaves((params_t, state_t)),
                    jax.tree_util.tree_leaves((params_j, state_j))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL_EXACT_MATH,
                                   atol=TOL_EXACT_MATH)


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

STEP_CASES = [
    # arch, batch, seq, accum_steps, compress_grads
    ("gemma-2b", 2, 16, 1, False),
    ("mamba2-370m", 2, 16, 1, False),
    ("deepseek-v2-lite-16b", 2, 16, 1, False),
    ("gemma-2b", 4, 16, 2, False),
    ("gemma-2b", 2, 16, 1, True),
]


@pytest.mark.parametrize("arch,batch,seq,accum,compress", STEP_CASES)
def test_train_step_matches_reference(arch, batch, seq, accum, compress):
    cfg_j = RC.get_config(arch, smoke=True)
    cfg_t = TC.get_config(arch, smoke=True)
    state_j = RS.make_train_state(cfg_j, jax.random.PRNGKey(7), compress=compress)
    state_t = convert.lm_train_state_from_reference(_np(state_j), device="cpu")
    batch_np = LMTokenPipeline(cfg_t.vocab_size, seq, batch, seed=11,
                               **_extras_kw(cfg_t)).next_batch()
    step_j = jax.jit(RS.make_train_step(cfg_j, RA.AdamWConfig(**OPT), compress_grads=compress,
                                        accum_steps=accum))
    step_t = TS.make_train_step(cfg_t, TA.AdamWConfig(**OPT), compress_grads=compress,
                                accum_steps=accum)
    new_j, mj = step_j(state_j, {k: jnp.asarray(v) for k, v in batch_np.items()})
    new_t, mt = step_t(state_t, batch_np)

    assert sorted(mt) == sorted(mj)
    for k in mt:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=tol, atol=tol)
    assert int(new_t.opt.step) == int(new_j.opt.step) == 1
    for a, b in zip(tree_leaves(new_t.opt.m), jax.tree_util.tree_leaves(new_j.opt.m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    assert (new_t.residuals is None) == (not compress)
    if compress:
        for a, b in zip(tree_leaves(new_t.residuals), jax.tree_util.tree_leaves(new_j.residuals)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    assert tree_leaves(new_t.params)[0].shape == tree_leaves(state_t.params)[0].shape


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


@pytest.mark.parametrize("arch,accum,compress", [("gemma-2b", 2, True),
                                                 ("deepseek-v2-lite-16b", 1, False)])
def test_donate_is_bit_equal_to_copy(arch, accum, compress):
    """Two steps with ``donate=True`` (in place) and with ``donate=False``
    from the same state: the same bits.  The non-donating step leaves its
    input untouched; the donating one returns the input's own tensors."""
    cfg = TC.get_config(arch, smoke=True)
    state0 = TS.make_train_state(cfg, torch.Generator().manual_seed(1), compress=compress,
                                 device="cpu")
    pipe = LMTokenPipeline(cfg.vocab_size, 16, 4, seed=3, **_extras_kw(cfg))
    batches = [pipe.next_batch() for _ in range(2)]
    kw = dict(compress_grads=compress, accum_steps=accum)
    step_copy = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), **kw)
    step_donate = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), donate=True, **kw)

    a, b = _clone(state0), _clone(state0)
    a_in = a
    for batch in batches:
        a_prev, b_prev = a, _clone(b)
        a, ma = step_donate(a, batch)
        b, mb = step_copy(b, batch)
        for x, y in zip(tree_leaves(a.params), tree_leaves(a_prev.params)):
            assert x is y   # written in place
        for x, y in zip(tree_leaves(b_prev), tree_leaves(_clone(b_prev))):
            assert torch.equal(x, y)
        assert sorted(ma) == sorted(mb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert tree_leaves(a_in.opt.m)[0] is tree_leaves(a.opt.m)[0]
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(b.params),
                                                      tree_leaves(state0.params)))


def test_copy_step_leaves_its_input_untouched():
    cfg = TC.get_config("mamba2-370m", smoke=True)
    state = TS.make_train_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    before = _clone(state)
    batch = LMTokenPipeline(cfg.vocab_size, 16, 2, seed=0).next_batch()
    TS.make_train_step(cfg, TA.AdamWConfig(**OPT))(state, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(state), tree_leaves(before)))


# ---------------------------------------------------------------------------
# specs (meta device) against jax.eval_shape
# ---------------------------------------------------------------------------

def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(k) for k in path), tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
            for path, leaf in flat]


def _torch_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _torch_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, x in zip(tree._fields, tree) for p in _torch_paths(x, prefix + (f,))]
    if tree is None:
        return []
    assert tree.device.type == "meta"
    return [(prefix, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b", "seamless-m4t-medium"])
def test_full_width_train_state_specs_match_reference(arch):
    for compress in (False, True):
        want = _jax_paths(RS.train_state_specs(RC.get_config(arch), compress=compress))
        got = _torch_paths(TS.train_state_specs(TC.get_config(arch), compress=compress))
        assert got == want


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_full_width_input_specs_match_reference(arch):
    for name in SHAPES_J:
        want = _jax_paths(RS.input_specs(RC.get_config(arch), SHAPES_J[name]))
        got = _torch_paths(TS.input_specs(TC.get_config(arch), SHAPES_T[name]))
        assert got == want, name


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _reference_train_state():
    cfg = RC.get_config("gemma-2b", smoke=True)
    state = RS.make_train_state(cfg, jax.random.PRNGKey(5), compress=True)
    # values a zero state would hide
    opt = state.opt._replace(
        step=jnp.asarray(4, jnp.int32),
        m=jax.tree_util.tree_map(lambda a: a + 0.25, state.opt.m),
        v=jax.tree_util.tree_map(lambda a: a + 0.5, state.opt.v))
    res = jax.tree_util.tree_map(lambda a: a - 0.125, state.residuals)
    return RS.TrainState(params=state.params, opt=opt, residuals=res)


def _port_like():
    return TS.make_train_state(TC.get_config("gemma-2b", smoke=True),
                               torch.Generator().manual_seed(0), compress=True, device="cpu")


def test_reference_lm_checkpoint_restores_in_port(tmp_path):
    ref = _reference_train_state()
    JC.save_checkpoint(tmp_path, 4, ref, pipeline_cursor={"seed": 0, "step": 4})
    got, meta = restore_checkpoint(tmp_path, _port_like())
    assert meta["step"] == 4 and meta["pipeline_cursor"]["step"] == 4
    want = jax.tree_util.tree_leaves(ref)
    assert len(tree_leaves(got)) == len(want)
    for a, b in zip(tree_leaves(got), want):
        assert str(a.dtype).replace("torch.", "") == str(np.asarray(b).dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conv = convert.lm_train_state_from_reference(_np(ref), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(conv), tree_leaves(got)))


def test_port_lm_checkpoint_restores_in_reference(tmp_path):
    port = convert.lm_train_state_from_reference(_np(_reference_train_state()), device="cpu")
    port = port._replace(params=tree_map(lambda a: a * 2, port.params))
    save_checkpoint(tmp_path, 9, port, pipeline_cursor={"seed": 1, "step": 9})
    like = RS.make_train_state(RC.get_config("gemma-2b", smoke=True), jax.random.PRNGKey(0),
                               compress=True)
    got, meta = JC.restore_checkpoint(tmp_path, like)
    assert meta["step"] == 9
    assert isinstance(got, RS.TrainState)
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(port)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_state_leaf_order_is_the_reference_flatten_order():
    ref = _reference_train_state()
    port = convert.lm_train_state_from_reference(_np(ref), device="cpu")
    assert port.opt.step.dtype == torch.int32 and port.opt.step.ndim == 0
    want = jax.tree_util.tree_leaves(ref)
    got = tree_leaves(port)
    assert [tuple(a.shape) for a in got] == [tuple(b.shape) for b in want]
    rebuilt = tree_unflatten(port, got)
    assert isinstance(rebuilt, TS.TrainState) and rebuilt.residuals is not None
