"""The port's LM training loss (`repro_torch.models.model.lm_loss`,
`chunked_ce_loss`) and its gradients held against the reference's
``jax.value_and_grad(repro.models.model.lm_loss)`` on the CPU, for every one
of the ten architectures at its SMOKE size (float32) and for three of them
under ``quant="ternary"`` (the STE on every projection and, untied, on the
head), as `tests/test_arch_smoke.py` runs them.

Params and the stub frontend/encoder inputs are the reference's (params
from ``jax.random``, handed across as numpy); tokens and targets are made
with numpy from a seed, some targets -1 (masked).  The port's gradients
come from `repro_torch.launch.steps.value_and_grad` (autograd through the
layer remat, the flash backward and the chunk remat of the CE).
Tolerances: the loss and the aux loss rtol = atol = 1e-5; every gradient
leaf rtol = 1e-3, atol = 1e-4 (float32 through a whole model: measured
differences stay below 1.1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves

ARCHS = RC.ARCH_IDS
B, S = 2, 13
TOL_LOSS = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-3, 1e-4


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _inputs(cfg, seed):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets[0, -3:] = -1
    targets[1, 0] = -1
    extras = {}
    if cfg.frontend == "vision":
        extras["frontend_embeds"] = r.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        extras["enc_embeds"] = r.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return tokens, targets, extras


def _check(arch, **overrides):
    cfg_j = RC.get_config(arch, smoke=True, **overrides)
    cfg_t = TC.get_config(arch, smoke=True, **overrides)
    params_j = RM.init_params(cfg_j, jax.random.PRNGKey(sum(map(ord, arch))))
    params_t = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, params_j),
                                        device="cpu")
    tokens, targets, extras = _inputs(cfg_j, len(arch))
    vg = jax.jit(jax.value_and_grad(
        lambda p, x, y, kw: RM.lm_loss(p, cfg_j, x, y, **kw), has_aux=True))
    (total_j, m_j), g_j = vg(params_j, jnp.asarray(tokens), jnp.asarray(targets),
                             {k: jnp.asarray(v) for k, v in extras.items()})
    (total_t, m_t), g_t = TS.value_and_grad(
        cfg_t, params_t, {"tokens": t(tokens), "targets": t(targets),
                          **{k: t(v) for k, v in extras.items()}})

    for got, want in ((total_t, total_j), (m_t["loss"], m_j["loss"]), (m_t["aux"], m_j["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=TOL_LOSS, atol=TOL_LOSS)
    assert int(m_t["ntok"]) == int(m_j["ntok"]) == int((targets >= 0).sum())
    assert m_t["ntok"].dtype == torch.int32
    leaves_t, leaves_j = tree_leaves(g_t), jax.tree_util.tree_leaves(g_j)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_GRAD, atol=ATOL_GRAD)
    assert sum(float(a.abs().sum()) for a in leaves_t) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    _check(arch)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m", "deepseek-v2-lite-16b"])
def test_ternary_qat_loss_and_grads_match_reference(arch):
    _check(arch, quant="ternary")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_ce_ragged_chunks_and_masked_targets_match_reference(softcap):
    """S = 13 in chunks of 5 (the last one padded with -1 targets), masked
    targets, with and without the logit softcap: loss, count and the
    gradients in the hidden states and the head."""
    r = np.random.default_rng(3)
    b, s, d, v = 2, 13, 16, 40
    hidden = r.standard_normal((b, s, d)).astype(np.float32)
    head = (r.standard_normal((d, v)) / 4).astype(np.float32)
    targets = r.integers(0, v, (b, s)).astype(np.int32)
    targets[:, 4] = -1
    targets[1, -2:] = -1

    def loss_j(h, w):
        return RM.chunked_ce_loss(h, jnp.asarray(targets), w, softcap=softcap, chunk=5)

    (want, nt_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(head))
    h, w = t(hidden).requires_grad_(), t(head).requires_grad_()
    got, nt_t = TM.chunked_ce_loss(h, t(targets), w, softcap=softcap, chunk=5)
    got.backward()
    assert int(nt_t) == int(nt_j) == int((targets >= 0).sum())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL_LOSS, atol=TOL_LOSS)
    for a, bj in zip((h.grad, w.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(bj), rtol=RTOL_GRAD, atol=ATOL_GRAD)


def test_chunk_remat_keeps_no_logits():
    """With autograd on, no [B, chunk, V] logits block is saved for the
    backward: each chunk's logits are recomputed (`torch.utils.checkpoint`)."""
    b, s, d, v = 1, 64, 8, 1000
    hidden = torch.randn(b, s, d, requires_grad=True)
    head = torch.randn(d, v, requires_grad=True)
    targets = torch.randint(0, v, (b, s))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x.numel()) or x,
                                                  lambda x: x):
        loss, _ = TM.chunked_ce_loss(hidden, targets, head, chunk=16)
    assert max(saved) < 16 * v
    loss.backward()
    assert torch.isfinite(head.grad).all() and head.grad.abs().sum() > 0
