"""The port's LM (`repro_torch.models.model`, `repro_torch.launch.steps`)
held against the reference's on the CPU, for every one of the ten
architectures at its SMOKE size.

Params and the stub frontend/encoder inputs are the reference's (params
from ``jax.random``, handed across as numpy); tokens are made with numpy
from a seed.  Both packages run their own prefill and then their own chain
of decode steps.  Tolerances (rtol = atol): 1e-3 for float32 logits and
caches of a whole model, 2e-2 for bf16 activations, exact for the cache's
integer ``len``; the port's own prefill -> decode consistency is held to the
reference test's 2e-3.

The bf16 reference is compiled with XLA's ``xla_allow_excess_precision``
off.  With it on (XLA's default) the compiler may skip the rounding of a
bf16 intermediate that is converted straight back to float32 (a residual
sum feeding a norm, say), so the compiled reference keeps bits that its own
op-by-op program rounds away; the port rounds each op as written.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import steps as RS
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves

ARCHS = RC.ARCH_IDS
B, S = 2, 13
DECODE_STEPS = 3
TOL_MODEL = 1e-3
TOL_BF16 = 2e-2


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


class Setup:
    """One architecture's reference params and inputs, on both sides."""

    def __init__(self, arch, **overrides):
        self.cfg_j = RC.get_config(arch, smoke=True, **overrides)
        self.cfg_t = TC.get_config(arch, smoke=True, **overrides)
        key = jax.random.PRNGKey(sum(map(ord, arch)))
        self.params_j = RM.init_params(self.cfg_j, key)
        self.params_t = lm_params_from_reference(
            jax.tree_util.tree_map(np.asarray, self.params_j), device="cpu")
        r = np.random.default_rng(len(arch))
        self.tokens = r.integers(0, self.cfg_j.vocab_size, (B, S)).astype(np.int32)
        self.next_tokens = r.integers(0, self.cfg_j.vocab_size,
                                      (DECODE_STEPS, B, 1)).astype(np.int32)
        self.extras = {}
        if self.cfg_j.frontend == "vision":
            self.extras["frontend_embeds"] = r.standard_normal(
                (B, self.cfg_j.frontend_seq, self.cfg_j.d_model)).astype(np.float32)
        if self.cfg_j.is_encdec:
            self.extras["enc_embeds"] = r.standard_normal(
                (B, self.cfg_j.enc_seq_len, self.cfg_j.d_model)).astype(np.float32)

    def extras_j(self):
        return {k: jnp.asarray(v) for k, v in self.extras.items()}

    def extras_t(self):
        return {k: t(v) for k, v in self.extras.items()}

    def jit(self, fn, *args):
        """``fn`` compiled for ``args``; in bf16 without excess precision."""
        if self.cfg_j.dtype == "float32":
            return jax.jit(fn)
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})

    def train_logits(self):
        args = (self.params_j, jnp.asarray(self.tokens), self.extras_j())
        fwd = self.jit(lambda p, x, kw: RM.forward(p, self.cfg_j, x, mode="train", **kw).logits,
                       *args)
        want = fwd(*args)
        got = TM.forward(self.params_t, self.cfg_t, t(self.tokens).long(), mode="train",
                         **self.extras_t()).logits
        return got, want

    def serve(self, cache_dtype_j=jnp.float32, cache_dtype_t=torch.float32):
        """Prefill S tokens, then DECODE_STEPS decode steps, in both packages.
        Returns [(logits_t, logits_j, cache_t, cache_j), ...] per step."""
        max_len = S + DECODE_STEPS
        batch_j = {"tokens": jnp.asarray(self.tokens), **self.extras_j()}
        pf_j = self.jit(RS.make_prefill_step(self.cfg_j, max_len, cache_dtype=cache_dtype_j),
                        self.params_j, batch_j)
        pf_t = TS.make_prefill_step(self.cfg_t, max_len, cache_dtype=cache_dtype_t)
        dec_t = TS.make_decode_step(self.cfg_t)
        lj, cj = pf_j(self.params_j, batch_j)
        lt, ct = pf_t(self.params_t, {"tokens": t(self.tokens).long(), **self.extras_t()})
        out = [(lt, lj, ct, cj)]
        dec_j = self.jit(RS.make_decode_step(self.cfg_j), self.params_j,
                         jnp.asarray(self.next_tokens[0]), cj)
        for step in range(DECODE_STEPS):
            tok = self.next_tokens[step]
            lj, cj = dec_j(self.params_j, jnp.asarray(tok), cj)
            lt, ct = dec_t(self.params_t, t(tok).long(), ct)
            out.append((lt, lj, ct, cj))
        return out


@pytest.fixture(scope="module")
def setups():
    return {arch: Setup(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def served(setups):
    return {arch: setups[arch].serve() for arch in ARCHS}


def _check_cache(ct, cj, tol):
    lt, lj = tree_leaves(ct), _jax_leaves(cj)
    assert len(lt) == len(lj)
    # leaves in the reference's flatten order; the int32 leaf is "len"
    for a, b in zip(lt, lj):
        assert tuple(a.shape) == tuple(b.shape)
        if a.dtype == torch.int32:
            assert a.ndim == 0 and int(a) == int(b)
        else:
            close(a, b, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_logits_match_reference(setups, arch):
    got, want = setups[arch].train_logits()
    assert tuple(got.shape) == (B, S, setups[arch].cfg_t.vocab_size)
    close(got, want, TOL_MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(served, arch):
    lt, lj, ct, cj = served[arch][0]
    close(lt, lj, TOL_MODEL)
    _check_cache(ct, cj, TOL_MODEL)
    assert int(ct["len"]) == int(cj["len"]) == TS.prefill_cache_len(
        TC.get_config(arch, smoke=True), S)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(served, arch):
    for step, (lt, lj, ct, cj) in enumerate(served[arch][1:]):
        close(lt, lj, TOL_MODEL)
        _check_cache(ct, cj, TOL_MODEL)
        assert int(ct["len"]) == int(cj["len"])


@pytest.mark.parametrize("quant", ["ternary", "ternary_packed"])
def test_gemma_quant_variants_match_reference(quant):
    su = Setup("gemma-2b", quant=quant)
    if quant == "ternary_packed":
        assert any(x.dtype == torch.uint8 for x in tree_leaves(su.params_t))
    got, want = su.train_logits()
    close(got, want, TOL_MODEL)
    lt, lj, _, _ = su.serve()[-1]
    close(lt, lj, TOL_MODEL)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "mamba2-370m"])
def test_bf16_smoke_variant_matches_reference(arch):
    """bf16 activations with float32 master weights and a bf16 cache: the
    full-width configs' numerics at smoke size."""
    su = Setup(arch, dtype="bfloat16")
    got, want = su.train_logits()
    assert got.dtype == torch.bfloat16
    close(got, want, TOL_BF16)
    for lt, lj, _, _ in su.serve(jnp.bfloat16, torch.bfloat16):
        close(lt, lj, TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_then_decode_equals_full_forward(setups, arch):
    """decode(prefill(S-1 tokens), token S) == the full forward's last
    logits (MoE at capacity_factor 8, so no token is dropped: capacity
    depends on the dispatch-group length, which differs between the two)."""
    su = setups[arch]
    cfg = su.cfg_t
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    toks = t(su.tokens).long()
    want = TM.forward(su.params_t, cfg, toks, mode="train", **su.extras_t()).logits[:, -1]
    lt, cache = TS.make_prefill_step(cfg, S + 2, cache_dtype=torch.float32)(
        su.params_t, {"tokens": toks[:, : S - 1], **su.extras_t()})
    got, cache = TS.make_decode_step(cfg)(su.params_t, toks[:, S - 1:], cache)
    close(got, want.numpy(), 2e-3)
    assert int(cache["len"]) == TS.prefill_cache_len(cfg, S)
