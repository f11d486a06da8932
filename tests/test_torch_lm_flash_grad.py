"""The port's flash-attention backward (`repro_torch.models.flash`) held
against the reference's custom VJP (`repro.models.flash._flash_bwd`,
reached through ``jax.grad``) on the CPU.

Inputs are Gaussian, made with numpy from a seed.  Tolerance rtol = atol =
4e-3 for float32 gradients, the reference's own (`tests/test_flash.py`,
its four ``CASES``); bf16 gradients keep bf16 and agree with the
reference's within 2e-2 (an ulp of bf16 at the gradients' magnitude is
about 8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import flash as RF
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF

TOL = 4e-3
TOL_BF16 = 2e-2

# the reference's CASES (tests/test_flash.py): B, S, KV, G, hd, q_chunk, kv_chunk
CASES = [
    (2, 512, 2, 3, 32, 128, 96),    # uneven chunk vs kv_chunk
    (1, 300, 1, 4, 16, 128, 128),   # S not a chunk multiple (MQA)
    (2, 256, 4, 1, 32, 64, 64),     # MHA (G=1)
    (1, 64, 2, 2, 8, 1024, 1024),   # S smaller than one chunk
]

# flash_attention directly, causal=False: B, Sq, Sk, KV, G, hd, q_chunk, kv_chunk
NONCAUSAL = [
    (2, 60, 60, 2, 2, 16, 16, 20),    # encoder self-attention, ragged kv chunk
    (1, 40, 70, 2, 1, 8, 16, 32),     # cross-attention: Sk != Sq
    (1, 96, 33, 1, 4, 16, 32, 16),    # cross-attention, MQA, Sk < Sq
]


def gauss(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def grads_torch(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    torch.sum(fn(*ts).to(torch.float32) ** 2).backward()
    return [x.grad for x in ts]


def grads_jax(fn, *xs):
    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) ** 2)
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*map(jnp.asarray, xs))


def close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,kvh,g,hd,qc,kc", CASES)
def test_causal_flash_grads_match_reference(b, s, kvh, g, hd, qc, kc):
    q, k, v = gauss(1, b, s, kvh * g, hd), gauss(2, b, s, kvh, hd), gauss(3, b, s, kvh, hd)
    scale = hd ** -0.5
    want = grads_jax(lambda q, k, v: RA.chunked_causal_attention(
        q, k, v, scale, q_chunk=qc, kv_chunk=kc), q, k, v)
    got = grads_torch(lambda q, k, v: TA.chunked_causal_attention(
        q, k, v, scale, q_chunk=qc, kv_chunk=kc), q, k, v)
    for a, w in zip(got, want):
        assert tuple(a.shape) == tuple(w.shape)
        close(a, w, TOL)


@pytest.mark.parametrize("b,sq,sk,kvh,g,hd,qc,kc", NONCAUSAL)
def test_noncausal_flash_grads_match_reference(b, sq, sk, kvh, g, hd, qc, kc):
    q, k, v = gauss(4, b, sq, kvh, g, hd), gauss(5, b, sk, kvh, hd), gauss(6, b, sk, kvh, hd)
    scale = hd ** -0.5
    want = grads_jax(lambda q, k, v: RF.flash_attention(q, k, v, scale, qc, kc, False), q, k, v)
    got = grads_torch(lambda q, k, v: TF.flash_attention(q, k, v, scale, qc, kc, False),
                      q, k, v)
    for a, w in zip(got, want):
        assert tuple(a.shape) == tuple(w.shape)   # dk/dv sliced back to Sk
        close(a, w, TOL)


def test_flash_grads_match_full_attention():
    """The backward against autograd through the port's full-materialization
    path (its own oracle, independent of the reference)."""
    b, s, kvh, g, hd = 1, 200, 2, 2, 16
    q, k, v = gauss(7, b, s, kvh * g, hd), gauss(8, b, s, kvh, hd), gauss(9, b, s, kvh, hd)
    scale = hd ** -0.5
    pos = torch.arange(s)[None].expand(b, s)
    mask = (pos[:, :, None] >= pos[:, None, :])[:, None, None]
    want = grads_torch(lambda q, k, v: TA.full_attention(q, k, v, mask, scale), q, k, v)
    got = grads_torch(lambda q, k, v: TA.chunked_causal_attention(
        q, k, v, scale, q_chunk=64, kv_chunk=48), q, k, v)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_grad_dtype_preserved_bf16():
    """bf16 in, bf16 cotangents out (the reference's test_grad_dtype_preserved),
    finite and within bf16 tolerance of the reference's."""
    b, s, kvh, g, hd = 1, 128, 1, 2, 8
    q, k, v = gauss(10, b, s, kvh * g, hd), gauss(11, b, s, kvh, hd), gauss(12, b, s, kvh, hd)
    scale = hd ** -0.5
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = TA.chunked_causal_attention(*ts, scale, q_chunk=64, kv_chunk=64)
    assert out.dtype == torch.bfloat16
    torch.sum(out.to(torch.float32)).backward()
    js = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(RA.chunked_causal_attention(
        q, k, v, scale, q_chunk=64, kv_chunk=64).astype(jnp.float32)), argnums=(0, 1, 2)))(*js)
    for x, w in zip(ts, want):
        assert x.grad.dtype == torch.bfloat16
        assert torch.isfinite(x.grad.to(torch.float32)).all()
        close(x.grad, w, TOL_BF16)


def test_backward_saves_no_score_matrix():
    """The forward saves O(S*hd) residuals: q, padded k and v, o and lse,
    never a [.., S, S] probability block."""
    b, s, kvh, g, hd = 1, 256, 1, 2, 8
    q = torch.from_numpy(gauss(13, b, s, kvh, g, hd)).requires_grad_()
    k = torch.from_numpy(gauss(14, b, s, kvh, hd)).requires_grad_()
    v = torch.from_numpy(gauss(15, b, s, kvh, hd)).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        TF.flash_attention(q, k, v, hd ** -0.5, 64, 64)
    assert saved and max(int(np.prod(sh)) for sh in saved) <= b * s * kvh * g * hd
