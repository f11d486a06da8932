"""`repro_torch.core.ternary` held against `repro.core.ternary`.

Inputs are made with numpy from a seed and handed to both packages.  The
codec is integer arithmetic, so packed bytes, trits and masks must be
**equal**.  The TWN quantizer's threshold ``nu * mean|w|`` and scale
``sum/count`` are float32 reductions whose order differs between XLA and
PyTorch: trits are compared for equality with any element within one ulp of
the threshold named (none on these seeds), alpha at ``rtol=1e-6`` (a few
float32 ulps of a sum of <= 2k terms).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ternary as J
from repro_torch.core import ternary as T


def _trits(shape, seed):
    return np.random.RandomState(seed).randint(-1, 2, shape).astype(np.int8)


@pytest.mark.parametrize("axis", [0, 1, 2, -1, -2])
def test_pack_unpack_select_bytes_equal(axis):
    t = _trits((12, 8, 20), seed=11)
    pj = np.asarray(J.pack_ternary(jnp.asarray(t), axis=axis))
    pt = T.pack_ternary(torch.from_numpy(t), axis=axis)
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(T.unpack_ternary(pt, axis=axis).numpy(), t)
    np.testing.assert_array_equal(
        T.unpack_ternary(pt, axis=axis).numpy(),
        np.asarray(J.unpack_ternary(jnp.asarray(pj), axis=axis)),
    )
    np.testing.assert_array_equal(T.select_decode(pt, axis=axis).numpy(), t)
    plus_j, minus_j = J.select_masks(jnp.asarray(pj), axis=axis)
    plus_t, minus_t = T.select_masks(pt, axis=axis)
    np.testing.assert_array_equal(plus_t.numpy(), np.asarray(plus_j))
    np.testing.assert_array_equal(minus_t.numpy(), np.asarray(minus_j))
    assert ((plus_t + minus_t) <= 1).all()


def test_unpack_dtype_and_code_3_decodes_like_reference():
    """Code 11 never comes out of pack_ternary; both packages decode it the
    same way (unpack: +2, select: +1) — out of contract, but identical."""
    p = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(
        T.unpack_ternary(torch.from_numpy(p), axis=0, dtype=torch.float32).numpy(),
        np.asarray(J.unpack_ternary(jnp.asarray(p), axis=0, dtype=jnp.float32)),
    )
    np.testing.assert_array_equal(
        T.select_decode(torch.from_numpy(p), axis=1).numpy(),
        np.asarray(J.select_decode(jnp.asarray(p), axis=1)),
    )


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError, match="not a multiple of 4"):
        T.pack_ternary(torch.zeros((3, 6), dtype=torch.int8), axis=1)


@pytest.mark.parametrize("shape,axis", [((5, 7, 9), -1), ((16, 3), 0), ((4,), 0)])
def test_packed_nbytes(shape, axis):
    assert T.packed_nbytes(shape, axis) == J.packed_nbytes(shape, axis)


def test_sparsity():
    t = _trits((9, 33), seed=3)
    assert float(T.sparsity(torch.from_numpy(t))) == pytest.approx(
        float(J.sparsity(jnp.asarray(t))), abs=1e-7)


@pytest.mark.parametrize("shape,axis", [
    ((3, 3, 16, 24), None),        # per-layer grid (QAT default)
    ((3, 3, 16, 24), (0, 1, 2)),   # conv deploy grid: per output channel
    ((3, 12, 12), (0, 1)),         # tcn deploy grid
    ((96, 12), 0),                 # fc / matmul grid
])
@pytest.mark.parametrize("nu", [0.7, 0.4])
def test_quantize_weights_trits_equal_alpha_close(shape, axis, nu):
    w = np.random.RandomState(len(shape) * 7 + int(nu * 10)).randn(*shape).astype(np.float32)
    tj, aj = J.ternary_quantize_weights(jnp.asarray(w), nu=nu, axis=axis)
    tt, at = T.ternary_quantize_weights(torch.from_numpy(w), nu=nu, axis=axis)
    assert tt.dtype == torch.int8 and at.dtype == torch.float32
    assert tuple(at.shape) == tuple(aj.shape)
    # an element may only differ if |w| sits within one ulp of the threshold
    differ = np.argwhere(np.asarray(tj) != tt.numpy())
    assert differ.size == 0, f"trits differ at {differ.tolist()} (threshold-ulp cases)"
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6, atol=0)


def test_quantize_acts_and_ste_forward_values_equal():
    x = np.random.RandomState(5).randn(4, 6, 8).astype(np.float32)
    x[0, 0, 0] = 0.5  # exactly on the threshold: strict > keeps it at 0
    for thr in (0.5, 0.25):
        np.testing.assert_array_equal(
            T.ternary_quantize_acts(torch.from_numpy(x), threshold=thr).numpy(),
            np.asarray(J.ternary_quantize_acts(jnp.asarray(x), threshold=thr)),
        )
    assert float(T.ternary_quantize_acts(torch.from_numpy(x))[0, 0, 0]) == 0.0
    per_channel = np.linspace(0.1, 0.9, 8).astype(np.float32)
    np.testing.assert_array_equal(
        T.ste_ternary_acts(torch.from_numpy(x), torch.from_numpy(per_channel)).numpy(),
        np.asarray(J.ste_ternary_acts(jnp.asarray(x), jnp.asarray(per_channel))),
    )
    w = np.random.RandomState(6).randn(3, 3, 8, 12).astype(np.float32)
    # alpha * t: trits equal, alpha within rtol 1e-6 (see module docstring)
    np.testing.assert_allclose(
        T.ste_ternary_weights(torch.from_numpy(w), 0.7, (0, 1, 2)).numpy(),
        np.asarray(J.ste_ternary_weights(jnp.asarray(w), 0.7, (0, 1, 2))),
        rtol=1e-6, atol=0,
    )


def test_clamp_threshold_equal():
    t = np.array([0.0, 0.05, 0.3, 2.0, 5.0], np.float32)
    np.testing.assert_array_equal(
        T.clamp_threshold(torch.from_numpy(t)).numpy(),
        np.asarray(J.clamp_threshold(jnp.asarray(t))),
    )
    assert float(T.clamp_threshold(0.01)) == pytest.approx(0.05)
