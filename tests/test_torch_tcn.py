"""`repro_torch.core.tcn` held against `repro.core.tcn` — the cases of
tests/test_tcn_mapping.py, same numpy inputs through both packages.

Tolerances: the wrap/unwrap/projection transforms move data and must be
**equal**; with ternary inputs and weights the convolutions sum integers
and must be **equal** too.  With Gaussian data the two frameworks sum in a
different order: ``rtol=1e-4, atol=1e-4`` as in the reference's own test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import tcn as J
from repro_torch.core import tcn as T


def _np(a):
    return np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()


@given(
    d=st.integers(1, 9), n=st.integers(1, 3), t=st.integers(1, 40),
    c_in=st.integers(1, 5), c_out=st.integers(1, 5), batch=st.integers(1, 3),
    seed=st.integers(0, 10_000),
)
@settings(max_examples=25, deadline=None)
def test_mapping_equivalence_property_and_parity(d, n, t, c_in, c_out, batch, seed):
    """The paper's claim (mapped == Eq. 1) holds in the port, and both forms
    agree with the reference's."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, t, c_in).astype(np.float32)
    w = rng.randn(n, c_in, c_out).astype(np.float32)
    y_ref = T.dilated_causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), d)
    y_map = T.dilated1d_via_2d(torch.from_numpy(x), torch.from_numpy(w), d)
    assert y_map.shape == y_ref.shape == (batch, t, c_out)
    np.testing.assert_allclose(_np(y_map), _np(y_ref), rtol=1e-4, atol=1e-4)
    y_jax = J.dilated_causal_conv1d(jnp.asarray(x), jnp.asarray(w), d)
    np.testing.assert_allclose(_np(y_ref), _np(y_jax), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_ternary_weights_stay_exact_and_equal_reference(d):
    rng = np.random.RandomState(5)
    x = rng.randint(-1, 2, size=(2, 24, 96)).astype(np.float32)
    w = rng.randint(-1, 2, size=(3, 96, 96)).astype(np.float32)
    y_ref = T.dilated_causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), d)
    y_map = T.dilated1d_via_2d(torch.from_numpy(x), torch.from_numpy(w), d)
    np.testing.assert_array_equal(_np(y_map), _np(y_ref))
    np.testing.assert_array_equal(
        _np(y_map), _np(J.dilated1d_via_2d(jnp.asarray(x), jnp.asarray(w), d)))


def test_paper_figure3_case():
    x = np.random.RandomState(0).randn(1, 12, 2).astype(np.float32)
    w = np.random.RandomState(1).randn(2, 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        _np(T.dilated1d_via_2d(torch.from_numpy(x), torch.from_numpy(w), 3)),
        _np(J.dilated_causal_conv1d(jnp.asarray(x), jnp.asarray(w), 3)),
        rtol=1e-5, atol=1e-5,
    )


def test_causality():
    rng = np.random.RandomState(2)
    x = rng.randn(1, 20, 4).astype(np.float32)
    w = torch.from_numpy(rng.randn(3, 4, 4).astype(np.float32))
    y0 = T.dilated_causal_conv1d(torch.from_numpy(x), w, 2)
    x2 = x.copy()
    x2[:, 11:, :] = 999.0
    y1 = T.dilated_causal_conv1d(torch.from_numpy(x2), w, 2)
    np.testing.assert_allclose(_np(y0[:, :11]), _np(y1[:, :11]), rtol=1e-6)


class TestWeightProjection:
    @pytest.mark.parametrize("n,kh,kw", [(3, 3, 3), (2, 3, 3), (1, 1, 1), (3, 5, 5)])
    def test_equal_to_reference(self, n, kh, kw):
        w = np.random.RandomState(n + kh).randn(n, 4, 5).astype(np.float32)
        got = T.project_weights_to_2d(torch.from_numpy(w), kh=kh, kw=kw)
        want = J.project_weights_to_2d(jnp.asarray(w), kh=kh, kw=kw)
        np.testing.assert_array_equal(_np(got), _np(want))

    def test_short_kernel_bottom_aligned(self):
        w = torch.arange(2, dtype=torch.float32).reshape(2, 1, 1) + 1
        k2d = T.project_weights_to_2d(w, kh=3, kw=3)
        assert [float(k2d[r, 1, 0, 0]) for r in range(3)] == [0.0, 1.0, 2.0]
        assert float(k2d[:, 0].abs().sum() + k2d[:, 2].abs().sum()) == 0.0

    def test_too_many_taps_raises(self):
        with pytest.raises(ValueError, match="exceed 2-D kernel height"):
            T.project_weights_to_2d(torch.ones((4, 1, 1)), kh=3)


@given(t=st.integers(1, 50), d=st.integers(1, 9))
@settings(max_examples=25, deadline=None)
def test_wrap_unwrap_roundtrip_and_parity(t, d):
    x = np.random.RandomState(t * 10 + d).randn(2, t, 3).astype(np.float32)
    z = T.wrap_time_axis(torch.from_numpy(x), d)
    np.testing.assert_array_equal(_np(z), _np(J.wrap_time_axis(jnp.asarray(x), d)))
    np.testing.assert_array_equal(_np(T.unwrap_time_axis(z, t)), x)


def test_wrap_keeps_int8_trits():
    """The fused backend wraps int8 activation maps."""
    x = np.random.RandomState(3).randint(-1, 2, (2, 7, 4)).astype(np.int8)
    z = T.wrap_time_axis(torch.from_numpy(x), 4)
    assert z.dtype == torch.int8 and tuple(z.shape) == (2, 2, 4, 4)
    np.testing.assert_array_equal(_np(z), _np(J.wrap_time_axis(jnp.asarray(x), 4)))


def test_conv2d_undilated_equal_on_trits():
    rng = np.random.RandomState(4)
    z = rng.randint(-1, 2, (2, 6, 4, 8)).astype(np.float32)
    k = rng.randint(-1, 2, (3, 3, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(T.conv2d_undilated(torch.from_numpy(z), torch.from_numpy(k))),
        _np(J.conv2d_undilated(jnp.asarray(z), jnp.asarray(k))),
    )


def test_receptive_field():
    for taps, dil in [(2, [1, 2, 4, 8, 16]), (3, [1] * 12), (3, [1, 2, 4])]:
        assert T.receptive_field(taps, dil) == J.receptive_field(taps, dil)
    assert T.receptive_field(3, [1, 2, 4]) == 1 + 2 * (1 + 2 + 4)


class TestTCNStream:
    def test_ring_push_ordered_across_cursor_wrap_equal_reference(self):
        """30 pushes into a 24-step ring: the cursor wraps; contents, cursor
        and ordered view match the reference at every step."""
        st_t = T.TCNStream.create(24, 96, device="cpu")
        st_j = J.TCNStream.create(24, 96)
        rng = np.random.RandomState(0)
        for i in range(30):
            v = rng.randint(-1, 2, (96,)).astype(np.float32)
            st_t = st_t.push(torch.from_numpy(v))
            st_j = st_j.push(jnp.asarray(v))
            assert int(st_t.cursor) == int(st_j.cursor)
            np.testing.assert_array_equal(_np(st_t.buf), _np(st_j.buf))
            np.testing.assert_array_equal(_np(st_t.ordered()), _np(st_j.ordered()))

    def test_ring_semantics(self):
        s = T.TCNStream.create(24, 96, device="cpu")
        for i in range(30):
            s = s.push(torch.full((96,), float(i)))
        np.testing.assert_array_equal(
            _np(s.ordered()[:, 0]), np.arange(6, 30, dtype=np.float32))

    def test_batched_and_row_shaped_pushes(self):
        s = T.TCNStream.create(4, 8, batch=3, device="cpu")
        s = s.push(torch.ones((3, 8)))
        assert tuple(s.buf.shape) == (3, 4, 8) and float(s.buf[:, 0].sum()) == 24.0
        # a [1, C] row into a batch-free [T, C] ring, as a lone session pushes
        r = T.TCNStream.create(4, 8, device="cpu").push(torch.ones((1, 8)))
        assert tuple(r.buf.shape) == (4, 8) and float(r.buf[0].sum()) == 8.0

    def test_push_leaves_the_old_ring_untouched(self):
        """Value semantics, as in the reference: an exported state must not
        change when the session it came from steps on."""
        s0 = T.TCNStream.create(4, 2, device="cpu")
        s1 = s0.push(torch.ones(2))
        assert float(s0.buf.sum()) == 0.0 and int(s0.cursor) == 0
        assert float(s1.buf.sum()) == 2.0 and int(s1.cursor) == 1

    def test_stream_state_create(self):
        s = T.StreamState.create(6, 12, batch=2, device="cpu")
        assert tuple(s.ring.buf.shape) == (2, 6, 12) and int(s.steps_seen) == 0
