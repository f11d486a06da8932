"""`repro_torch.kernels` held against `repro.kernels` on the CPU.

On a CPU tensor the port's `ternary_conv2d` wrapper takes the plain PyTorch
version of the fused conv kernel; the CUDA kernel itself is held against
that plain version on the card by `chip_smoke.py` (and by the ``gpu``-marked
test at the bottom, which skips on hosts without a CUDA device).

Same numpy inputs go to both packages.  The reference runs as its own tests
run it on the CPU: ``impl="native"``, the Pallas interpreter
(``impl="interpret"``) and the `kernels.ref` oracle.

Tolerances: on ternary/dyadic inputs every partial sum is an integer (or a
multiple of 1/4) and exact in float32 under any order, so results must be
**equal**.  On Gaussian inputs the summation order differs between the
packages: ``rtol=1e-5, atol=1e-5`` (sums of <= 864 float32 products).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.ternary import pack_ternary as pack_j
from repro.kernels.ops import ternary_conv2d as conv_j
from repro.kernels.ref import ternary_conv2d_ref as ref_j
from repro_torch.kernels import build
from repro_torch.kernels.ops import ternary_conv2d as conv_t
from repro_torch.kernels.ref import ternary_conv2d_ref as ref_t
from repro_torch.kernels.ternary_conv2d import (
    ternary_conv2d_cuda,
    ternary_conv2d_native,
    tile_shape,
)

TORCH_DT = {"float32": torch.float32, "int8": torch.int8}
JAX_DT = {"float32": jnp.float32, "int8": jnp.int8}


def _case(b, h, w, c_in, c_out, k, seed, dyadic=False, per_channel=True):
    """numpy operands: trit (or dyadic) activations, packed trit weights,
    positive scales, per-channel or scalar threshold."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-1, 2, (b, h, w, c_in)).astype(np.float32)
    if dyadic:
        x = x * 0.25 * rng.randint(1, 5, x.shape)
    t = rng.randint(-1, 2, (k, k, c_in, c_out)).astype(np.int8)
    wp = np.array(pack_j(jnp.asarray(t), axis=2))  # a writable copy
    scale = (np.abs(rng.randn(c_out)) * 0.2 + 0.05).astype(np.float32)
    thr = (np.abs(rng.randn(c_out)) * 0.6 + 0.1).astype(np.float32) if per_channel else 0.3
    return x.astype(np.float32), wp, scale, thr


def _torch_args(x, wp, scale, thr, x_dtype="float32"):
    thr_t = torch.from_numpy(thr) if isinstance(thr, np.ndarray) else thr
    return (torch.from_numpy(x.astype(x_dtype)), torch.from_numpy(wp.copy()),
            torch.from_numpy(scale)), thr_t


def _jax_args(x, wp, scale, thr, x_dtype="float32"):
    thr_j = jnp.asarray(thr) if isinstance(thr, np.ndarray) else thr
    return (jnp.asarray(x.astype(x_dtype)), jnp.asarray(wp), jnp.asarray(scale)), thr_j


# (b, h, w, c_in, c_out, k, pool) — the shapes of tests/test_kernels.py and
# tests/test_fused_backend.py at test size, plus the registry's 1x1 / 5x5
SHAPES = [
    (1, 8, 8, 16, 32, 3, 2),
    (2, 16, 16, 96, 96, 3, 2),     # CUTIE native layer
    (2, 7, 5, 8, 16, 3, 0),        # odd sizes
    (2, 5, 9, 8, 16, 3, 0),
    (1, 6, 6, 4, 10, 3, 2),        # ragged C_out (non-dividing block upstream)
    (2, 6, 6, 8, 6, 3, 2),         # ragged C_out 6
    (1, 9, 3, 12, 9, 3, 3),        # ragged C_out 9, pool window 3
    (1, 25, 1, 96, 96, 3, 0),      # mapped TCN layer, D=1 (+ causal row)
    (1, 4, 8, 96, 96, 3, 0),       # mapped TCN layer, D=8
    (2, 8, 8, 8, 12, 1, 0),        # 1x1 pointwise (kws_tcn)
    (1, 8, 8, 4, 16, 5, 2),        # 5x5 stem (cifar10_tnn_wide)
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("x_dtype", ["float32", "int8"])
def test_fused_equal_to_reference_native_and_ref(shape, x_dtype):
    b, h, w, c_in, c_out, k, pool = shape
    x, wp, scale, thr = _case(b, h, w, c_in, c_out, k, seed=sum(shape))
    (xt, wt, st), tt = _torch_args(x, wp, scale, thr, x_dtype)
    (xj, wj, sj), tj = _jax_args(x, wp, scale, thr, x_dtype)
    for out_name in ("int8", "float32"):
        kw = dict(fuse_ternary=True, fuse_pool=pool)
        got = conv_t(xt, wt, st, threshold=tt, out_dtype=TORCH_DT[out_name], **kw)
        want = conv_j(xj, wj, sj, threshold=tj, impl="native",
                      out_dtype=JAX_DT[out_name], **kw)
        assert got.dtype == TORCH_DT[out_name]
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        oracle = ref_j(xj, wj, sj, fuse_ternary=True, threshold=tj, fuse_pool=pool,
                       out_dtype=JAX_DT[out_name])
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
        mine = ref_t(xt, wt, st, fuse_ternary=True, threshold=tt, fuse_pool=pool,
                     out_dtype=TORCH_DT[out_name])
        np.testing.assert_array_equal(got.numpy(), mine.numpy())
    # plain variant: scaled float accumulator out
    got = conv_t(xt, wt, st, out_dtype=torch.float32)
    want = conv_j(xj, wj, sj, impl="native", out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ref_t(xt, wt, st, out_dtype=torch.float32).numpy())


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[4], SHAPES[6], SHAPES[9]],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_equal_to_pallas_interpreter(shape):
    """The reference's Pallas kernel itself, run by its interpreter."""
    b, h, w, c_in, c_out, k, pool = shape
    x, wp, scale, thr = _case(b, h, w, c_in, c_out, k, seed=17 + sum(shape))
    (xt, wt, st), tt = _torch_args(x, wp, scale, thr)
    (xj, wj, sj), tj = _jax_args(x, wp, scale, thr)
    kw = dict(fuse_ternary=True, fuse_pool=pool)
    got = conv_t(xt, wt, st, threshold=tt, out_dtype=torch.int8, **kw)
    want = conv_j(xj, wj, sj, threshold=tj, impl="interpret", out_dtype=jnp.int8, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dyadic_window_input_and_scalar_threshold_equal():
    """The first TCN layer's input: float32 multiples of 1/4 (means of 4
    trits), scalar threshold splatted across channels."""
    x, wp, scale, thr = _case(2, 9, 2, 12, 12, 3, seed=5, dyadic=True, per_channel=False)
    (xt, wt, st), tt = _torch_args(x, wp, scale, thr)
    (xj, wj, sj), tj = _jax_args(x, wp, scale, thr)
    got = conv_t(xt, wt, st, fuse_ternary=True, threshold=tt, out_dtype=torch.int8)
    want = conv_j(xj, wj, sj, fuse_ternary=True, threshold=tj, impl="native",
                  out_dtype=jnp.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {-1, 0, 1}


def test_channel_pad_to_pack_quantum():
    """C_in=3 activations against C_in/4=1 packed weights: the wrapper pads."""
    rng = np.random.RandomState(8)
    x = rng.randint(-1, 2, (2, 8, 8, 3)).astype(np.float32)
    _, wp, scale, thr = _case(2, 8, 8, 4, 8, 3, seed=9)
    got = conv_t(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(scale))
    want = conv_j(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), impl="native")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gaussian_inputs_close():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 12, 32).astype(np.float32)
    _, wp, scale, _ = _case(2, 12, 12, 32, 24, 3, seed=4)
    got = conv_t(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(scale))
    want = conv_j(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), impl="native")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    oracle = ref_t(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5, atol=1e-5)


def test_fused_pool_matches_ternarize_then_pool():
    x, wp, scale, thr = _case(2, 8, 8, 8, 8, 3, seed=6)
    (xt, wt, st), tt = _torch_args(x, wp, scale, thr)
    fused = conv_t(xt, wt, st, fuse_ternary=True, threshold=tt, fuse_pool=2,
                   out_dtype=torch.int8)
    unpooled = ref_t(xt, wt, st, fuse_ternary=True, threshold=tt)
    pooled = unpooled.reshape(2, 4, 2, 4, 2, 8).amax(dim=(2, 4))
    assert tuple(fused.shape) == (2, 4, 4, 8)
    np.testing.assert_array_equal(fused.numpy(), pooled.numpy())


class TestErrors:
    def _ops(self):
        x, wp, scale, thr = _case(1, 6, 6, 8, 6, 3, seed=1)
        return _torch_args(x, wp, scale, thr)

    def test_threshold_vector_shape(self):
        (x, wp, sc), _ = self._ops()
        with pytest.raises(ValueError, match="threshold shape"):
            conv_t(x, wp, sc, fuse_ternary=True, threshold=torch.ones(5))

    def test_pool_must_divide_map(self):
        (x, wp, sc), thr = self._ops()
        with pytest.raises(ValueError, match="does not divide"):
            conv_t(x, wp, sc, fuse_ternary=True, threshold=thr, fuse_pool=4)

    def test_unpadded_channels_rejected_below_the_wrapper(self):
        (x, wp, sc), thr = self._ops()
        with pytest.raises(ValueError, match="pack quantum"):
            ternary_conv2d_native(x[..., :6], wp, sc, thr)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        """The kernel wrapper never computes on the host: a CPU tensor is an
        error there (the public wrapper routes it to the plain version)."""
        (x, wp, sc), thr = self._ops()
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ternary_conv2d_cuda(x, wp, sc, thr)

    def test_unknown_device_type_raises(self):
        (x, wp, sc), thr = self._ops()
        with pytest.raises(ValueError, match="no implementation for device"):
            conv_t(x.to("meta"), wp.to("meta"), sc.to("meta"))


def test_import_needs_no_toolchain_and_build_fails_loudly(tmp_path, monkeypatch):
    """Importing the kernel modules compiled nothing (this host has no
    nvcc); asking for the library without a toolkit raises — no fallback."""
    assert build.CSRC_DIR.joinpath("ternary_conv2d.cu").is_file()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    lib = build.library_path("ternary_conv2d.cu")
    assert lib.parent == tmp_path and lib.name.startswith("ternary_conv2d_")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("ternary_conv2d.cu")


@pytest.mark.parametrize("h,w,pool,expect", [
    (64, 64, 2, (8, 8)), (25, 1, 0, (64, 1)), (13, 2, 0, (32, 2)),
    (7, 4, 0, (16, 4)), (4, 8, 0, (8, 8)), (2, 2, 2, (32, 2)),
    (9, 9, 3, (6, 6)), (10, 10, 5, (5, 5)),
])
def test_tile_shape_holds_whole_pool_windows(h, w, pool, expect):
    th, tw = tile_shape(h, w, pool)
    assert (th, tw) == expect
    p = max(pool, 1)
    assert th * tw <= 64 and th % p == 0 and tw % p == 0


def test_tile_shape_rejects_oversized_pool():
    with pytest.raises(ValueError, match="pool windows up to"):
        tile_shape(32, 32, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_equals_plain_version_on_the_card(shape):
    """The hand-written kernel against its plain version on the card
    (tolerance 0).  Needs a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    b, h, w, c_in, c_out, k, pool = shape
    x, wp, scale, thr = _case(b, h, w, c_in, c_out, k, seed=sum(shape))
    for x_dtype in ("float32", "int8"):
        (xt, wt, st), tt = _torch_args(x, wp, scale, thr, x_dtype)
        xt, wt, st, tt = (a.cuda() for a in (xt, wt, st, tt))
        before = ternary_conv2d_cuda.launches
        got = conv_t(xt, wt, st, fuse_ternary=True, threshold=tt, fuse_pool=pool,
                     out_dtype=torch.int8)
        assert ternary_conv2d_cuda.launches == before + 1
        want = ternary_conv2d_native(xt, wt, st, tt, fuse_ternary=True,
                                     fuse_pool=pool, out_dtype=torch.int8)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "int8"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[7], SHAPES[10]],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_is_deterministic_on_gaussian_data(shape, x_dtype):
    """Eight launches on the same non-ternary input give the same bits: the
    warps' partial tiles are summed in warp order, no atomics.  Needs a
    CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    b, h, w, c_in, c_out, k, pool = shape
    _, wp, scale, thr = _case(b, h, w, c_in, c_out, k, seed=3 + sum(shape))
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(b, h, w, c_in) if x_dtype == "float32" else rng.randint(-100, 101, (b, h, w, c_in))
    (xt, wt, st), tt = _torch_args(x.astype(np.float32), wp, scale, thr, x_dtype)
    xt, wt, st, tt = (a.cuda() for a in (xt, wt, st, tt))
    # the unternarized accumulator; int8 x needs float32 out named, or the
    # wrapper refuses int8 out without fuse_ternary
    kw = dict(fuse_pool=pool, out_dtype=torch.float32)
    outs = [ternary_conv2d_cuda(xt, wt, st, tt, **kw) for _ in range(8)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    if x_dtype == "int8":  # integer sums: exact on the tensor cores
        assert torch.equal(outs[0], ternary_conv2d_native(xt, wt, st, tt, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (8, 64, 64, 4, 64, 3, 2),      # conv0 of dvs_cnn_tcn at pool 8
    (8, 25, 1, 96, 96, 3, 0),      # its first TCN layer
    (2, 32, 32, 4, 192, 5, 2),     # the 5x5 stem of cifar10_tnn_wide
], ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_float32_route_close_on_gaussian_data(shape):
    """Gaussian float32 x needs all three bf16 terms (hi, mid, lo) of the
    kernel's float32 route: within the reference's Gaussian tolerance of the
    plain version, pooled and not.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    b, h, w, c_in, c_out, k, pool = shape
    _, wp, scale, thr = _case(b, h, w, c_in, c_out, k, seed=5 + sum(shape))
    x = np.random.RandomState(sum(shape)).randn(b, h, w, c_in).astype(np.float32)
    (xt, wt, st), tt = _torch_args(x, wp, scale, thr)
    xt, wt, st, tt = (a.cuda() for a in (xt, wt, st, tt))
    for fuse_pool in sorted({0, pool}):
        got = ternary_conv2d_cuda(xt, wt, st, tt, fuse_pool=fuse_pool)
        want = ternary_conv2d_native(xt, wt, st, tt, fuse_pool=fuse_pool)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cifar10_tnn", "cifar10_tnn_wide", "kws_tcn", "dvs_cnn_tcn"])
def test_full_width_registry_nets_fused_equals_ref_on_the_card(name):
    """Every full-width registry net through the kernel (3x3, the 5x5 stem
    with its large shared-memory tile, 1x1, strided layers, unfused pools on
    int8 maps) equals the ``ref`` backend on the card.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    from repro_torch.api import get_net

    prog = get_net(name)
    g = prog.graph
    rng = np.random.RandomState(0)
    lead = (2, 3) if g.is_temporal else (2,)
    x = rng.randint(-1, 2, (*lead, *g.input_hw, g.input_ch)).astype(np.float32)
    x = torch.from_numpy(x).cuda()
    dep = prog.quantize(prog.init(torch.Generator().manual_seed(0)), calib=x)
    before = ternary_conv2d_cuda.launches
    fused = dep.forward(x, backend="fused")
    assert ternary_conv2d_cuda.launches > before
    assert fused.is_cuda and torch.isfinite(fused).all()
    assert torch.equal(fused, dep.forward(x, backend="ref"))
