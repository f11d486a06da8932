"""K2 of the port, the packed-ternary matmul, held against `repro.kernels` on
the CPU.

On a CPU tensor `repro_torch.kernels.ops.ternary_matmul` takes the plain
PyTorch version (`ternary_matmul_native`); the CUDA kernel itself is held
against that plain version on the card by `chip_smoke.py` and by the
``gpu``-marked test at the bottom, which skips on hosts without a CUDA
device.

The same numpy inputs go to both packages.  The reference runs as its own
tests run it on the CPU: ``impl="native"``, the Pallas interpreter
(``impl="interpret"``) and the `kernels.ref` oracle.

Tolerances: on ternary/dyadic x every partial sum is an integer or a
multiple of 1/4 and exact in float32 under any order, so results must be
**equal**, in float32 and in bf16 (the bf16 rounding of an exact float32
value is the same in both packages).  On Gaussian x the summation order
differs: ``rtol=atol=1e-4`` in float32 and ``2e-2`` in bf16, the
reference's own kernel-test tolerances.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ternary import pack_ternary as pack_j
from repro.kernels import quantize_pack_matmul_weights as qpack_j
from repro.kernels.ops import ternary_matmul as tmm_j
from repro.kernels.ref import ternary_matmul_ref as ref_j
from repro_torch.kernels import quantize_pack_matmul_weights as qpack_t
from repro_torch.kernels.ops import ternary_matmul as tmm_t
from repro_torch.kernels.ref import ternary_matmul_ref as ref_t
from repro_torch.kernels.ternary_matmul import (
    ternary_matmul_cuda,
    ternary_matmul_native,
)

# (M, K, N): the reference's kernel tests, plus a K the wrapper pads
SHAPES = [
    (128, 512, 128),      # exactly one reference block
    (256, 1024, 384),     # several blocks on every axis
    (8, 512, 128),        # M smaller than a block
    (100, 100, 70),       # nothing aligned
    (1, 2048, 512),       # decode-like single row
    (384, 4, 128),        # K of one packed word
    (7, 98, 33),          # K padded to the pack quantum (98 -> 100)
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case(m, k, n, seed, gaussian=False):
    """numpy operands: dyadic (trits times 1/4..1) or Gaussian x [M, K],
    packed trit weights [ceil(K/4), N] along K, positive scales [N]."""
    rng = np.random.RandomState(seed)
    if gaussian:
        x = rng.randn(m, k).astype(np.float32)
    else:
        x = (rng.randint(-1, 2, (m, k)) * 0.25 * rng.randint(1, 5, (m, k))).astype(np.float32)
    k4 = -(-k // 4)
    t = rng.randint(-1, 2, (4 * k4, n)).astype(np.int8)
    wp = np.array(pack_j(jnp.asarray(t), axis=0))
    scale = (np.abs(rng.randn(n)) * 0.2 + 0.05).astype(np.float32)
    return x, wp, scale


def _both(x, wp, scale, dtype):
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    xj = jnp.asarray(x).astype(JAX_DT[dtype])
    return ((xt, torch.from_numpy(wp.copy()), torch.from_numpy(scale)),
            (xj, jnp.asarray(wp), jnp.asarray(scale)))


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32).numpy()
    return np.asarray(y, np.float32)


def _pad_k(x, wp):
    return np.pad(x, ((0, 0), (0, 4 * wp.shape[0] - x.shape[1])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_equal_to_reference_on_dyadic_data(shape, dtype):
    m, k, n = shape
    x, wp, scale = _case(m, k, n, seed=sum(shape))
    (xt, wt, st), (xj, wj, sj) = _both(x, wp, scale, dtype)
    got = tmm_t(xt, wt, st)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (m, n)
    want = tmm_j(xj, wj, sj, impl="native")
    np.testing.assert_array_equal(_np(got), _np(want))
    # the plain version and both oracles on the K-padded operand
    (xpt, _, _), (xpj, _, _) = _both(_pad_k(x, wp), wp, scale, dtype)
    np.testing.assert_array_equal(_np(got), _np(ternary_matmul_native(xpt, wt, st)))
    np.testing.assert_array_equal(_np(got), _np(ref_t(xpt, wt, st)))
    np.testing.assert_array_equal(_np(got), _np(ref_j(xpj, wj, sj)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[5]],
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_equal_to_pallas_interpreter(shape, dtype):
    """The reference's Pallas kernel itself, run by its interpreter."""
    m, k, n = shape
    x, wp, scale = _case(m, k, n, seed=31 + sum(shape))
    (xt, wt, st), (xj, wj, sj) = _both(x, wp, scale, dtype)
    want = tmm_j(xj, wj, sj, impl="interpret")
    np.testing.assert_array_equal(_np(tmm_t(xt, wt, st)), _np(want))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_close_to_reference_on_gaussian_weights_and_inputs(shape):
    """The reference's `test_shapes_match_ref`: Gaussian x and Gaussian
    weights quantized by the reference, handed over as bytes."""
    m, k, n = shape
    rng = np.random.RandomState(m + n)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    wp_j, sc_j = qpack_j(jnp.asarray(w))
    wp, sc = np.array(wp_j), np.array(sc_j)
    got = tmm_t(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(sc))
    want = tmm_j(jnp.asarray(x), wp_j, sc_j, impl="native")
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    xp = _pad_k(x, wp)
    np.testing.assert_allclose(_np(got), _np(ref_j(jnp.asarray(xp), wp_j, sc_j)),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_and_bf16_scale(dtype):
    """The reference's `test_dtypes`: Gaussian x in the working type, the
    scale cast to it too; the output keeps x's type."""
    x, wp, scale = _case(128, 512, 128, seed=4, gaussian=True)
    (xt, wt, st), (xj, wj, sj) = _both(x, wp, scale, dtype)
    got = tmm_t(xt, wt, st.to(TORCH_DT[dtype]))
    assert got.dtype == TORCH_DT[dtype]
    want = tmm_j(xj, wj, sj.astype(JAX_DT[dtype]), impl="native")
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    oracle = ref_j(xj, wj, sj.astype(JAX_DT[dtype]))
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


def test_leading_batch_dims():
    x, wp, scale = _case(2 * 3 * 16, 256, 96, seed=5)
    x4 = x.reshape(2, 3, 16, 256)
    got = tmm_t(torch.from_numpy(x4), torch.from_numpy(wp), torch.from_numpy(scale))
    assert tuple(got.shape) == (2, 3, 16, 96)
    want = tmm_j(jnp.asarray(x4), jnp.asarray(wp), jnp.asarray(scale), impl="native")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = tmm_t(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.reshape(-1, 96).numpy(), flat.numpy())


def test_truncating_pack_raises_and_plain_version_checks_k():
    x = torch.zeros(4, 16)
    wp = torch.full((2, 4), 0x55, dtype=torch.uint8)  # K = 8 < 16
    with pytest.raises(ValueError, match="never truncates"):
        tmm_t(x, wp, torch.ones(4))
    with pytest.raises(ValueError, match="pack quantum"):
        ternary_matmul_native(torch.zeros(4, 6), wp, torch.ones(4))


def test_devices_other_than_cpu_and_cuda_raise():
    """The device decides: CPU -> plain version, CUDA -> kernel, else raise;
    the kernel's wrapper refuses host tensors (no quiet CPU path)."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        tmm_t(x, torch.zeros(2, 4, dtype=torch.uint8, device="meta"),
              torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ternary_matmul_cuda(torch.zeros(4, 8), torch.zeros(2, 4, dtype=torch.uint8),
                            torch.ones(4))


@pytest.mark.parametrize("shape,nu", [((512, 128), 0.7), ((100, 70), 0.7),
                                      ((4, 128), 0.7), ((98, 33), 0.4)])
def test_quantize_pack_matmul_weights_bytes_equal_reference(shape, nu):
    w = np.random.RandomState(shape[0] + shape[1]).randn(*shape).astype(np.float32)
    wp_t, sc_t = qpack_t(torch.from_numpy(w), nu=nu)
    wp_j, sc_j = qpack_j(jnp.asarray(w), nu=nu)
    assert wp_t.dtype == torch.uint8 and tuple(wp_t.shape) == (-(-shape[0] // 4), shape[1])
    # a byte may only differ where |w| sits within one ulp of the TWN threshold
    differ = np.argwhere(wp_t.numpy() != np.asarray(wp_j))
    assert differ.size == 0, f"packed bytes differ at {differ[:4].tolist()}"
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6, atol=0)


def test_kernel_source_is_cuda_cpp_with_a_plain_c_interface():
    src = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
           / "ternary_matmul.cu").read_text()
    assert 'extern "C" int ternary_matmul_launch' in src
    assert "__global__" in src and "cudaGetLastError" in src
    assert "_tmm_kernel" in src  # names the TPU kernel it replaces
    for banned in ("torch/extension.h", "cublas", "cutlass/gemm/device", "wmma"):
        assert banned not in src


# the quickstart and the kernel bench, and K-splits whose boundary falls
# inside a chunk with a ragged last split
CARD_SHAPES = SHAPES + [(64, 2048, 512), (512, 2048, 512), (64, 2052, 512), (3, 260, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_equals_plain_version_on_the_card(shape, dtype):
    """The hand-written kernel against its plain version on the card
    (tolerance 0 on dyadic x).  Needs a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    m, k, n = shape
    x, wp, scale = _case(m, k, n, seed=sum(shape))
    (xt, wt, st), _ = _both(x, wp, scale, dtype)
    xt, wt, st = xt.cuda(), wt.cuda(), st.cuda()
    before = ternary_matmul_cuda.launches
    got = tmm_t(xt, wt, st)
    assert ternary_matmul_cuda.launches == before + 1
    xp = torch.nn.functional.pad(xt, (0, 4 * wp.shape[0] - k))
    assert torch.equal(got, ternary_matmul_native(xp, wt, st))
    assert torch.equal(got, ref_t(xp, wt, st))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 2048, 512), (512, 2048, 512), (3, 260, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_is_deterministic_and_close_on_gaussian_data(shape, dtype):
    """Two launches on the same Gaussian x give the same bits (the K-split
    partials are summed in cluster-rank order, no atomics), within the
    reference's tolerance of the plain version.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    m, k, n = shape
    x, wp, scale = _case(m, k, n, seed=7 + sum(shape), gaussian=True)
    (xt, wt, st), _ = _both(x, wp, scale, dtype)
    xt, wt, st = xt.cuda(), wt.cuda(), st.cuda()
    first = ternary_matmul_cuda(xt, wt, st)
    assert torch.equal(first, ternary_matmul_cuda(xt, wt, st))
    want = ternary_matmul_native(xt, wt, st)
    np.testing.assert_allclose(_np(first.cpu()), _np(want.cpu()), **TOL[dtype])
