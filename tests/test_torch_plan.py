"""What surrounds the two Hopper kernels, held on the CPU: the host-side
plans that tile them, the exact three-way bf16 split the float32 route
feeds to the tensor cores, the implicit-GEMM view of the conv, and the
build's rebuild key.

None of it needs a card: the kernels take their plans as arguments and
check them, and the plain functions here are what the CUDA sources
compute.  Same numpy inputs go to the reference where a reference exists.
"""
import ctypes
import math
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.ternary import pack_ternary as pack_j
from repro.kernels.ops import ternary_conv2d as conv_j
from repro_torch.core.ternary import select_decode
from repro_torch.kernels import build
from repro_torch.kernels.ternary_conv2d import ConvPlan, conv_plan, tile_shape
from repro_torch.kernels.ternary_conv2d import _bind as bind_conv
from repro_torch.kernels.ternary_matmul import (
    MAX_SPLITS,
    MMA_K,
    matmul_plan,
    split_bf16x3,
)
from repro_torch.kernels.ternary_matmul import _bind as bind_matmul

# (M, K, N): the quickstart, the kernel bench, the reference's test shapes,
# a split boundary that falls mid-chunk, and ragged last splits
MATMUL_SHAPES = [
    (64, 2048, 512), (512, 2048, 512), (128, 512, 128), (256, 1024, 384),
    (8, 512, 128), (100, 100, 70), (1, 2048, 512), (384, 4, 128), (7, 100, 33),
    (64, 2052, 512), (3, 260, 40), (1, 4, 1),
]


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_plan_splits_cover_k_exactly(shape, dtype):
    m, k, n = shape
    plan = matmul_plan(m, k, n, dtype)
    assert 1 <= plan.splits <= MAX_SPLITS
    assert plan.k_split % MMA_K == 0
    # every split but the last is full, the last holds the rest (>= 1 row)
    assert (plan.splits - 1) * plan.k_split < k <= plan.splits * plan.k_split
    assert plan.block_k % MMA_K == 0 and plan.block_k % 4 == 0
    tiles = math.ceil(m / plan.block_m) * math.ceil(n / plan.block_n)
    assert plan.blocks(m, n) == tiles * plan.splits
    if tiles >= 128:
        assert plan.splits == 1  # enough tiles: no split, no cluster


def test_matmul_plan_fills_the_card_at_the_quickstart_shape():
    plan = matmul_plan(64, 2048, 512, torch.float32)
    assert plan.blocks(64, 512) >= 128
    assert (plan.k_split, plan.splits) == (256, 8)
    # the split boundary of 2052 falls inside a 64-deep chunk; still >= 128 blocks
    ragged = matmul_plan(64, 2052, 512, torch.float32)
    assert ragged.k_split % ragged.block_k != 0 and ragged.blocks(64, 512) >= 128


@pytest.mark.parametrize("bad", [(0, 16, 4), (4, 6, 4), (4, 16, 0)])
def test_matmul_plan_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        matmul_plan(*bad)
    with pytest.raises(ValueError, match="dtype"):
        matmul_plan(4, 16, 4, torch.float16)


_FINITE_NORMAL = st.floats(allow_nan=False, allow_infinity=False, width=32).filter(
    lambda v: v == 0.0 or abs(v) >= 2.0 ** -100)


@settings(max_examples=300, deadline=None)
@given(st.lists(_FINITE_NORMAL, min_size=1, max_size=64))
def test_split_bf16x3_is_exact_bit_for_bit(values):
    x = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # equal values are equal bits for every nonzero x (a zero may come back as +0)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    # and in the kernel's order (small terms first) too
    assert torch.equal((lo.float() + mid.float()) + hi.float(), x)


def test_split_bf16x3_of_bf16_exact_data_has_no_low_terms():
    """Binary frames and quarter-multiples are bf16-exact: the kernels then
    skip the mid and lo mmas, so those terms must be exactly zero."""
    x = torch.tensor([0.0, 1.0, -0.25, 0.75, -1.0, 3.5, 96.0])
    hi, mid, lo = split_bf16x3(x)
    assert torch.equal(hi.float(), x)
    assert not mid.float().any() and not lo.float().any()


# (b, h, w, c_in, c_out, k, pool, x dtype): a pool tick's nine launches at
# pool 8, and the shapes off the main path
CONV_SHAPES = [
    (8, 64, 64, 4, 64, 3, 2, torch.float32), (8, 32, 32, 64, 64, 3, 2, torch.int8),
    (8, 16, 16, 64, 96, 3, 2, torch.int8), (8, 8, 8, 96, 96, 3, 2, torch.int8),
    (8, 4, 4, 96, 96, 3, 2, torch.int8), (8, 25, 1, 96, 96, 3, 0, torch.float32),
    (8, 13, 2, 96, 96, 3, 0, torch.int8), (8, 7, 4, 96, 96, 3, 0, torch.int8),
    (8, 4, 8, 96, 96, 3, 0, torch.int8), (2, 16, 16, 64, 64, 1, 0, torch.int8),
    (2, 32, 32, 4, 192, 5, 2, torch.float32), (2, 6, 6, 8, 9, 3, 2, torch.int8),
    (2, 9, 9, 12, 10, 3, 3, torch.int8), (1, 10, 10, 8, 8, 3, 5, torch.float32),
    (2, 8, 8, 8, 8, 3, 8, torch.int8),
]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s[:7])))
def test_conv_plan_keeps_pool_windows_and_pads_the_reduction(shape):
    b, h, w, c_in, c_out, k, pool, dt = shape
    plan = conv_plan(b, h, w, c_in, c_out, k, k, pool, dt)
    p = max(pool, 1)
    assert plan.tile_h % p == 0 and plan.tile_w % p == 0       # whole windows
    assert plan.tile_h * plan.tile_w in range(p * p, 65)
    mma_k = 32 if dt == torch.int8 else 16        # int8 m16n8k32, bf16 m16n8k16
    assert plan.k_padded % mma_k == 0 and 0 <= plan.k_padded - k * k * c_in < mma_k
    rows = math.ceil(plan.tile_h * plan.tile_w / 16)
    assert plan.warps_per_rows == 4 // rows
    tiles = math.ceil(h / plan.tile_h) * math.ceil(w / plan.tile_w)
    assert plan.blocks == b * tiles * math.ceil(c_out / 32)


def test_conv_plan_takes_the_largest_tile_that_fills_the_card():
    # conv1 at pool 8 fills the card with 64-pixel tiles; conv2 needs 32;
    # conv3 cannot reach 132 blocks and takes the smallest tile
    assert conv_plan(8, 32, 32, 64, 64, 3, 3, 2).tile_h * 8 == 64
    c2 = conv_plan(8, 16, 16, 64, 96, 3, 3, 2)
    assert (c2.tile_h * c2.tile_w, c2.blocks) == (32, 192)
    c3 = conv_plan(8, 8, 8, 96, 96, 3, 3, 2)
    assert (c3.tile_h * c3.tile_w, c3.warps_per_rows) == (16, 4)


@pytest.mark.parametrize("h,w,pool,pixels,expect", [
    (8, 8, 2, 16, (2, 8)), (8, 8, 2, 32, (4, 8)), (25, 1, 0, 16, (16, 1)),
    (4, 4, 2, 16, (4, 4)), (9, 9, 3, 16, (3, 3)), (10, 10, 5, 32, (5, 5)),
])
def test_tile_shape_at_smaller_tiles(h, w, pool, pixels, expect):
    assert tile_shape(h, w, pool, pixels) == expect


def test_tile_shape_refuses_a_tile_smaller_than_the_window():
    with pytest.raises(ValueError, match="pool window"):
        tile_shape(10, 10, 5, 16)


def gemm_weight_bytes(w_packed: torch.Tensor, k_padded: int) -> torch.Tensor:
    """The conv kernel's B operand as a plain tensor: w_packed [KH, KW,
    C_in/4, C_out] viewed as [KH*KW*C_in/4, C_out] bytes — row q holds
    reduction rows 4q .. 4q+3 of the flattened (tap, channel) axis — with
    rows of 0x55 (four zero trits) appended up to ``k_padded / 4``."""
    kh, kw, c4, c_out = w_packed.shape
    rows = w_packed.reshape(kh * kw * c4, c_out)
    fill = torch.full((k_padded // 4 - rows.shape[0], c_out), 0x55, dtype=torch.uint8)
    return torch.cat([rows, fill])


@pytest.mark.parametrize("k,c_in,dt", [(3, 4, torch.float32), (3, 12, torch.int8),
                                       (1, 8, torch.int8), (5, 4, torch.float32)])
def test_implicit_gemm_over_the_padded_reduction_equals_the_reference_conv(k, c_in, dt):
    """The kernel's GEMM view on the CPU: im2col with (tap, channel) flattened,
    channel fastest, times the decoded `gemm_weight_bytes` (zero trits in the
    padding rows) equals the reference's conv."""
    rng = np.random.RandomState(k * 100 + c_in)
    b, h, w, c_out = 2, 6, 5, 10
    x = rng.randint(-1, 2, (b, h, w, c_in)).astype(np.float32)
    t = rng.randint(-1, 2, (k, k, c_in, c_out)).astype(np.int8)
    wp = np.array(pack_j(jnp.asarray(t), axis=2))
    scale = np.ones(c_out, np.float32)
    plan = conv_plan(b, h, w, c_in, c_out, k, k, 0, dt)
    red = k * k * c_in                                              # the unpadded reduction
    wb = gemm_weight_bytes(torch.from_numpy(wp.copy()), plan.k_padded)
    assert tuple(wb.shape) == (plan.k_padded // 4, c_out)
    assert (wb[red // 4:] == 0x55).all()
    wmat = select_decode(wb, axis=0, dtype=torch.float32)          # [k_padded, C_out]
    assert not wmat[red:].any()                                     # the padding is zero trits
    xp = np.pad(x, ((0, 0), (k // 2, k - 1 - k // 2), (k // 2, k - 1 - k // 2), (0, 0)))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(k) for dx in range(k)]
    a = np.concatenate(cols, axis=-1).reshape(b * h * w, red)       # channel fastest
    a = np.pad(a, ((0, 0), (0, plan.k_padded - red)))
    got = (torch.from_numpy(a) @ wmat).reshape(b, h, w, c_out)
    want = conv_j(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), impl="native")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_editing_a_shared_header_changes_the_library_key(tmp_path, monkeypatch):
    """A header shared by both kernels is part of each library's key: an edit
    to it rebuilds both, an unrelated file does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("ternary_matmul.cu", "ternary_conv2d.cu", "ternary_mma.cuh"):
        (csrc / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = {s: build.library_path(s) for s in ("ternary_matmul.cu", "ternary_conv2d.cu")}
    (csrc / "notes.txt").write_text("not a header")
    assert {s: build.library_path(s) for s in before} == before
    header = csrc / "ternary_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: build.library_path(s) for s in before}
    for s in before:
        assert after[s] != before[s] and after[s].parent == tmp_path / "build"
        assert after[s].name.startswith(s.split(".")[0] + "_")


@pytest.mark.parametrize("source,bind,plan_args", [
    ("ternary_conv2d.cu", bind_conv, ConvPlan._fields),
    ("ternary_matmul.cu", bind_matmul, ("block_m", "block_n", "k_split", "splits")),
])
def test_the_kernel_receives_the_whole_plan(source, bind, plan_args):
    """The wrapper's ctypes signature matches the source's C entry point
    (pointers as ``c_void_p``, ints as ``c_int``), and every field of the
    host plan is an argument the kernel checks."""
    src = (build.CSRC_DIR / source).read_text()
    entry = source.split(".")[0] + "_launch"
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S).group(1)
    names = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    lib = SimpleNamespace(**{entry: SimpleNamespace(argtypes=None, restype=None)})
    argtypes = bind(lib).argtypes
    assert len(argtypes) == len(names)
    for param, arg in zip(sig.split(","), argtypes):
        assert arg is (ctypes.c_void_p if "*" in param else ctypes.c_int), param
    i = names.index(plan_args[0])
    assert tuple(names[i:i + len(plan_args)]) == tuple(plan_args)
    body = src[src.index(sig):]
    for arg in plan_args:  # each one is checked before the launch
        assert re.search(rf"\b{arg}\s*(!=|<|%)", body), arg


@pytest.mark.parametrize("source", ["ternary_matmul.cu", "ternary_conv2d.cu"])
def test_kernel_sources_use_the_shared_mma_header_and_no_atomics(source):
    """Both kernels reach the tensor cores through the shared header and sum
    their partial tiles in a fixed order: no atomic anywhere, so two launches
    on the same inputs give the same bits."""
    src = (build.CSRC_DIR / source).read_text()
    header = (build.CSRC_DIR / "ternary_mma.cuh").read_text()
    assert '#include "ternary_mma.cuh"' in src
    assert "tmma::mma_" in src and "tmma::cp_async" in src
    assert "mma.sync.aligned" in header and "cp.async" in header
    for text in (src, header):
        # CUDA's atomic functions and the PTX atomic and reduction instructions
        assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text)
