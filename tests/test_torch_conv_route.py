"""K1's two routes: which launch takes which, what the wgmma route's plan
and entry point agree on, and a plain-Python model of its tile walk.

`conv_plan` picks the route from the launch's shape alone: the persistent
wgmma kernel (route 1) for int8 x with C_in % 32 == 0, C_out 64 or 96, no
pool or a 2x2 one, and at least `WG_MIN_TILES` 8x8 tiles and
`WG_MIN_PIXELS` output pixels; the mma.sync kernel (route 0) for the rest.
None of that needs a card.  The ``gpu`` tests at the bottom hold route 1
against the plain version and the oracle on the card; they skip elsewhere.
"""
import importlib
import math
import re
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ternary_conv2d import conv_plan, conv_route

tc = importlib.import_module("repro_torch.kernels.ternary_conv2d")

# (name, B, H, W, C_in, C_out, K, pool, x dtype): the 8 launches of one
# cifar10_tnn step at the classifier's batch (conv 1's 3 channels padded to 4)
CIFAR_B256 = [
    ("conv1", 256, 32, 32, 4, 96, 3, 0, torch.float32),
    ("conv2", 256, 32, 32, 96, 96, 3, 2, torch.int8),
    ("conv3", 256, 16, 16, 96, 96, 3, 0, torch.int8),
    ("conv4", 256, 16, 16, 96, 96, 3, 0, torch.int8),
    ("conv5", 256, 16, 16, 96, 96, 3, 2, torch.int8),
    ("conv6", 256, 8, 8, 96, 96, 3, 0, torch.int8),
    ("conv7", 256, 8, 8, 96, 96, 3, 0, torch.int8),
    ("conv8", 256, 8, 8, 96, 96, 3, 2, torch.int8),
]
# (name, H, W, C_in, C_out, K, pool, x dtype): the 9 launches of one
# dvs_cnn_tcn pool tick (chip_smoke.MAIN_PATH_SHAPES)
DVS_TICK = [
    ("conv0", 64, 64, 4, 64, 3, 2, torch.float32),
    ("conv1", 32, 32, 64, 64, 3, 2, torch.int8),
    ("conv2", 16, 16, 64, 96, 3, 2, torch.int8),
    ("conv3", 8, 8, 96, 96, 3, 2, torch.int8),
    ("conv4", 4, 4, 96, 96, 3, 2, torch.int8),
    ("tcn_d1", 25, 1, 96, 96, 3, 0, torch.float32),
    ("tcn_d2", 13, 2, 96, 96, 3, 0, torch.int8),
    ("tcn_d4", 7, 4, 96, 96, 3, 0, torch.int8),
    ("tcn_d8", 4, 8, 96, 96, 3, 0, torch.int8),
]
# chip_smoke.EXTRA_SHAPES, launched at B = 2: (name, H, W, C_in, C_out, K, pool)
EXTRA_SHAPES = [
    ("1x1", 16, 16, 64, 64, 1, 0),
    ("5x5_stem", 32, 32, 4, 192, 5, 2),
    ("ragged_cout", 6, 6, 8, 9, 3, 2),
    ("odd_hw", 7, 5, 8, 6, 3, 0),
    ("pool3", 9, 9, 12, 10, 3, 3),
]
SOURCE = (build.CSRC_DIR / tc.SOURCE).read_text()


def _route(b, h, w, c_in, c_out, k, pool, dt) -> int:
    return conv_plan(b, h, w, c_in, c_out, k, k, pool, dt).route


def test_seven_of_cifar10_tnn_s_eight_launches_at_batch_256_take_the_wgmma_route():
    routes = {name: _route(*shape) for name, *shape in CIFAR_B256}
    assert routes == {"conv1": 0, **{f"conv{i}": 1 for i in range(2, 9)}}


@pytest.mark.parametrize("batch,want", [
    (8, [0] * 9),                        # the pool-8 tick: no launch fills the card
    (64, [0, 1, 1, 0, 0, 0, 0, 0, 0]),  # the pool-64 tick: the 32x32 and 16x16 maps
    (1, [0] * 9),                        # a lone session
    (256, [0, 1, 1, 1, 1, 0, 1, 1, 1]),  # every int8 launch, once a pool fills the card
])
def test_dvs_cnn_tcn_tick_routes(batch, want):
    assert [_route(batch, *shape) for _, *shape in DVS_TICK] == want


@pytest.mark.parametrize("shape", EXTRA_SHAPES, ids=lambda s: s[0])
@pytest.mark.parametrize("dt", [torch.float32, torch.int8])
def test_the_shapes_off_the_main_path_stay_on_the_mma_route(shape, dt):
    _, h, w, c_in, c_out, k, pool = shape
    assert _route(2, h, w, c_in, c_out, k, pool, dt) == 0


@pytest.mark.parametrize("change,route", [
    ({}, 1),
    ({"x_dtype": torch.float32}, 0),   # float32 x: the three-way bf16 split
    ({"c_in": 48}, 0),                 # a k32 step would straddle two taps
    ({"c_out": 80}, 0),                # not a wgmma N the kernel is built for
    ({"c_out": 64}, 1),
    ({"fuse_pool": 3}, 0),
    ({"fuse_pool": 1}, 1),
    ({"b": 1}, 0),                     # 16 tiles: below the crossover
    ({"b": 8}, 0),                     # 128 tiles: fewer than one per SM
    ({"b": 9}, 1),                     # 144 tiles, 9216 pixels
    ({"k": 7}, 0),                     # 7x7x96x96 decoded weights outgrow shared memory
])
def test_the_route_follows_the_shape_alone(change, route):
    args = dict(b=256, h=32, w=32, c_in=96, c_out=96, k=3, fuse_pool=2, x_dtype=torch.int8)
    args.update(change)
    got = conv_route(args["b"], args["h"], args["w"], args["c_in"], args["c_out"],
                     args["k"], args["k"], args["fuse_pool"], args["x_dtype"])
    assert got == route


def test_the_crossover_needs_both_tiles_and_pixels():
    # a tile per SM (132) and 1024 pixels: 4x4 maps hold 16 real pixels a
    # tile, 13x2 maps two tiles of 13, 1x1 maps one pixel a tile
    assert conv_route(132, 4, 4, 96, 96, 3, 3, 2) == 1     # 132 tiles, 2112 pixels
    assert conv_route(131, 4, 4, 96, 96, 3, 3, 2) == 0     # 131 tiles
    assert conv_route(66, 13, 2, 96, 96, 3, 3, 0) == 1     # 132 tiles, 1716 pixels
    assert conv_route(65, 13, 2, 96, 96, 3, 3, 0) == 0     # 130 tiles
    assert conv_route(1023, 1, 1, 96, 96, 1, 1, 0) == 0    # 1023 tiles, 1023 pixels
    assert conv_route(1024, 1, 1, 96, 96, 1, 1, 0) == 1    # 1024 tiles, 1024 pixels


def _src_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_the_plan_s_constants_are_the_source_s():
    assert tc._WG_TILE == _src_int("kWgTile")
    assert tc._WG_GROUPS == _src_int("kWgGroups")
    assert tc.TARGET_BLOCKS == _src_int("kWgMaxBlocks")
    assert tc._WG_MAX_SMEM == _src_int("kWgMaxSmem")
    assert tc._TILE_PIXELS == _src_int("kTilePix")
    widths = re.search(r"\(C_out != (\d+) && C_out != (\d+)\)", SOURCE).groups()
    assert tuple(int(v) for v in widths) == tc._WG_WIDTHS
    assert "wg_pixel_stride(int c_in) { return c_in + 16; }" in SOURCE
    assert "wg_stage_stride(int n) { return n + 16; }" in SOURCE


def test_wg_smem_bytes_counts_the_block_s_shared_memory():
    # 3x3x96x96: B 27 k-steps x 32 x 96; k-step table, scales, thresholds;
    # per warpgroup two 10x10-pixel patches of 112 B and 4 x 16 staging rows
    b_operand = 27 * 32 * 96
    fixed = b_operand + 112 + 384 + 384
    group = 2 * 10 * 10 * 112 + 4 * 16 * 112
    assert tc.wg_smem_bytes(3, 3, 96, 96) == fixed + tc._WG_GROUPS * group == 202096
    assert tc.wg_smem_bytes(3, 3, 96, 96) <= tc._WG_MAX_SMEM


@pytest.mark.parametrize("shape", [s[1:] for s in CIFAR_B256 if s[-1] == torch.int8]
                         + [(256, *s[1:]) for s in DVS_TICK if s[-1] == torch.int8],
                         ids=str)
def test_the_wgmma_plan_is_what_its_entry_point_checks(shape):
    b, h, w, c_in, c_out, k, pool, dt = shape
    plan = conv_plan(b, h, w, c_in, c_out, k, k, pool, dt)
    assert plan.route == 1
    assert (plan.tile_h, plan.tile_w) == (8, 8)
    assert plan.k_padded == k * k * c_in and plan.k_padded % 32 == 0   # no padding
    assert plan.warps_per_rows == 1
    tiles = b * math.ceil(h / 8) * math.ceil(w / 8)
    assert plan.blocks == min(132, tiles)


def test_each_route_of_the_entry_point_checks_every_plan_field():
    """Both routes refuse a plan that is not their own arithmetic: every
    field after ``route`` is compared in the route's own block."""
    body = SOURCE[SOURCE.index('extern "C" int ternary_conv2d_launch('):]
    wg_block = body[body.index("if (route == 1)"):body.index("// route 0:")]
    mma_block = body[body.index("// route 0:"):]
    assert re.search(r"route < 0 \|\|\s*route > 1", body)
    for field in ("tile_h", "tile_w", "k_padded", "warps_per_rows", "blocks"):
        assert re.search(rf"\b{field} != ", wg_block), field
    for field in ("k_padded", "warps_per_rows", "blocks"):
        assert re.search(rf"\b{field} != ", mma_block), field
    # the wgmma route refuses what it cannot compute
    for cond in ("!x_is_int8", "C_in % 32", "pool > 2", "> kWgMaxSmem"):
        assert cond in wg_block, cond


# ---------------------------------------------------------------------------
# the wgmma kernel's tile walk and fragment layout, in plain Python
# ---------------------------------------------------------------------------

def walk_tiles(blocks: int, n_tiles: int, groups: int = tc._WG_GROUPS):
    """The tiles each (block, warpgroup) takes, as the kernel walks them:
    first ``wg * gridDim.x + blockIdx.x``, then every ``gridDim.x * groups``."""
    return {(blk, wg): list(range(wg * blocks + blk, n_tiles, blocks * groups))
            for blk in range(blocks) for wg in range(groups)}


def tile_pixels(tile: int, h: int, w: int):
    """Output pixels (b, y, x) a warpgroup's 64 accumulator rows hold for one
    tile, by the kernel's index arithmetic: row m = 16 warp + 8 hh + g is
    pixel (y0 + 2 warp + hh, x0 + g); rows outside the image are computed on
    zero patches and never stored."""
    tiles_x = -(-w // 8)
    tiles_img = tiles_x * -(-h // 8)
    b, r = divmod(tile, tiles_img)
    y0, x0 = (r // tiles_x) * 8, (r % tiles_x) * 8
    out = []
    for m in range(64):
        warp, hh, g = m // 16, (m // 8) % 2, m % 8
        y, x = y0 + 2 * warp + hh, x0 + g
        if y < h and x < w:
            out.append((b, y, x))
    return out


WALK_SHAPES = ([s[1:4] for s in CIFAR_B256[1:]] + [(64, h, w) for _, h, w, *_ in DVS_TICK]
               + [(8, 32, 32), (8, 16, 16), (257, 8, 8), (257, 16, 16), (5, 12, 20),
                  (3, 7, 12), (133, 8, 8), (1, 8, 8), (2, 10, 6)])


@pytest.mark.parametrize("b,h,w", WALK_SHAPES, ids=lambda v: str(v))
def test_the_tile_walk_covers_every_output_pixel_exactly_once(b, h, w):
    plan = tc._wgmma_plan(b, h, w, 96, 96, 3, 3)
    n_tiles = b * math.ceil(h / 8) * math.ceil(w / 8)
    taken = [t for tiles in walk_tiles(plan.blocks, n_tiles).values() for t in tiles]
    assert sorted(taken) == list(range(n_tiles))          # each tile once
    if n_tiles >= plan.blocks:                            # no block left idle
        assert all(walk_tiles(plan.blocks, n_tiles)[(blk, 0)] for blk in range(plan.blocks))
    if b * h * w <= 70_000:  # the pixel model, at the smaller shapes
        seen = Counter(p for t in range(n_tiles) for p in tile_pixels(t, h, w))
        assert len(seen) == b * h * w and set(seen.values()) == {1}


@pytest.mark.parametrize("b,h,w", [(2, 32, 32), (3, 16, 16), (257, 8, 8), (4, 12, 20)])
def test_each_pooled_pixel_is_written_once_by_an_even_lane(b, h, w):
    """A 2x2 window is rows (g, g + 8) of a thread (pixels (y, x), (y + 1, x))
    and the same rows of lane ^ 4 (x ^ 1); the lane with g even writes it."""
    n_tiles = b * math.ceil(h / 8) * math.ceil(w / 8)
    tiles_x = math.ceil(w / 8)
    tiles_img = tiles_x * math.ceil(h / 8)
    written = Counter()
    for tile in range(n_tiles):
        bb, r = divmod(tile, tiles_img)
        y0, x0 = (r // tiles_x) * 8, (r % tiles_x) * 8
        for warp in range(4):
            for g in range(0, 8, 2):
                window = {(y0 + 2 * warp + hh, x0 + g + dx) for hh in (0, 1) for dx in (0, 1)}
                qy, qx = (y0 + 2 * warp) // 2, (x0 + g) // 2
                assert window == {(2 * qy + a, 2 * qx + c) for a in (0, 1) for c in (0, 1)}
                if qy < h // 2 and qx < w // 2:
                    written[(bb, qy, qx)] += 1
    assert len(written) == b * (h // 2) * (w // 2) and set(written.values()) == {1}


@pytest.mark.parametrize("n", list(tc._WG_WIDTHS))
def test_a_thread_s_accumulators_cover_its_columns_once(n):
    """d[4j + i] of lane (g, t) is column 8j + 2t + (i & 1) of row g + 8 (i >> 1):
    over the four lanes of a row group the columns are 0 .. N-1, once each."""
    for hh in (0, 1):
        cols = Counter(8 * j + 2 * t + (i & 1) for t in range(4) for j in range(n // 8)
                       for i in range(4) if (i >> 1) == hh)
        assert sorted(cols) == list(range(n)) and set(cols.values()) == {1}


@pytest.mark.parametrize("k,c_in", [(3, 96), (3, 64), (1, 64), (1, 96), (3, 32)])
def test_the_k_step_table_gathers_the_im2col_row(k, c_in):
    """koff[ks] + 4t (+16) in a patch of (8 + k - 1)^2 pixels, C_in + 16 bytes
    apart, is the A fragment's k = 32 ks + 4t .. (+16) of the im2col row with
    the channel fastest: the same (tap, channel) for every output pixel."""
    patch_w, ps = 8 + k - 1, c_in + 16
    k_steps = k * k * c_in // 32
    for ks in range(k_steps):
        tap = ks * 32 // c_in
        koff = ((tap // k) * patch_w + tap % k) * ps + (ks * 32 - tap * c_in)
        for kk in range(32):                       # k within the step
            flat = 32 * ks + kk                    # (tap, channel), channel fastest
            want_tap, want_c = divmod(flat, c_in)
            dy, dx = divmod(want_tap, k)
            assert koff + kk == (dy * patch_w + dx) * ps + want_c


def test_the_decoded_b_operand_layout_is_k_major_core_matrices():
    """Byte (k, n) of a k-step's B sits at (n // 8) * SBO + (k // 16) * LBO +
    (n % 8) * 16 + k % 16: 8 columns x 16 k-bytes per 128-byte core matrix."""
    lbo, sbo = _src_int("kWgLbo"), _src_int("kWgSbo")
    assert (lbo, sbo) == (128, 256)
    n = 96
    offsets = {(k, c): (c // 8) * sbo + (k // 16) * lbo + (c % 8) * 16 + k % 16
               for k in range(32) for c in range(n)}
    assert sorted(offsets.values()) == list(range(32 * n))     # a dense 32 x N block
    # the decode writes column n's 16 k-bytes of one half as one 16-byte row
    for c in range(n):
        for half in (0, 1):
            row = [offsets[(16 * half + kk, c)] for kk in range(16)]
            assert row == list(range(row[0], row[0] + 16)) and row[0] % 16 == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

VARIANTS = [  # (fuse_ternary, pooled, out dtype)
    (False, False, torch.float32),
    (True, False, torch.int8),
    (True, True, torch.int8),
    (True, True, torch.float32),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host or interpret mode")
    return torch.device("cuda", 0)


def _operands(gen, b, h, w, c_in, c_out, k, dev):
    from repro_torch.core.ternary import pack_ternary

    x = torch.randint(-1, 2, (b, h, w, c_in), generator=gen).to(torch.int8)
    t = torch.randint(-1, 2, (k, k, c_in, c_out), generator=gen).to(torch.int8)
    scale = torch.rand(c_out, generator=gen) * 0.2 + 0.05
    thr = torch.rand(c_out, generator=gen) * 1.5 + 0.25
    return x.to(dev), pack_ternary(t, axis=2).to(dev), scale.to(dev), thr.to(dev)


# the seven int8 launches of a cifar10_tnn step at B = 256, ragged batches,
# the two of a pool-64 dvs_cnn_tcn tick that take route 1 (the 32x32 and 16x16
# maps, C_out 64 and 96), and its other int8 maps at a batch that takes it:
# the pooled 8x8 and 4x4 maps and the ragged TCN maps (13x2, 7x4, 4x8), where
# most of each 8x8 tile lies outside the map
CARD_SHAPES = ([s[1:8] for s in CIFAR_B256[1:]]
               + [(257, 8, 8, 96, 96, 3, 2), (257, 16, 16, 96, 96, 3, 0)]
               + [(64, *s[1:7]) for s in DVS_TICK[1:3]]
               + [(256, *s[1:7]) for s in DVS_TICK[3:] if s[-1] == torch.int8])


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_every_variant_the_card_checks_takes_the_wgmma_route(shape):
    """The card's test below holds route 1 at each shape in every variant,
    the unpooled ones of the pooled shapes too."""
    b, h, w, c_in, c_out, k, pool = shape
    for fuse_pool in sorted({0, pool}):
        assert conv_plan(b, h, w, c_in, c_out, k, k, fuse_pool, torch.int8).route == 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_the_wgmma_route_equals_the_plain_version_and_the_oracle(shape):
    from repro_torch.kernels.ref import ternary_conv2d_ref

    dev = _card()
    b, h, w, c_in, c_out, k, pool = shape
    gen = torch.Generator().manual_seed(b * 1000 + h)
    x, wp, scale, thr = _operands(gen, b, h, w, c_in, c_out, k, dev)
    for tern, pooled, out_dtype in VARIANTS:
        if pooled and not pool:
            continue
        kw = dict(fuse_ternary=tern, fuse_pool=pool if pooled else 0, out_dtype=out_dtype)
        assert conv_plan(b, h, w, c_in, c_out, k, k, kw["fuse_pool"], x.dtype).route == 1
        before = tc.ternary_conv2d_cuda.launches_wgmma
        got = tc.ternary_conv2d_cuda(x, wp, scale, thr, **kw)
        torch.cuda.synchronize()
        assert tc.ternary_conv2d_cuda.launches_wgmma == before + 1
        want = tc.ternary_conv2d_native(x, wp, scale, thr, **kw)
        assert torch.equal(got, want), kw
        assert torch.equal(got, ternary_conv2d_ref(x, wp, scale, threshold=thr, **kw)), kw


@pytest.mark.gpu
def test_the_two_routes_agree_bit_for_bit_where_both_can_run():
    dev = _card()
    gen = torch.Generator().manual_seed(7)
    for b, h, w, c_in, c_out, pool in [(8, 32, 32, 64, 64, 2), (3, 7, 12, 32, 64, 0),
                                       (2, 10, 6, 64, 96, 2), (1, 8, 8, 96, 96, 0)]:
        x, wp, scale, thr = _operands(gen, b, h, w, c_in, c_out, 3, dev)
        kw = dict(fuse_ternary=True, fuse_pool=pool, out_dtype=torch.int8)
        wg = tc._launch_planned(x, wp, scale, thr, tc._wgmma_plan(b, h, w, c_in, c_out, 3, 3),
                                **kw)
        mma = tc._launch_planned(
            x, wp, scale, thr, tc._mma_plan(b, h, w, c_in, c_out, 3, 3, pool, torch.int8), **kw)
        torch.cuda.synchronize()
        assert torch.equal(wg, mma), (b, h, w, c_in, c_out, pool)


@pytest.mark.gpu
def test_a_wgmma_launch_replays_from_a_cuda_graph():
    """Fixed grid, no allocation, no host synchronisation: captured once,
    replayed on new inputs, equal to an eager launch, counted as recorded."""
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    x, wp, scale, thr = _operands(gen, 256, 16, 16, 96, 96, 3, dev)
    kw = dict(fuse_ternary=True, fuse_pool=2, out_dtype=torch.int8)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tc.ternary_conv2d_cuda(static_x, wp, scale, thr, **kw)  # warm-up (the build)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    recorded = tc.ternary_conv2d_cuda.recorded_wgmma
    with torch.cuda.graph(graph):
        out = tc.ternary_conv2d_cuda(static_x, wp, scale, thr, **kw)
    assert tc.ternary_conv2d_cuda.recorded_wgmma == recorded + 1
    x2, *_ = _operands(gen, 256, 16, 16, 96, 96, 3, dev)
    static_x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tc.ternary_conv2d_native(x2, wp, scale, thr, **kw))
    assert np.abs(out.cpu().numpy()).max() == 1
