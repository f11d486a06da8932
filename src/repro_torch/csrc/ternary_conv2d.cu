// Fused ternary conv2d for Hopper (sm_90a) — the CUTIE OCU array as one launch.
//
// Replaces the TPU kernel `_tconv_kernel` of src/repro/kernels/ternary_conv2d.py
// (launched by `ternary_conv2d_pallas`, with its `_select_w` decode and
// `_epilogue`).  It computes the same function and is laid out anew for the
// card:
//
//   y[b,oy,ox,n] = sum_{dy,dx,c} x[b, oy+dy-KH/2, ox+dx-KW/2, c] * t[dy,dx,c,n]
//
// with t in {-1,0,+1} decoded in registers from the quantizer's 2-bit packed
// bytes w_packed[KH,KW,C_in/4,C_out] (plus = b1, minus = NOR(b1,b0), operand =
// plus - minus), then y*scale[n]; optionally the ThFU ternarize
// |y| > thr[n] ? sign(y) : 0 (strict >); optionally a p x p max-pool; cast.
//
// Two routes, one semantics; `conv_plan` in kernels/ternary_conv2d.py picks
// one from the launch's shape alone, and the entry point refuses a plan that
// is not the route's own arithmetic.
//
// Route 0, the mma.sync kernel (`tconv_kernel`).  Bound on this card: at a
// pool tick's shapes (at most 8x64x64x64 outputs per launch) the work is
// 0.01-2.3 us at the tensor cores' int8 / CUDA cores' float32 peak and a few
// hundred kilobytes of traffic, so a launch is bounded by latency: the first
// version of this kernel took 23-48 us per launch, with 24-256 blocks each
// walking C_in in decode -> stage -> barrier -> FMA chunks.  This design is
// an implicit GEMM on the tensor cores:
//
//   * GEMM view.  M = output pixels, N = output channels, and the reduction
//     index k = (tap, channel) flattened with the channel fastest, padded with
//     zero trits to the mma depth (32 for int8, 16 for bf16).  Because C_in is
//     a multiple of 4, four consecutive k lie inside one tap and are one
//     packed byte: the weight matrix is w_packed itself, viewed as
//     [KH*KW*C_in/4, C_out] bytes, and a B fragment register is one byte
//     (int8) or half a byte (bf16) of it (ternary_mma.cuh).  Small C_in
//     (conv0 and the 5x5 stem have 4) pads the whole K = taps*C_in once, not
//     each tap.
//   * int8 input (the ternary-activation layers: 7 of a pool tick's 9
//     launches): `mma.sync m16n8k32 s8.s8 -> s32` on the trits, exact by
//     construction; the int32 sum converts exactly to float32, so the
//     epilogue sees the same value as the plain version.  float32 input (the
//     event frames, the pooled TCN window, the unfused backend's float maps):
//     the exact three-way bf16 split and `m16n8k16`, three mmas per fragment,
//     one when no lane of the warp has a nonzero mid or lo term (bf16-exact
//     data, as the serving path's binary frames and quarter-multiples are).
//   * Stage once.  A block owns (sample, a tile of <= 64 output pixels aligned
//     to the pool window, 32 output channels).  It copies its whole packed
//     weight slice ([KH*KW*C_in/4, 32] bytes) and its input patch (the tile
//     plus the SAME border, zero-filled outside the image) into shared memory
//     with `cp.async`, and waits at one barrier.  Nothing is decoded into
//     shared memory: the bytes are expanded in registers at fragment load.
//     A small table maps each k-group to its (tap, channel) offset in the
//     patch, so the im2col gather is one shared load per A register.
//   * Occupancy.  Four warps; a warp's mma tile is 16 pixels x 32 channels.
//     A 64-pixel tile gives each warp its own 16 pixels; a 32- or 16-pixel
//     tile splits the reduction across 2 or 4 warps, which sum their partial
//     tiles in shared memory in warp order (no atomics).  The host-side plan
//     (`conv_plan` in kernels/ternary_conv2d.py) takes the largest tile that
//     still gives >= 132 blocks, else the smallest.
//   * Epilogue from shared memory: sum of the warps' partials -> *scale ->
//     ThFU ternarize -> [p x p max] -> cast, written channel-contiguous; the
//     accumulator never reaches device memory.
//
// Route 1, the persistent weight-stationary wgmma kernel (`tconv_kernel_wg`),
// for int8 x with C_in % 32 == 0, C_out 64 or 96, no pool or a 2x2 one, and a
// launch that fills the card: at least one 8x8 output tile per SM (132) and
// 1024 pixels (the crossover measured on the H100).  Bound on this card: the
// tensor cores' int8 rate — cifar10_tnn's second conv at batch 256 is 43.5
// GOP, 22 us at 1979 TOP/s, against 2.3 MB of traffic (0.7 us).  Route 0 is
// 20x off that bound there: each of its blocks stages its patch and a 32-column
// weight slice behind one barrier, decodes the packed bytes again before every
// mma.sync, and runs only 27 k-steps of 4 mmas per warp before a scalar
// epilogue through shared memory; at 12,288 blocks a launch, the same patch is
// staged and decoded for each of three column blocks.  This design:
//
//   * Weight-stationary, persistent.  At most one block per SM (132), four
//     consumer warpgroups each.  A block decodes the layer's packed weights
//     once into shared memory, in the K-major no-swizzle layout the wgmma B
//     descriptor reads ([k-step][N/8][2][8][16] bytes; 83 KB for 3x3x96x96),
//     then walks its tiles: tile t goes to block t % blocks, and a block's
//     warpgroups take its tiles in turn, so a launch of fewer tiles than SMs
//     spreads one tile per block.
//   * `wgmma.m64nNk32.s32.s8.s8`, A from registers, B from shared memory,
//     N = all of C_out in one instruction.  A warpgroup's 64 rows are an 8x8
//     tile, each warp's 16 rows two image rows of 8 pixels, whose A fragment
//     is the m16n8k32 fragment route 0 gathers: one shared load per register
//     through the k-step's (tap, channel) offset.  Each A fragment now feeds
//     all of C_out.  Three fragments are in flight (a register ring); ptxas
//     does not know an in-flight wgmma still reads them, so each fragment's
//     registers are held live (`fence_operands`) until the wait that retires
//     its reader.
//   * A ring of two input patches per warpgroup (the tile plus the SAME
//     border, zero-filled outside the image) in 16-byte `cp.async`: tile
//     t+1's patch loads while tile t's wgmmas run; the first two load while
//     the block decodes its weights.  Pixels are C_in + 16 bytes apart, so the
//     eight pixels of an A gather fall on distinct banks.
//   * Epilogue from registers: scale -> ThFU ternarize (strict >) -> [2x2 max:
//     the window is two registers of a thread and the same two of lane ^ 4]
//     -> cast; int8 through a per-warp staging row in 16-byte stores.  No
//     int32 partial ever reaches shared memory.
//   * Exact: s8 x s8 -> s32 sums, converted to float32 exactly, then the same
//     float32 operations as route 0 and the plain version.  Fixed grid, no
//     allocation, no host synchronisation: it is captured in CUDA graphs.
//
// The TCONV_ABLATE_* macros compile one phase out (operand staging, fragment
// decode, mma walk, epilogue) of route 0.  They exist for
// benchmarks/kernel_ablate_torch.py, which times the variants to show where a
// launch's time goes; an ablated build is wrong by design and the package
// never defines them.
//
// Interface: plain C, loaded with ctypes.  The launcher enqueues on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ternary_mma.cuh"

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTilePix = 64;    // output pixels per block at most (pre-pool)
constexpr int kTileN = 32;      // output channels per block: four n8 subtiles
constexpr int kPartStride = kTileN + 8;  // words per row of a warp's partial tile

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Elements of padding per staged pixel: keeps each pixel 16-byte aligned for
// the copies and spreads neighbouring pixels over the banks.
__host__ __device__ inline int pixel_stride(int c_in) { return c_in + 4; }

// k-groups (4 trits, one packed byte) per mma step, and the padded count.
template <typename TIn> struct Depth { static constexpr int kGroups = 8; };   // int8: k32
template <> struct Depth<float> { static constexpr int kGroups = 4; };        // bf16: k16

struct Layout {
  int patch, weights, table, part, total;   // byte offsets and the size
};

__host__ __device__ inline Layout smem_layout(int kh, int kw, int th, int tw, int c_in,
                                              int q_padded, int in_bytes) {
  Layout l;
  l.patch = 0;
  l.weights = round16((th + kh - 1) * (tw + kw - 1) * pixel_stride(c_in) * in_bytes);
  l.table = l.weights + round16(q_padded * kTileN);
  l.part = l.table + round16(q_padded * 4);
  l.total = l.part + kTilePix * kPartStride * 4;
  return l;
}

template <typename Acc>
__device__ __forceinline__ float to_float(Acc v) { return static_cast<float>(v); }

// int8 input: m16n8k32 s8 mmas, int32 accumulators.
__device__ __forceinline__ void k_walk(int (&acc)[4][4], const int8_t* patch,
                                       const uint8_t* ws, const int* tab, int base0,
                                       int base1, int ks0, int ks_step, int n_ksteps,
                                       int g, int t) {
  for (int ks = ks0; ks < n_ksteps; ks += ks_step) {
    // A: rows g, g+8 (pixels) x k = 4t..4t+3 (group q0) and 16+4t.. (group q0+4)
    const int q0 = ks * 8 + t, q1 = q0 + 4;
    const int o0 = tab[q0], o1 = tab[q1];
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(patch + base0 + o0),
                           *reinterpret_cast<const uint32_t*>(patch + base1 + o0),
                           *reinterpret_cast<const uint32_t*>(patch + base0 + o1),
                           *reinterpret_cast<const uint32_t*>(patch + base1 + o1)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // B: the bytes of groups q0 and q1 in column 8j + g
      const uint32_t w0 = ws[q0 * kTileN + 8 * j + g];
      const uint32_t w1 = ws[q1 * kTileN + 8 * j + g];
#ifndef TCONV_ABLATE_DECODE
      const uint32_t b0 = tmma::decode_s8x4(w0), b1 = tmma::decode_s8x4(w1);
#else
      const uint32_t b0 = w0 * 0x01010101u, b1 = w1 * 0x01010101u;
#endif
#ifndef TCONV_ABLATE_MMA
      tmma::mma_s8(acc[j], a, b0, b1);
#else
      acc[j][0] += static_cast<int>((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 1u);
#endif
    }
  }
}

// float32 input: the exact three-way bf16 split, m16n8k16 mmas, float32
// accumulators.  As in the matmul, each k-step's hi term and its lo and mid
// terms land in fresh fragments that are added to `acc` on the CUDA cores, so
// no tensor-core accumulation chain is longer than 2 mmas.
__device__ __forceinline__ void k_walk(float (&acc)[4][4], const float* patch,
                                       const uint8_t* ws, const int* tab, int base0,
                                       int base1, int ks0, int ks_step, int n_ksteps,
                                       int g, int t) {
  const int ch = 2 * (t & 1);   // k = 2t, 2t+1: channels ch, ch+1 of group ks*4 + t/2
  const int sh = 4 * (t & 1);   // ... the nibble of the packed byte that holds them
  for (int ks = ks0; ks < n_ksteps; ks += ks_step) {
    const int q0 = ks * 4 + (t >> 1), q1 = q0 + 2;
    const int o0 = tab[q0] + ch, o1 = tab[q1] + ch;
    const float2 v0 = *reinterpret_cast<const float2*>(patch + base0 + o0);
    const float2 v1 = *reinterpret_cast<const float2*>(patch + base1 + o0);
    const float2 v2 = *reinterpret_cast<const float2*>(patch + base0 + o1);
    const float2 v3 = *reinterpret_cast<const float2*>(patch + base1 + o1);
    const tmma::Bf16x3 s0 = tmma::split_bf16x3(v0.x, v0.y), s1 = tmma::split_bf16x3(v1.x, v1.y),
                       s2 = tmma::split_bf16x3(v2.x, v2.y), s3 = tmma::split_bf16x3(v3.x, v3.y);
    const uint32_t hi[4] = {s0.hi, s1.hi, s2.hi, s3.hi};
    const uint32_t mid[4] = {s0.mid, s1.mid, s2.mid, s3.mid};
    const uint32_t lo[4] = {s0.lo, s1.lo, s2.lo, s3.lo};
    const bool rest = __any_sync(0xffffffffu, (mid[0] | mid[1] | mid[2] | mid[3] | lo[0] |
                                               lo[1] | lo[2] | lo[3]) != 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = ws[q0 * kTileN + 8 * j + g];
      const uint32_t w1 = ws[q1 * kTileN + 8 * j + g];
#ifndef TCONV_ABLATE_DECODE
      const uint32_t b0 = tmma::decode_bf16x2(w0 >> sh), b1 = tmma::decode_bf16x2(w1 >> sh);
#else
      const uint32_t b0 = w0 << sh, b1 = w1 << sh;
#endif
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rest_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#ifndef TCONV_ABLATE_MMA
      tmma::mma_bf16(part, hi, b0, b1);
      if (rest) {
        tmma::mma_bf16(rest_part, lo, b0, b1);
        tmma::mma_bf16(rest_part, mid, b0, b1);
      }
#else
      part[0] = __uint_as_float((hi[0] ^ mid[1] ^ lo[2] ^ b0 ^ b1) & 0x3F800000u);
#endif
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[i] + rest_part[i];
    }
  }
}

template <typename TIn, typename TOut, bool kTernarize, bool kPool>
__global__ void __launch_bounds__(kThreads)
tconv_kernel(const TIn* __restrict__ x, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, const float* __restrict__ thr,
             TOut* __restrict__ out, int H, int W, int C_in, int KH, int KW,
             int C_out, int th, int tw, int pool) {
  using Acc = typename std::conditional<std::is_same<TIn, float>::value, float, int>::type;
  constexpr int kGroups = Depth<TIn>::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int taps = KH * KW;
  const int c4 = C_in >> 2;
  const int q_real = taps * c4;                                // k-groups holding weights
  const int n_ksteps = (q_real + kGroups - 1) / kGroups;
  const int q_padded = n_ksteps * kGroups;
  const int patch_w = tw + KW - 1, patch_h = th + KH - 1;
  const int ps = pixel_stride(C_in);
  const Layout lay = smem_layout(KH, KW, th, tw, C_in, q_padded, sizeof(TIn));
  TIn* patch = reinterpret_cast<TIn*>(smem + lay.patch);
  uint8_t* ws = smem + lay.weights;
  int* tab = reinterpret_cast<int*>(smem + lay.table);
  Acc* part = reinterpret_cast<Acc*>(smem + lay.part);

  const int tiles_x = (W + tw - 1) / tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int n_pix = th * tw;

  // ---- stage once: patch, weight slice, k-group table; one barrier --------
#ifndef TCONV_ABLATE_STAGE
  for (int i = tid; i < patch_h * patch_w * c4; i += kThreads) {
    const int pix = i / c4, q = i % c4;
    const int iy = y0 - KH / 2 + pix / patch_w;
    const int ix = x0 - KW / 2 + pix % patch_w;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;   // else: the SAME zero border
    const TIn* src = ok ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C_in + 4 * q : x;
    tmma::cp_async<4 * sizeof(TIn)>(patch + pix * ps + 4 * q, src, ok);
  }
  if ((C_out & 3) == 0) {
    for (int i = tid; i < q_padded * (kTileN / 4); i += kThreads) {
      const int r = i / (kTileN / 4), q = i % (kTileN / 4);
      const int gn = n0 + 4 * q;
      uint8_t* dst = ws + r * kTileN + 4 * q;
      if (r < q_real && gn < C_out)
        tmma::cp_async<4>(dst, wp + static_cast<size_t>(r) * C_out + gn, true);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0x55555555u;   // zero trits: padding, ragged C_out
    }
  } else {
    for (int i = tid; i < q_padded * kTileN; i += kThreads) {
      const int r = i / kTileN, n = i % kTileN;
      const int gn = n0 + n;
      ws[i] = (r < q_real && gn < C_out) ? wp[static_cast<size_t>(r) * C_out + gn] : 0x55;
    }
  }
  tmma::cp_async_commit();
#endif
  // k-group q -> offset of its (tap, channel quad) in the patch; the padding
  // groups point at element 0 and meet zero trits
  for (int q = tid; q < q_padded; q += kThreads) {
    int off = 0;
    if (q < q_real) {
      const int tap = q / c4;
      off = ((tap / KW) * patch_w + tap % KW) * ps + 4 * (q % c4);
    }
    tab[q] = off;
  }
  tmma::cp_async_wait<0>();
  __syncthreads();

  // ---- the mma walk: warp -> (pixel group mg, reduction share kg) ---------
  const int groups_m = (n_pix + 15) / 16;          // 16-pixel mma row groups
  const int groups_k = kWarps / groups_m;          // warps sharing one row group
  const int mg = warp % groups_m, kg = warp / groups_m;
  if (kg < groups_k) {
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mg * 16 + g + 8 * h;
      base[h] = p < n_pix ? ((p / tw) * patch_w + p % tw) * ps : 0;   // dead rows read pixel 0
    }
    Acc acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = Acc(0);
    k_walk(acc, patch, ws, tab, base[0], base[1], kg, groups_k, n_ksteps, g, t);
    // partial tile of this warp: rows mg*16 + g (+8), columns 8j + 2t (+1)
    Acc* pk = part + (kg * groups_m * 16 + mg * 16) * kPartStride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      pk[g * kPartStride + col] = acc[j][0];
      pk[g * kPartStride + col + 1] = acc[j][1];
      pk[(g + 8) * kPartStride + col] = acc[j][2];
      pk[(g + 8) * kPartStride + col + 1] = acc[j][3];
    }
  }
  __syncthreads();

  // ---- epilogue: sum of the warps' partials (warp order) -> scale -> ThFU
  //      ternarize (strict >) -> [pool] -> cast ----------------------------
#ifndef TCONV_ABLATE_EPILOGUE
  const int share = groups_m * 16 * kPartStride;   // words between two warps' partials
  auto value = [&](int r, int n) -> float {
    Acc s = part[r * kPartStride + n];
    for (int k = 1; k < groups_k; ++k) s += part[k * share + r * kPartStride + n];
    float y = to_float(s) * scale[n0 + n];
    if (kTernarize) {
      const float c = thr[n0 + n];
      y = fabsf(y) > c ? (y > 0.0f ? 1.0f : -1.0f) : 0.0f;
    }
    return y;
  };
  if (!kPool) {
    for (int e = tid; e < n_pix * kTileN; e += kThreads) {
      const int r = e / kTileN, n = e % kTileN;
      const int oy = y0 + r / tw, ox = x0 + r % tw;
      if (oy >= H || ox >= W || n0 + n >= C_out) continue;
      out[((static_cast<size_t>(b) * H + oy) * W + ox) * C_out + n0 + n] =
          static_cast<TOut>(value(r, n));
    }
  } else {
    // H and W are multiples of pool and the tile origin is pool-aligned, so a
    // pooled pixel inside the output lies wholly inside the image and the tile
    const int OH = H / pool, OW = W / pool;
    const int oth = th / pool, otw = tw / pool;
    for (int e = tid; e < oth * otw * kTileN; e += kThreads) {
      const int n = e % kTileN, rq = e / kTileN;
      const int qy = rq / otw, qx = rq % otw;
      const int oy = y0 / pool + qy, ox = x0 / pool + qx;
      if (oy >= OH || ox >= OW || n0 + n >= C_out) continue;
      float m = -INFINITY;
      for (int a = 0; a < pool; ++a)
        for (int c = 0; c < pool; ++c)
          m = fmaxf(m, value((qy * pool + a) * tw + qx * pool + c, n));
      out[((static_cast<size_t>(b) * OH + oy) * OW + ox) * C_out + n0 + n] =
          static_cast<TOut>(m);
    }
  }
#else
  if (tid == 0 && H < 0) out[0] = static_cast<TOut>(to_float(part[0]));
#endif
}

template <typename TIn, typename TOut, bool kTernarize, bool kPool>
int launch(const void* x, const void* wp, const float* scale, const float* thr,
           void* out, int B, int H, int W, int C_in, int KH, int KW, int C_out,
           int th, int tw, int pool, cudaStream_t stream) {
  auto kern = tconv_kernel<TIn, TOut, kTernarize, kPool>;
  constexpr int kGroups = Depth<TIn>::kGroups;
  const int q_padded = (KH * KW * (C_in / 4) + kGroups - 1) / kGroups * kGroups;
  const size_t smem = smem_layout(KH, KW, th, tw, C_in, q_padded, sizeof(TIn)).total;
  if (smem > 48 * 1024) {
    // above the static limit a launch is refused unless the kernel opted in
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((H + th - 1) / th) * ((W + tw - 1) / tw);
  dim3 grid(tiles, (C_out + kTileN - 1) / kTileN, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const uint8_t*>(wp), scale, thr,
      static_cast<TOut*>(out), H, W, C_in, KH, KW, C_out, th, tw, pool);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int dispatch(const void* x, const void* wp, const float* scale, const float* thr,
             void* out, int out_is_int8, int B, int H, int W, int C_in, int KH,
             int KW, int C_out, int th, int tw, int fuse_ternary, int pool,
             cudaStream_t s) {
#define TCONV_ARGS x, wp, scale, thr, out, B, H, W, C_in, KH, KW, C_out, th, tw, pool, s
  const bool pooled = pool > 1;
  if (out_is_int8) {
    // int8 carries trits only: the unternarized accumulator stays float32
    if (!fuse_ternary) return -2;
    return pooled ? launch<TIn, int8_t, true, true>(TCONV_ARGS)
                  : launch<TIn, int8_t, true, false>(TCONV_ARGS);
  }
  if (fuse_ternary)
    return pooled ? launch<TIn, float, true, true>(TCONV_ARGS)
                  : launch<TIn, float, true, false>(TCONV_ARGS);
  return pooled ? launch<TIn, float, false, true>(TCONV_ARGS)
                : launch<TIn, float, false, false>(TCONV_ARGS);
#undef TCONV_ARGS
}


// ---------------------------------------------------------------------------
// Route 1: the persistent, weight-stationary wgmma kernel (int8 x, large B*H*W)
// ---------------------------------------------------------------------------

constexpr int kWgGroups = 4;                  // consumer warpgroups per block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgRing = 3;                    // A fragments in flight per thread (k-steps)
constexpr int kWgTile = 8;                    // a warpgroup's tile: 8 x 8 output pixels
constexpr int kWgMaxBlocks = 132;             // one block per SM of an H100
constexpr int kWgMaxSmem = 232448;            // dynamic shared memory a block may use
constexpr int kWgLbo = 128;                  // B's core-matrix stride along K ...
constexpr int kWgSbo = 256;                  // ... and along N (8-column groups)

// Bytes per staged input pixel: 16-byte aligned for the copies, and C_in/4 + 4
// words apart (C_in % 32 == 0), so the eight pixels of one A gather fall on
// eight distinct groups of four banks.
__host__ __device__ inline int wg_pixel_stride(int c_in) { return c_in + 16; }

// Bytes of an output staging row: the same spread for the epilogue's writes.
__host__ __device__ inline int wg_stage_stride(int n) { return n + 16; }

struct WgLayout {
  int weights, koff, scale, thr, groups, patch, stage, group, total;
};

// weights: per k-step the K-major B operand of one wgmma, 32 * N bytes:
// [N/8][2][8][16] — core matrices of 8 columns x 16 k-bytes, the two k-halves
// kWgLbo apart, the 8-column groups kWgSbo apart.  Then the k-step table, the
// scales and thresholds, and per warpgroup two input patches (the ring) and
// its warps' int8 output staging.
__host__ __device__ inline WgLayout wg_layout(int kh, int kw, int c_in, int n) {
  const int k_steps = kh * kw * c_in / 32;
  WgLayout l;
  l.weights = 0;
  l.koff = round16(k_steps * 32 * n);
  l.scale = l.koff + round16(k_steps * 4);
  l.thr = l.scale + round16(n * 4);
  l.groups = l.thr + round16(n * 4);
  l.patch = round16((kWgTile + kh - 1) * (kWgTile + kw - 1) * wg_pixel_stride(c_in));
  l.stage = 4 * 16 * wg_stage_stride(n);
  l.group = 2 * l.patch + l.stage;
  l.total = l.groups + kWgGroups * l.group;
  return l;
}

__device__ __forceinline__ float thfu(int acc, float scale, float thr, bool ternarize) {
  float y = static_cast<float>(acc) * scale;
  if (ternarize) y = fabsf(y) > thr ? (y > 0.0f ? 1.0f : -1.0f) : 0.0f;
  return y;
}

__device__ __forceinline__ uint16_t pack_s8x2(float lo, float hi) {
  return static_cast<uint16_t>(static_cast<uint8_t>(static_cast<int8_t>(lo)) |
                               (static_cast<uint8_t>(static_cast<int8_t>(hi)) << 8));
}

template <typename TOut, int N, bool kTernarize, bool kPool>
__global__ void __launch_bounds__(kWgThreads, 1)
tconv_kernel_wg(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                const float* __restrict__ scale, const float* __restrict__ thr,
                TOut* __restrict__ out, int B, int H, int W, int C_in, int KH, int KW) {
  constexpr int kAcc = N / 2;          // int32 accumulators a thread holds (64 x N / 128)
  constexpr int kChunks = N / 16;      // 16-byte chunks of an int8 output pixel
  constexpr uint64_t kStepUnits = 32 * N / 16;   // descriptor address units per k-step
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int k_steps = KH * KW * C_in / 32;
  const int patch_w = kWgTile + KW - 1, patch_h = kWgTile + KH - 1;
  const int ps = wg_pixel_stride(C_in);
  const WgLayout lay = wg_layout(KH, KW, C_in, N);
  int* koff = reinterpret_cast<int*>(smem + lay.koff);
  float* s_scale = reinterpret_cast<float*>(smem + lay.scale);
  float* s_thr = reinterpret_cast<float*>(smem + lay.thr);

  // ---- per warpgroup: a static walk over 8 x 8 output tiles; the first two
  //      patches load while the block decodes its weights ------------------
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* region = smem + lay.groups + wg * lay.group;
  unsigned char* staging = region + 2 * lay.patch + warp * 16 * wg_stage_stride(N);

  const int tiles_x = (W + kWgTile - 1) / kWgTile;
  const int tiles_img = tiles_x * ((H + kWgTile - 1) / kWgTile);
  const int n_tiles = B * tiles_img;
  const int stride = gridDim.x * kWgGroups;
  const int c16 = C_in >> 4;
  const int row_chunks = patch_w * c16;
  const int patch_chunks = patch_h * row_chunks;

  // the tile's input patch (its 8 x 8 pixels plus the SAME border, zero
  // outside the image) into ring stage s, 16-byte copies; one commit group per
  // call, empty past the last tile, so the group count stays in step
  auto load_patch = [&](int tile, int s) {
    if (tile < n_tiles) {
      const int b = tile / tiles_img, r = tile - b * tiles_img;
      const int y0 = (r / tiles_x) * kWgTile - KH / 2;
      const int x0 = (r % tiles_x) * kWgTile - KW / 2;
      unsigned char* dst = region + s * lay.patch;
      for (int i = wtid; i < patch_chunks; i += 128) {
        const int py = i / row_chunks, rem = i - py * row_chunks;
        const int px = rem / c16, ch = rem - px * c16;
        const int iy = y0 + py, ix = x0 + px;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const int8_t* src =
            ok ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C_in + 16 * ch : x;
        tmma::cp_async<16>(dst + (py * patch_w + px) * ps + 16 * ch, src, ok);
      }
    }
    tmma::cp_async_commit();
  };

  // tile t -> block t % blocks, so a launch of fewer tiles than SMs spreads
  // one tile per block; a block's warpgroups take the tiles blocks apart
  int tile = wg * gridDim.x + blockIdx.x;
  load_patch(tile, 0);
  load_patch(tile + stride, 1);

  // ---- once per block: the layer's packed weights -> B in shared memory ---
  // item i -> (k-half kc = 2 * k-step + half, columns 4 n4 .. 4 n4 + 3): the
  // 16 trits k = 16 kc .. 16 kc + 15 of a column are its bytes in the 4
  // packed rows (k-groups) 4 kc .. 4 kc + 3, decoded into one 16-byte
  // core-matrix row.  Four items per thread are loaded before any is decoded,
  // so their loads are in flight together.
  constexpr int kQuads = N / 4;
  const int items = 2 * k_steps * kQuads;
  for (int base = 0; base < items; base += 4 * kWgThreads) {
    uint32_t w[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWgThreads + tid;
      if (i < items) {
        const int kc = i / kQuads, n4 = i - kc * kQuads;
        const uint8_t* src = wp + static_cast<size_t>(4 * kc) * N + 4 * n4;
#pragma unroll
        for (int e = 0; e < 4; ++e) w[u][e] = *reinterpret_cast<const uint32_t*>(src + e * N);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWgThreads + tid;
      if (i < items) {
        const int kc = i / kQuads, n4 = i - kc * kQuads;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = 4 * n4 + c;
          uint4 v;
          v.x = tmma::decode_s8x4(w[u][0] >> (8 * c));
          v.y = tmma::decode_s8x4(w[u][1] >> (8 * c));
          v.z = tmma::decode_s8x4(w[u][2] >> (8 * c));
          v.w = tmma::decode_s8x4(w[u][3] >> (8 * c));
          *reinterpret_cast<uint4*>(smem + lay.weights + (kc >> 1) * 32 * N + (n >> 3) * kWgSbo +
                                    (kc & 1) * kWgLbo + (n & 7) * 16) = v;
        }
      }
    }
  }
  // k-step -> offset of its (tap, first channel) in a patch: C_in % 32 == 0,
  // so the 32 k of a step lie in one tap and need no padding
  for (int ks = tid; ks < k_steps; ks += kWgThreads) {
    const int tap = ks * 32 / C_in;
    koff[ks] = ((tap / KW) * patch_w + tap % KW) * ps + (ks * 32 - tap * C_in);
  }
  for (int n = tid; n < N; n += kWgThreads) {
    s_scale[n] = scale[n];
    s_thr[n] = kTernarize ? thr[n] : 0.0f;
  }
  tmma::fence_proxy_async();   // the decoded B, as the wgmmas' async reads see it
  __syncthreads();

  // this thread's A rows: pixels (2 warp, g) and (2 warp + 1, g) of the tile
  const int a_row0 = ((2 * warp) * patch_w + g) * ps + 4 * t;
  const int a_row1 = a_row0 + patch_w * ps;
  const uint64_t desc0 = tmma::smem_desc(
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.weights)), kWgLbo, kWgSbo);

  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  for (int it = 0; tile < n_tiles; ++it, tile += stride) {
    const int s = it & 1;
    tmma::cp_async_wait<1>();      // this tile's patch: this thread's copies ...
    tmma::bar_sync(1 + wg, 128);   // ... and the warpgroup's
    const unsigned char* p0 = region + s * lay.patch + a_row0;
    const unsigned char* p1 = region + s * lay.patch + a_row1;
    auto load_a = [&](uint32_t (&a)[4], int ks) {
      const int o = koff[ks];
      a[0] = *reinterpret_cast<const uint32_t*>(p0 + o);
      a[1] = *reinterpret_cast<const uint32_t*>(p1 + o);
      a[2] = *reinterpret_cast<const uint32_t*>(p0 + o + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(p1 + o + 16);
    };

    // the k walk: kWgRing A fragments in registers, so the gather of step k+1
    // runs while the wgmmas of the steps before it do; a fragment's registers
    // are rewritten only after the wgmma that read them has completed
    uint32_t a[kWgRing][4] = {};
    load_a(a[0], 0);
    tmma::fence_operands(acc);
    for (int k0 = 0; k0 < k_steps; k0 += kWgRing) {
#pragma unroll
      for (int q = 0; q < kWgRing; ++q) {
        const int ks = k0 + q;
        if (ks < k_steps) {
          tmma::wgmma_fence();
          tmma::wgmma_s8(acc, a[q], desc0 + ks * kStepUnits, ks > 0);
          tmma::wgmma_commit();
          if (ks + 1 < k_steps) {
            tmma::wgmma_wait<kWgRing - 1>();   // step ks + 1 - kWgRing, which read it, is done
            tmma::fence_operands(a[(q + 1) % kWgRing]);
            load_a(a[(q + 1) % kWgRing], ks + 1);
          }
        }
      }
    }
    tmma::wgmma_wait<0>();
    tmma::fence_operands(acc);
#pragma unroll
    for (int q = 0; q < kWgRing; ++q) tmma::fence_operands(a[q]);
    tmma::bar_sync(1 + wg, 128);   // every gather from stage s is done: refill it
    load_patch(tile + 2 * stride, s);

    // ---- epilogue from registers: scale -> ThFU ternarize (strict >) ->
    //      [2 x 2 max] -> cast; int8 through the warp's staging rows in
    //      16-byte stores --------------------------------------------------------
    const int b = tile / tiles_img, r = tile - b * tiles_img;
    const int y0 = (r / tiles_x) * kWgTile, x0 = (r % tiles_x) * kWgTile;
    const int oy = y0 + 2 * warp, ox = x0 + g;   // this thread's pixels: (oy, ox), (oy + 1, ox)
    const int ss = wg_stage_stride(N);
    if (!kPool) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
        const float2 th = *reinterpret_cast<const float2*>(s_thr + c);
        const float v00 = thfu(acc[4 * j], sc.x, th.x, kTernarize);
        const float v01 = thfu(acc[4 * j + 1], sc.y, th.y, kTernarize);
        const float v10 = thfu(acc[4 * j + 2], sc.x, th.x, kTernarize);
        const float v11 = thfu(acc[4 * j + 3], sc.y, th.y, kTernarize);
        if (std::is_same<TOut, int8_t>::value) {
          *reinterpret_cast<uint16_t*>(staging + g * ss + c) = pack_s8x2(v00, v01);
          *reinterpret_cast<uint16_t*>(staging + (g + 8) * ss + c) = pack_s8x2(v10, v11);
        } else {
          float* o = reinterpret_cast<float*>(out);
          if (ox < W && oy < H)
            *reinterpret_cast<float2*>(o + ((static_cast<size_t>(b) * H + oy) * W + ox) * N + c) =
                make_float2(v00, v01);
          if (ox < W && oy + 1 < H)
            *reinterpret_cast<float2*>(
                o + ((static_cast<size_t>(b) * H + oy + 1) * W + ox) * N + c) =
                make_float2(v10, v11);
        }
      }
      if (std::is_same<TOut, int8_t>::value) {
        __syncwarp();
        for (int i = lane; i < 16 * kChunks; i += 32) {
          const int row = i / kChunks, ch = i - row * kChunks;
          const int py = oy + (row >> 3), px = x0 + (row & 7);
          if (py < H && px < W)
            *reinterpret_cast<uint4*>(reinterpret_cast<int8_t*>(out) +
                                      ((static_cast<size_t>(b) * H + py) * W + px) * N + 16 * ch) =
                *reinterpret_cast<const uint4*>(staging + row * ss + 16 * ch);
        }
        __syncwarp();
      }
    } else {
      // a 2 x 2 window is (oy, ox), (oy + 1, ox) in this thread's registers
      // and the same two pixels of lane ^ 4 (g ^ 1); H, W even and the tile
      // origin even, so a window lies wholly inside the image or wholly out
      const int OH = H / 2, OW = W / 2;
      const int qy = oy / 2, qx = ox / 2;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
        const float2 th = *reinterpret_cast<const float2*>(s_thr + c);
        float m0 = fmaxf(thfu(acc[4 * j], sc.x, th.x, kTernarize),
                         thfu(acc[4 * j + 2], sc.x, th.x, kTernarize));
        float m1 = fmaxf(thfu(acc[4 * j + 1], sc.y, th.y, kTernarize),
                         thfu(acc[4 * j + 3], sc.y, th.y, kTernarize));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if ((g & 1) == 0) {
          if (std::is_same<TOut, int8_t>::value) {
            *reinterpret_cast<uint16_t*>(staging + (g >> 1) * ss + c) = pack_s8x2(m0, m1);
          } else if (qy < OH && qx < OW) {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) +
                                       ((static_cast<size_t>(b) * OH + qy) * OW + qx) * N + c) =
                make_float2(m0, m1);
          }
        }
      }
      if (std::is_same<TOut, int8_t>::value) {
        __syncwarp();
        for (int i = lane; i < 4 * kChunks; i += 32) {
          const int px = i / kChunks, ch = i - px * kChunks;
          const int wx = x0 / 2 + px;
          if (qy < OH && wx < OW)
            *reinterpret_cast<uint4*>(reinterpret_cast<int8_t*>(out) +
                                      ((static_cast<size_t>(b) * OH + qy) * OW + wx) * N + 16 * ch) =
                *reinterpret_cast<const uint4*>(staging + px * ss + 16 * ch);
        }
        __syncwarp();
      }
    }
  }
  tmma::cp_async_wait<0>();   // no copy outlives the block
}

template <typename TOut, int N, bool kTernarize, bool kPool>
int launch_wg(const void* x, const void* wp, const float* scale, const float* thr, void* out,
              int B, int H, int W, int C_in, int KH, int KW, int blocks, cudaStream_t stream) {
  auto kern = tconv_kernel_wg<TOut, N, kTernarize, kPool>;
  const int smem = wg_layout(KH, KW, C_in, N).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, kWgThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wp), scale, thr,
      static_cast<TOut*>(out), B, H, W, C_in, KH, KW);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch_wg(const void* x, const void* wp, const float* scale, const float* thr, void* out,
                int out_is_int8, int B, int H, int W, int C_in, int KH, int KW,
                int fuse_ternary, int pool, int blocks, cudaStream_t s) {
#define TCONV_WG_ARGS x, wp, scale, thr, out, B, H, W, C_in, KH, KW, blocks, s
  const bool pooled = pool > 1;
  if (out_is_int8) {
    if (!fuse_ternary) return -2;
    return pooled ? launch_wg<int8_t, N, true, true>(TCONV_WG_ARGS)
                  : launch_wg<int8_t, N, true, false>(TCONV_WG_ARGS);
  }
  if (fuse_ternary)
    return pooled ? launch_wg<float, N, true, true>(TCONV_WG_ARGS)
                  : launch_wg<float, N, true, false>(TCONV_WG_ARGS);
  return pooled ? launch_wg<float, N, false, true>(TCONV_WG_ARGS)
                : launch_wg<float, N, false, false>(TCONV_WG_ARGS);
#undef TCONV_WG_ARGS
}

}  // namespace

// Returns 0 when the kernel was launched, a cudaError_t when the launch was
// refused, and a negative code for arguments the kernel does not take
// (-1 geometry or plan, -2 int8 output without fuse_ternary).  The plan
// (route, tile_h, tile_w, k_padded, warps_per_rows, blocks) comes from
// `conv_plan` in repro_torch/kernels/ternary_conv2d.py; each route refuses a
// plan that is not its own arithmetic.  Route 0 is the mma.sync kernel, route
// 1 the persistent wgmma kernel (int8 x, C_in % 32 == 0, C_out 64 or 96, pool
// 1 or 2).
extern "C" int ternary_conv2d_launch(
    const void* x, int x_is_int8, const void* w_packed, const void* scale,
    const void* threshold, void* out, int out_is_int8, int B, int H, int W,
    int C_in, int KH, int KW, int C_out, int route, int tile_h, int tile_w,
    int k_padded, int warps_per_rows, int blocks, int fuse_ternary, int fuse_pool,
    void* stream) {
  const int pool = fuse_pool > 1 ? fuse_pool : 1;
  if (B < 1 || H < 1 || W < 1 || C_in < 4 || (C_in & 3) || KH < 1 || KW < 1 ||
      C_out < 1 || tile_h < 1 || tile_w < 1 || tile_h * tile_w > kTilePix ||
      tile_h % pool || tile_w % pool || H % pool || W % pool || B > 65535 || route < 0 ||
      route > 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* th = static_cast<const float*>(threshold);
  if (route == 1) {
    // the persistent route: 8 x 8 tiles, the whole reduction in k32 steps,
    // one warp per 16 rows, one block per tile up to one block per SM
    const long long tiles = static_cast<long long>(B) * ((H + kWgTile - 1) / kWgTile) *
                            ((W + kWgTile - 1) / kWgTile);
    const long long grid = tiles < kWgMaxBlocks ? tiles : kWgMaxBlocks;
    if (!x_is_int8 || C_in % 32 || (C_out != 64 && C_out != 96) || pool > 2 ||
        tile_h != kWgTile || tile_w != kWgTile || k_padded != KH * KW * C_in ||
        warps_per_rows != 1 || blocks != grid ||
        wg_layout(KH, KW, C_in, C_out).total > kWgMaxSmem)
      return -1;
    if (C_out == 64)
      return dispatch_wg<64>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in, KH, KW,
                             fuse_ternary, pool, blocks, s);
    return dispatch_wg<96>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in, KH, KW,
                           fuse_ternary, pool, blocks, s);
  }
  // route 0: the reduction padded to whole mma steps, the warps that share a
  // 16-pixel row group, and the grid
  const int groups = x_is_int8 ? Depth<int8_t>::kGroups : Depth<float>::kGroups;
  const int q_padded = (KH * KW * (C_in / 4) + groups - 1) / groups * groups;
  const int row_groups = (tile_h * tile_w + 15) / 16;
  const long long grid = static_cast<long long>(B) * ((H + tile_h - 1) / tile_h) *
                         ((W + tile_w - 1) / tile_w) * ((C_out + kTileN - 1) / kTileN);
  if (k_padded != 4 * q_padded || warps_per_rows != kWarps / row_groups || blocks != grid)
    return -1;
  if (x_is_int8)
    return dispatch<int8_t>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in,
                            KH, KW, C_out, tile_h, tile_w, fuse_ternary, pool, s);
  return dispatch<float>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in,
                         KH, KW, C_out, tile_h, tile_w, fuse_ternary, pool, s);
}
