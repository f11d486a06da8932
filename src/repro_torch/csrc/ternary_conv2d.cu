// Fused ternary conv2d for Hopper (sm_90a) — the CUTIE OCU array as one launch.
//
// Replaces the TPU kernel `_tconv_kernel` of src/repro/kernels/ternary_conv2d.py
// (launched by `ternary_conv2d_pallas`, with its `_select_w` decode and
// `_epilogue`).  It computes the same function and is laid out anew for the
// card:
//
//   y[b,oy,ox,n] = sum_{dy,dx,c} x[b, oy+dy-KH/2, ox+dx-KW/2, c] * t[dy,dx,c,n]
//
// with t in {-1,0,+1} decoded in the kernel from the quantizer's 2-bit packed
// bytes w_packed[KH,KW,C_in/4,C_out] (plus = b1, minus = NOR(b1,b0), operand =
// plus - minus), then y*scale[n]; optionally the ThFU ternarize
// |y| > thr[n] ? sign(y) : 0 (strict >); optionally a p x p max-pool; cast.
//
// Where the TPU kernel keeps one sample's whole padded image and an
// [H*W, block_cout] accumulator in VMEM, a block here owns one
// (sample, tile of 64 output pixels, tile of 32 output channels):
//   * the pixel tile is th x tw with th*tw <= 64, aligned to the pool window so
//     the p x p max never leaves the block; ragged edges are masked;
//   * C_in is walked in chunks of 16: per chunk the block decodes its slice of
//     the packed bytes ONCE into shared memory (float operands) and stages the
//     (th+KH-1) x (tw+KW-1) input patch with the SAME zero border, converted to
//     float in registers on the way in (float or int8 input);
//   * 256 threads, each holding 2 pixels x 4 channels of float32 accumulators
//     (a warp = one group of 4 channels x 32 pixels, so the weight load is a
//     broadcast), plain FMAs on the CUDA cores.  With ternary or dyadic data every partial
//     sum is an integer (or a multiple of 1/4) and exact in float32 under any
//     summation order, so the result is bit-identical to the plain version;
//   * the epilogue runs on registers (pooled variants stage the ternarized tile
//     in shared memory to take the window max); the float32 accumulator never
//     reaches device memory on the fused variants.
//
// Bound on this card: at the serving shapes (at most 8x64x64x64 outputs per
// launch) the work is tens of microseconds of CUDA-core FMAs at best and a few
// hundred kilobytes of traffic, so a launch is bounded by operations, then by
// launch latency — not by bytes.  This first version does not use the tensor
// cores (int8 x int8 -> int32 mma is the later step).
//
// The three TCONV_ABLATE_* macros compile one phase of the main loop out (weight
// decode, patch staging, FMA walk).  They exist for
// benchmarks/kernel_ablate_torch.py, which times the variants to show where a
// launch's time goes; the results of an ablated build are wrong by design and
// the package never defines them.
//
// Interface: plain C, loaded with ctypes.  The launcher enqueues on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePix = 64;    // output pixels per block (pre-pool)
constexpr int kTileN = 32;      // output channels per block
constexpr int kChunkC = 16;     // input channels staged per step
constexpr int kPatchStride = kChunkC + 1;  // +1 float: neighbouring pixels hit different banks
constexpr int kOutStride = kTileN + 1;     // same for the pooled variants' staged output tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// acc[2 pixels][4 channels] += x * w for one input channel: one 16-byte load
// of four decoded weights, eight FMAs.
__device__ __forceinline__ void fma_step(float (&acc)[2][4], const float* w4, float a, float b) {
  const float4 wv = *reinterpret_cast<const float4*>(w4);
  acc[0][0] = fmaf(a, wv.x, acc[0][0]);
  acc[0][1] = fmaf(a, wv.y, acc[0][1]);
  acc[0][2] = fmaf(a, wv.z, acc[0][2]);
  acc[0][3] = fmaf(a, wv.w, acc[0][3]);
  acc[1][0] = fmaf(b, wv.x, acc[1][0]);
  acc[1][1] = fmaf(b, wv.y, acc[1][1]);
  acc[1][2] = fmaf(b, wv.z, acc[1][2]);
  acc[1][3] = fmaf(b, wv.w, acc[1][3]);
}

// Floats of dynamic shared memory one block needs.
__host__ __device__ inline size_t smem_floats(int kh, int kw, int th, int tw, bool pool) {
  size_t w = static_cast<size_t>(kh) * kw * kChunkC * kTileN;
  size_t x = static_cast<size_t>(th + kh - 1) * (tw + kw - 1) * kPatchStride;
  size_t o = pool ? static_cast<size_t>(kTilePix) * kOutStride : 0;
  return w + x + o;
}

template <typename TIn, typename TOut, bool kTernarize, bool kPool>
__global__ void __launch_bounds__(kThreads)
tconv_kernel(const TIn* __restrict__ x, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, const float* __restrict__ thr,
             TOut* __restrict__ out, int H, int W, int C_in, int KH, int KW,
             int C_out, int th, int tw, int pool) {
  extern __shared__ __align__(16) float smem[];
  const int taps = KH * KW;
  const int patch_h = th + KH - 1, patch_w = tw + KW - 1;
  float* w_s = smem;                                  // [taps][kChunkC][kTileN]
  float* x_s = w_s + taps * kChunkC * kTileN;         // [patch_h*patch_w][kPatchStride]
  float* o_s = x_s + patch_h * patch_w * kPatchStride;  // [kTilePix][kOutStride], pooled variants

  const int tid = threadIdx.x;
  const int tiles_x = (W + tw - 1) / tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int pad_top = KH / 2, pad_left = KW / 2;
  const int c4_total = C_in >> 2;

  // thread -> 4 output channels x 2 pixels of the tile.  A warp shares its
  // channel group, so the 16-byte weight load is one broadcast, and its lanes
  // hold 32 different pixels, whose patch rows lie kPatchStride floats apart
  const int cg = tid >> 5;
  const int n_pix = th * tw;
  int pix[2], py[2], px[2];
  bool live[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    pix[j] = (tid & 31) + 32 * j;
    live[j] = pix[j] < n_pix;
    const int p = live[j] ? pix[j] : 0;   // dead lanes read pixel 0, write nothing
    py[j] = p / tw;
    px[j] = p % tw;
  }

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  for (int c0 = 0; c0 < C_in; c0 += kChunkC) {
    const int ck = min(kChunkC, C_in - c0);   // multiple of 4
    const int cq_n = ck >> 2;

#ifndef TCONV_ABLATE_DECODE
    // decode this block's packed weight bytes once: plus = b1, minus = NOR(b1, b0).
    // A thread keeps its output channel and strides over (tap, byte) rows; the
    // loop is unrolled so that several global loads are in flight at once.
    {
      const int n = tid & (kTileN - 1);
      const int gn = n0 + n;
#pragma unroll 4
      for (int r = tid / kTileN; r < taps * cq_n; r += kThreads / kTileN) {
        const int cq = r % cq_n;
        const int tap = r / cq_n;
        uint8_t byte = 0x55;   // four zero trits: channels past C_out contribute nothing
        if (gn < C_out)
          byte = wp[(static_cast<size_t>(tap) * c4_total + (c0 >> 2) + cq) * C_out + gn];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int code = (byte >> (2 * s)) & 3;
          const int plus = (code >> 1) & 1;
          const int minus = ((code | (code >> 1)) & 1) ^ 1;
          w_s[(tap * kChunkC + cq * 4 + s) * kTileN + n] = static_cast<float>(plus - minus);
        }
      }
    }
#endif
#ifndef TCONV_ABLATE_STAGE
    // stage the input patch with its zero border: a thread keeps its channel
    // and strides over the patch's pixels (threads past the last whole pixel
    // group idle), again unrolled for loads in flight
    {
      const int cc = tid % ck;
      const int r_step = kThreads / ck;
      const int r_first = tid / ck;
      if (r_first < r_step) {
#pragma unroll 4
        for (int r = r_first; r < patch_h * patch_w; r += r_step) {
          const int iy = y0 + r / patch_w - pad_top;
          const int ix = x0 + r % patch_w - pad_left;
          float v = 0.0f;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            v = to_f32(x[((static_cast<size_t>(b) * H + iy) * W + ix) * C_in + c0 + cc]);
          x_s[r * kPatchStride + cc] = v;
        }
      }
    }
#endif
    __syncthreads();

#ifndef TCONV_ABLATE_FMA
    for (int tap = 0; tap < taps; ++tap) {
      const int dy = tap / KW, dx = tap % KW;
      const float* xa = x_s + ((py[0] + dy) * patch_w + px[0] + dx) * kPatchStride;
      const float* xb = x_s + ((py[1] + dy) * patch_w + px[1] + dx) * kPatchStride;
      const float* wr = w_s + tap * kChunkC * kTileN + cg * 4;
      if (ck == kChunkC) {
        // full chunk: unrolled, so the shared-memory loads of later channels
        // are in flight while the FMAs of earlier ones retire
#pragma unroll
        for (int cc = 0; cc < kChunkC; ++cc) fma_step(acc, wr + cc * kTileN, xa[cc], xb[cc]);
      } else {
        for (int cc = 0; cc < ck; ++cc) fma_step(acc, wr + cc * kTileN, xa[cc], xb[cc]);
      }
    }
#endif
    __syncthreads();
  }

  // epilogue: scale -> ThFU ternarize (strict >) -> [pool] -> cast
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = n0 + cg * 4 + k;
      float y = 0.0f;
      if (n < C_out) {
        y = acc[j][k] * scale[n];
        if (kTernarize) {
          const float t = thr[n];
          y = fabsf(y) > t ? (y > 0.0f ? 1.0f : -1.0f) : 0.0f;
        }
      }
      acc[j][k] = y;
    }
  }

  if (!kPool) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int oy = y0 + py[j], ox = x0 + px[j];
      if (!live[j] || oy >= H || ox >= W) continue;
      TOut* o = out + ((static_cast<size_t>(b) * H + oy) * W + ox) * C_out;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + cg * 4 + k;
        if (n < C_out) o[n] = static_cast<TOut>(acc[j][k]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!live[j]) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) o_s[pix[j] * kOutStride + cg * 4 + k] = acc[j][k];
    }
    __syncthreads();
    // H and W are multiples of pool and the tile origin is pool-aligned, so a
    // pooled pixel inside the output lies wholly inside the image and the tile
    const int OH = H / pool, OW = W / pool;
    const int oth = th / pool, otw = tw / pool;
    for (int i = tid; i < oth * otw * kTileN; i += kThreads) {
      const int n = i % kTileN;
      const int r = i / kTileN;
      const int qy = r / otw, qx = r % otw;
      const int oy = y0 / pool + qy, ox = x0 / pool + qx;
      if (oy >= OH || ox >= OW || n0 + n >= C_out) continue;
      float m = -INFINITY;
      for (int a = 0; a < pool; ++a)
        for (int c = 0; c < pool; ++c)
          m = fmaxf(m, o_s[((qy * pool + a) * tw + qx * pool + c) * kOutStride + n]);
      out[((static_cast<size_t>(b) * OH + oy) * OW + ox) * C_out + n0 + n] =
          static_cast<TOut>(m);
    }
  }
}

template <typename TIn, typename TOut, bool kTernarize, bool kPool>
int launch(const void* x, const void* wp, const float* scale, const float* thr,
           void* out, int B, int H, int W, int C_in, int KH, int KW, int C_out,
           int th, int tw, int pool, cudaStream_t stream) {
  auto kern = tconv_kernel<TIn, TOut, kTernarize, kPool>;
  const size_t smem = smem_floats(KH, KW, th, tw, kPool) * sizeof(float);
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

}  // namespace

// Returns 0 when the kernel was launched, a cudaError_t when the launch was
// refused, and a negative code for arguments the kernel does not take
// (-1 geometry, -2 int8 output without fuse_ternary).
extern "C" int ternary_conv2d_launch(
    const void* x, int x_is_int8, const void* w_packed, const void* scale,
    const void* threshold, void* out, int out_is_int8, int B, int H, int W,
    int C_in, int KH, int KW, int C_out, int tile_h, int tile_w,
    int fuse_ternary, int fuse_pool, void* stream) {
  const int pool = fuse_pool > 1 ? fuse_pool : 1;
  if (B < 1 || H < 1 || W < 1 || C_in < 4 || (C_in & 3) || KH < 1 || KW < 1 ||
      C_out < 1 || tile_h < 1 || tile_w < 1 || tile_h * tile_w > kTilePix ||
      tile_h % pool || tile_w % pool || H % pool || W % pool || B > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* th = static_cast<const float*>(threshold);
  if (x_is_int8)
    return dispatch<int8_t>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in,
                            KH, KW, C_out, tile_h, tile_w, fuse_ternary, pool, s);
  return dispatch<float>(x, w_packed, sc, th, out, out_is_int8, B, H, W, C_in,
                         KH, KW, C_out, tile_h, tile_w, fuse_ternary, pool, s);
}
