// Packed-ternary matmul for Hopper (sm_90a) — CUTIE's arithmetic on 2-bit weights.
//
// Replaces the TPU kernel `_tmm_kernel` of src/repro/kernels/ternary_matmul.py
// (launched by `ternary_matmul_pallas`, with its `_select_tile` decode).  It
// computes the same function and is laid out anew for the card:
//
//   y[m,n] = (sum_k x[m,k] * t[k,n]) * scale[n],   float32 accumulation,
//
// with t in {-1,0,+1} decoded in the kernel from the quantizer's 2-bit packed
// bytes w_packed[K/4, N], packed along K: byte row r holds K rows 4r..4r+3 at
// bit shifts 0/2/4/6 (plus = b1, minus = NOR(b1,b0), operand = plus - minus).
// The output has x's type: float32, or bf16 rounded to nearest even.
//
// Where the TPU kernel walks K as the innermost, sequential grid axis with a
// [block_m, block_n] accumulator in VMEM scratch, a block here owns one
// 64 x 64 output tile and walks all of K itself, the accumulator in registers:
//   * K is walked in chunks of 32.  Per chunk the block stages the 64 x 32 x
//     tile (bf16 widened to float32 on load, which is exact) transposed in
//     shared memory, and decodes its 8 x 64 packed weight bytes ONCE into a
//     32 x 64 float tile of select operands.  Rows past K and columns past N
//     are zero, so a ragged last chunk (K = 100, K = 4) needs no special case;
//   * 256 threads, each holding a 4 x 4 float32 micro-tile, plain FMAs on the
//     CUDA cores (no TF32, no fast-math).  With ternary or dyadic x every
//     partial sum is an integer or a dyadic value and exact in float32 under
//     any order, so the result is bit-identical to the plain version;
//   * the epilogue multiplies by scale in float32 and writes x's type; ragged
//     M and N are masked.
//
// Bound on this card (H100 SXM, published peaks): at the quickstart shape
// 64 x 2048 x 512 in float32 the work is 134.2 M operations -> 2.0 us at
// 67 TFLOP/s on the CUDA cores, against 0.92 MB of traffic -> 0.27 us at
// 3.35 TB/s: bounded by operations (512 x 2048 x 512: 16.0 us vs 1.6 us).
// The weights stay packed in device memory (8x fewer bytes than bf16), which
// is the part of the TPU kernel's design that carries over.  This first
// version does not reach the bound: the grid has one block per 64 x 64 tile
// (8 blocks at the quickstart shape), so most SMs idle; a split of K across
// blocks and the tensor cores (the decoded tile is exact in bf16 and int8)
// are the later steps.
//
// Interface: plain C, loaded with ctypes.  The launcher enqueues on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;          // output rows per block
constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 32;          // K rows staged per step (a multiple of 4)
constexpr int kXStride = kBM + 4;  // floats per staged K row; keeps float4 reads aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
           const float* __restrict__ scale, T* __restrict__ out,
           int M, int K, int N) {
  __shared__ __align__(16) float x_s[kBK][kXStride];  // x tile, transposed: [k][m]
  __shared__ __align__(16) float w_s[kBK][kBN];       // decoded operands: [k][n]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int K4 = K >> 2;
  // thread -> rows m0 + 4*ty .. +3, columns n0 + 4*tx .. +3
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage x: a warp reads 32 consecutive K values of one row (coalesced)
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.0f;
      if (gm < M && gk < K) v = to_f32(x[static_cast<size_t>(gm) * K + gk]);
      x_s[c][r] = v;
    }
    // decode the packed bytes once: byte row r -> K rows 4r..4r+3
#pragma unroll
    for (int i = 0; i < (kBK / 4) * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, n = e % kBN;
      const int gr = (k0 >> 2) + r, gn = n0 + n;
      uint8_t byte = 0x55;   // four zero trits: rows past K, columns past N
      if (gr < K4 && gn < N) byte = wp[static_cast<size_t>(gr) * N + gn];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int code = (byte >> (2 * s)) & 3;
        const int plus = (code >> 1) & 1;
        const int minus = ((code | (code >> 1)) & 1) ^ 1;
        w_s[4 * r + s][n] = static_cast<float>(plus - minus);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&x_s[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&w_s[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: scale in float32, then x's type; ragged M and N masked
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + 4 * ty + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + 4 * tx + j;
      if (gn < N) store(out + static_cast<size_t>(gm) * N + gn, acc[i][j] * scale[gn]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wp, const float* scale, void* out,
           int M, int K, int N, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp), scale,
      static_cast<T*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 when the kernel was launched, a cudaError_t when the launch was
// refused, and -1 for a geometry the kernel does not take.
extern "C" int ternary_matmul_launch(
    const void* x, int x_is_bf16, const void* w_packed, const void* scale,
    void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < 4 || (K & 3) || N < 1 || (M + kBM - 1) / kBM > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (x_is_bf16) return launch<__nv_bfloat16>(x, w_packed, sc, out, M, K, N, s);
  return launch<float>(x, w_packed, sc, out, M, K, N, s);
}
