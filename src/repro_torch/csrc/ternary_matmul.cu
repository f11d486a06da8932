// Packed-ternary matmul for Hopper (sm_90a) — CUTIE's arithmetic on 2-bit weights.
//
// Replaces the TPU kernel `_tmm_kernel` of src/repro/kernels/ternary_matmul.py
// (launched by `ternary_matmul_pallas`, with its `_select_tile` decode).  It
// computes the same function and is laid out anew for the card:
//
//   y[m,n] = (sum_k x[m,k] * t[k,n]) * scale[n],   float32 accumulation,
//
// with t in {-1,0,+1} decoded in registers from the quantizer's 2-bit packed
// bytes w_packed[K/4, N], packed along K: byte row r holds K rows 4r..4r+3 at
// bit shifts 0/2/4/6 (plus = b1, minus = NOR(b1,b0), operand = plus - minus).
// The output has x's type: float32, or bf16 rounded to nearest even.
//
// Bound on this card (H100 SXM, published peaks): at the quickstart shape
// 64 x 2048 x 512 the work is 134.2 M operations — 2.0 us on the float32
// CUDA cores, 0.14 us on the bf16 tensor cores — against 0.59-0.92 MB of
// traffic (0.18-0.27 us at 3.35 TB/s).  The first version of this kernel took
// 105 us there: one block per 64 x 64 tile gave 8 blocks on 132 SMs, each
// walking K = 2048 in 64 serial load -> decode -> barrier -> FMA chunks.
// This design attacks that chain:
//
//   * Fill the card.  A block owns a 64 x 32 output tile and one split of K;
//     the host-side plan (`matmul_plan` in kernels/ternary_matmul.py) picks
//     the split so that small-M shapes still launch >= 128 blocks (the
//     quickstart: 16 tiles x 8 splits).  The splits of one tile form one
//     thread-block cluster (<= 8 blocks, portable); after the K walk each
//     block leaves its float32 partial tile in shared memory, and the blocks
//     of the cluster sum the partials through distributed shared memory in
//     rank order, apply scale and write the output — one launch, no
//     workspace, no atomics, the same bits on every launch.  A shape with
//     enough tiles takes no split and no cluster.
//   * Tensor cores.  Eight warps: warp w owns rows 32(w % 2) .. +31 (two m16
//     row blocks) and all 32 columns (four n8 subtiles), and k-step w / 2 of
//     every 64-deep chunk (four k-steps of 16).  So each warp runs one
//     k-step per chunk — a short dependent chain — and one decoded B
//     fragment feeds two row blocks; the four k-quarters add their tiles in
//     a fixed order.  B fragments come straight from the packed bytes
//     (ternary_mma.cuh), with two permutations that leave the sum unchanged:
//     the mma's k = 2t, 2t+1, 2t+8, 2t+9 are K rows 4t .. 4t+3 of the k-step,
//     so a lane's two B registers are the two nibbles of one packed byte and
//     its A registers one 16-byte (float32) or 8-byte (bf16) load per row;
//     and subtile j's column n is tile column 4n + j, so a lane's four bytes
//     (j = 0..3) are one 32-bit shared load.  bf16 x is an A operand as it
//     is.  float32 x is split exactly into three bf16 terms
//     (x = hi + mid + lo) and runs three mmas per fragment; a trit times a
//     bf16 term is exact, so the float32 route is exact on dyadic data.  When
//     no lane of a warp has a nonzero mid or lo term (bf16-exact data) the
//     two extra mmas are skipped.  Chosen over CUDA-core FMAs, whose float32
//     bound alone (2.0 us at the quickstart shape) is larger than the whole
//     tensor-core walk; benchmarks/kernel_ablate_torch.py measures the walk.
//   * Short mma chains.  The tensor cores' float32 accumulation is not
//     round-to-nearest (truncated alignment on earlier generations; Fasi et
//     al., 2021).  Each k-step accumulates into fresh fragments (the hi term,
//     and the lo and mid terms) that are added to float32 register
//     accumulators on the CUDA cores, so no tensor-core chain is longer than
//     2 mmas.
//   * Asynchronous staging.  A three-stage `cp.async` ring holds 64-deep
//     chunks of x (float32 or bf16, padded rows: conflict-free fragment
//     loads) and of the packed bytes; the loads of chunk c+2 are in flight
//     while chunk c's mmas run, with one barrier per chunk.  x past M or past
//     the split's end is zero-filled; bytes past K or N read as 0x55 (zero
//     trits).  A packed row of N bytes with N % 4 != 0 is loaded byte by byte.
//
// The TMM_ABLATE_* macros compile one phase out (staging, fragment decode, mma
// walk, cross-split reduction).  They exist for benchmarks/kernel_ablate_torch.py,
// which times the variants to show where a launch's time goes; an ablated build
// is wrong by design and the package never defines them.
//
// Interface: plain C, loaded with ctypes.  The launcher enqueues on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 = launched).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ternary_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // eight warps: rows 32(w % 2) .., k-step w / 2 of each chunk
constexpr int kBM = 64;           // output rows per block
constexpr int kBN = 32;           // output columns per block: four n8 subtiles
constexpr int kBK = 64;           // K per staged chunk
constexpr int kStages = 3;        // cp.async ring: one barrier per chunk
constexpr int kMmaK = 16;         // depth of one bf16 mma; splits are multiples
constexpr int kKSteps = kBK / kMmaK;  // k-steps per chunk: one per k-quarter of the warps
constexpr int kMaxSplits = 8;     // portable cluster size
constexpr int kXStride = kBK + 16;    // elements per staged x row: conflict-free A loads
constexpr int kPartStride = kBN + 1;  // floats per row of a partial tile: conflict-free stores

template <typename T>
struct Stage {
  static constexpr int kXBytes = kBM * kXStride * static_cast<int>(sizeof(T));
  static constexpr int kWBytes = (kBK / 4) * kBN;
  static constexpr int kBytes = kXBytes + kWBytes;
  static constexpr int kRing = kStages * kBytes;
  // behind the ring: the four k-quarters' partial tiles
  static constexpr int kSmem = kRing + kKSteps * kBM * kPartStride * 4;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage chunk c of this block's K split into ring slot c % kStages.
template <typename T>
__device__ __forceinline__ void stage_chunk(unsigned char* smem, int c, const T* __restrict__ x,
                                            const uint8_t* __restrict__ wp, int M, int K, int N,
                                            int m0, int n0, int k_begin, int k_end) {
#ifndef TMM_ABLATE_STAGE
  unsigned char* st = smem + (c % kStages) * Stage<T>::kBytes;
  T* xs = reinterpret_cast<T*>(st);
  uint8_t* ws = st + Stage<T>::kXBytes;
  const int tid = threadIdx.x;
  const int k0 = k_begin + c * kBK;
  // x: 64 rows x 16 groups of 4 elements (16 B float32, 8 B bf16); K is a
  // multiple of 4, so a group lies wholly inside or outside [k0, k_end)
#pragma unroll
  for (int i = tid; i < kBM * (kBK / 4); i += kThreads) {
    const int r = i / (kBK / 4), q = i % (kBK / 4);
    const int gm = m0 + r, gk = k0 + 4 * q;
    const bool ok = gm < M && gk < k_end;
    const T* src = ok ? x + static_cast<size_t>(gm) * K + gk : x;
    tmma::cp_async<4 * sizeof(T)>(xs + r * kXStride + 4 * q, src, ok);
  }
  // packed bytes: 16 byte rows x 32 columns
  const int r0 = k0 >> 2, K4 = K >> 2;
  if ((N & 3) == 0) {
    for (int i = tid; i < (kBK / 4) * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), q = i % (kBN / 4);
      const int gr = r0 + r, gn = n0 + 4 * q;
      uint8_t* dst = ws + r * kBN + 4 * q;
      if (gr < K4 && gn < N)
        tmma::cp_async<4>(dst, wp + static_cast<size_t>(gr) * N + gn, true);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0x55555555u;   // four zero trits per byte
    }
  } else {
    for (int i = tid; i < (kBK / 4) * kBN; i += kThreads) {
      const int r = i / kBN, n = i % kBN;
      const int gr = r0 + r, gn = n0 + n;
      ws[r * kBN + n] = (gr < K4 && gn < N) ? wp[static_cast<size_t>(gr) * N + gn] : 0x55;
    }
  }
#endif
}

// acc += A B for one k-step over the warp's two m16 row blocks.  xr points at
// the lane's row g, K row 4t of the k-step; b holds subtile j's B registers.
// Each row block's products land in a fresh fragment first (short chains).
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const __nv_bfloat16* xr,
                                         const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    // K rows 4t, 4t+1 are the mma's k = 2t, 2t+1 (a0, a1); 4t+2, 4t+3 its 2t+8, 2t+9 (a2, a3)
    const uint2 v0 = *reinterpret_cast<const uint2*>(xr + 16 * f * kXStride);
    const uint2 v1 = *reinterpret_cast<const uint2*>(xr + (16 * f + 8) * kXStride);
    const uint32_t a[4] = {v0.x, v1.x, v0.y, v1.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#ifndef TMM_ABLATE_MMA
      tmma::mma_bf16(part, a, b[j][0], b[j][1]);
#else
      part[0] = __uint_as_float((a[0] ^ a[3] ^ b[j][0] ^ b[j][1]) & 0x3F800000u);
#endif
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] += part[i];
    }
  }
}

// float32 x: the exact three-way bf16 split; the hi term and the lo and mid
// terms go to separate fresh fragments, two independent mma chains.
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const float* xr,
                                         const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float4 v0 = *reinterpret_cast<const float4*>(xr + 16 * f * kXStride);
    const float4 v1 = *reinterpret_cast<const float4*>(xr + (16 * f + 8) * kXStride);
    const tmma::Bf16x3 s0 = tmma::split_bf16x3(v0.x, v0.y), s1 = tmma::split_bf16x3(v1.x, v1.y),
                       s2 = tmma::split_bf16x3(v0.z, v0.w), s3 = tmma::split_bf16x3(v1.z, v1.w);
    const uint32_t hi[4] = {s0.hi, s1.hi, s2.hi, s3.hi};
    const uint32_t mid[4] = {s0.mid, s1.mid, s2.mid, s3.mid};
    const uint32_t lo[4] = {s0.lo, s1.lo, s2.lo, s3.lo};
    const bool rest = __any_sync(0xffffffffu, (mid[0] | mid[1] | mid[2] | mid[3] | lo[0] | lo[1] |
                                               lo[2] | lo[3]) != 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rest_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#ifndef TMM_ABLATE_MMA
      tmma::mma_bf16(part, hi, b[j][0], b[j][1]);
      if (rest) {
        tmma::mma_bf16(rest_part, lo, b[j][0], b[j][1]);
        tmma::mma_bf16(rest_part, mid, b[j][0], b[j][1]);
      }
#else
      part[0] = __uint_as_float((hi[0] ^ mid[1] ^ lo[3] ^ b[j][0] ^ b[j][1]) & 0x3F800000u);
#endif
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] += part[i] + rest_part[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
           const float* __restrict__ scale, T* __restrict__ out,
           int M, int K, int N, int k_split, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, thread in group
  const int rows = (warp & 1) * 32;        // this warp's two m16 row blocks
  const int kq = warp >> 1;                // ... and its k-step of every chunk
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_chunks = (k_end - k_begin + kBK - 1) / kBK;

  float acc[2][4][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] = 0.0f;

  stage_chunk<T>(smem, 0, x, wp, M, K, N, m0, n0, k_begin, k_end);
  tmma::cp_async_commit();
  if (n_chunks > 1) stage_chunk<T>(smem, 1, x, wp, M, K, N, m0, n0, k_begin, k_end);
  tmma::cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    tmma::cp_async_wait<1>();   // every group but the newest has landed: chunk c
    __syncthreads();            // ... for all threads; slot (c+2)%3 = (c-1)%3 is free
    if (c + 2 < n_chunks) stage_chunk<T>(smem, c + 2, x, wp, M, K, N, m0, n0, k_begin, k_end);
    tmma::cp_async_commit();

    const int ksteps = (min(kBK, k_end - k_begin - c * kBK) + kMmaK - 1) / kMmaK;
    if (kq < ksteps) {
      const unsigned char* st = smem + (c % kStages) * Stage<T>::kBytes;
      // B: K rows 4t .. 4t+3 of k-step kq are packed byte row 4kq + t; tile
      // columns 4g .. 4g+3 are column g of subtiles j = 0..3: one 32-bit load
      const uint32_t wq = *reinterpret_cast<const uint32_t*>(
          st + Stage<T>::kXBytes + (4 * kq + t) * kBN + 4 * g);
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#ifndef TMM_ABLATE_DECODE
        b[j][0] = tmma::decode_bf16x2(wq >> (8 * j));       // K rows 4t, 4t+1
        b[j][1] = tmma::decode_bf16x2(wq >> (8 * j + 4));   // K rows 4t+2, 4t+3
#else
        b[j][0] = wq >> (8 * j);
        b[j][1] = wq >> (8 * j + 4);
#endif
      }
      const T* xs = reinterpret_cast<const T*>(st) + (rows + g) * kXStride + kq * kMmaK + 4 * t;
      mma_step(acc, xs, b);
    }
  }

  // each k-quarter's partial tile, in shared memory behind the ring: lane
  // (g, t) of subtile j holds rows g, g+8 and tile columns 4(2t) + j, 4(2t+1) + j
  float* part_s = reinterpret_cast<float*>(smem + Stage<T>::kRing);
  {
    float* mine = part_s + kq * kBM * kPartStride;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rows + 16 * f + g, c0 = 8 * t + j, c1 = 8 * t + 4 + j;
        mine[r * kPartStride + c0] = acc[f][j][0];
        mine[r * kPartStride + c1] = acc[f][j][1];
        mine[(r + 8) * kPartStride + c0] = acc[f][j][2];
        mine[(r + 8) * kPartStride + c1] = acc[f][j][3];
      }
  }
  __syncthreads();

  // the block's tile = the k-quarters in order; then the splits of the tile
  // in rank order through distributed shared memory, the blocks of the
  // cluster sharing the tile's elements among them
  auto quarters = [&](int r, int n) {
    const float* p = part_s + r * kPartStride + n;
    float s = p[0];
#pragma unroll
    for (int q = 1; q < kKSteps; ++q) s += p[q * kBM * kPartStride];
    return s;
  };
  auto emit = [&](int r, int n, float sum) {
    const int gm = m0 + r, gn = n0 + n;
    if (gm < M && gn < N) store(out + static_cast<size_t>(gm) * N + gn, sum * scale[gn]);
  };
#ifndef TMM_ABLATE_EPILOGUE
  if (splits > 1) {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN, n = e % kBN;
      part_s[r * kPartStride + n] = quarters(r, n);   // read and written by this thread only
    }
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    cluster.sync();
    for (int e = rank * kThreads + tid; e < kBM * kBN; e += kThreads * splits) {
      const int r = e / kBN, n = e % kBN;
      float p[kMaxSplits];   // all remote loads in flight together, then the sum in rank order
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) p[s] = *(cluster.map_shared_rank(part_s, s) + r * kPartStride + n);
      float sum = p[0];
#pragma unroll
      for (int s = 1; s < kMaxSplits; ++s)
        if (s < splits) sum += p[s];
      emit(r, n, sum);
    }
    cluster.sync();   // keep each partial alive until every rank has read it
    return;
  }
#endif
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, n = e % kBN;
    emit(r, n, quarters(r, n));
  }
}

template <typename T>
int launch(const void* x, const void* wp, const float* scale, void* out,
           int M, int K, int N, int k_split, int splits, cudaStream_t stream) {
  auto kern = tmm_kernel<T>;
  if (Stage<T>::kSmem > 48 * 1024) {
    // above the static limit a launch is refused unless the kernel opted in
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Stage<T>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Stage<T>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                                     static_cast<const uint8_t*>(wp), scale,
                                     static_cast<T*>(out), M, K, N, k_split, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 when the kernel was launched, a cudaError_t when the launch was
// refused, and -1 for a geometry or a plan the kernel does not take.  The plan
// (block_m, block_n, k_split, splits) comes from `matmul_plan` in
// repro_torch/kernels/ternary_matmul.py.
extern "C" int ternary_matmul_launch(
    const void* x, int x_is_bf16, const void* w_packed, const void* scale,
    void* out, int M, int K, int N, int block_m, int block_n, int k_split,
    int splits, void* stream) {
  if (M < 1 || K < 4 || (K & 3) || N < 1 || (M + kBM - 1) / kBM > 65535)
    return -1;
  if (block_m != kBM || block_n != kBN || k_split < kMmaK || k_split % kMmaK ||
      splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, w_packed, sc, out, M, K, N, k_split, splits, s);
  return launch<float>(x, w_packed, sc, out, M, K, N, k_split, splits, s);
}
