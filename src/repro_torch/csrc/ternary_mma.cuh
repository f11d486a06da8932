// Shared pieces of the two packed-ternary kernels for Hopper (sm_90a):
// the 2-bit decode straight into tensor-core fragments, the exact three-way
// bf16 split of a float32 operand, and thin inline-PTX wrappers for the two
// `mma.sync` shapes, for `cp.async`, and for the int8 `wgmma` of the conv's
// second route with its fences and shared-memory descriptor.
//
// Both kernels pack 4 consecutive elements of the REDUCTION axis into one
// byte (K for the matmul, C_in for the conv), code = trit + 1 at bit shifts
// 0/2/4/6, decoded by the OCU's select algebra: plus = b1, minus = NOR(b1, b0),
// operand = plus - minus.  Code 0 -> -1, code 1 -> 0, codes 2 and 3 -> +1.
// That packing fits the fragments of `mma.sync` directly:
//
//   * m16n8k32 s8: a thread's B register holds k = 4*tig .. 4*tig+3 of one
//     column n (tig = lane % 4, n = lane / 4) — exactly one packed byte,
//     expanded here to four int8 trits (`decode_s8x4`);
//   * m16n8k16 bf16: a B register holds k = 2*tig, 2*tig+1 — half a byte,
//     expanded to a bf16x2 (`decode_bf16x2`).  A kernel may permute the k
//     of one mma (the same permutation in A and B): mapping the mma's
//     2t, 2t+1, 2t+8, 2t+9 to 4t .. 4t+3 makes a lane's two B registers the
//     two nibbles of one byte (the matmul does this).
//
// So packed bytes travel from device memory to shared memory untouched and
// are expanded only in registers, at fragment load; weight traffic stays at
// 2 bits per trit.
//
// `mma.sync` where a launch is bound by latency: at a pool tick's conv layers
// and a 64-row matmul the bound is 0.2-2 us per launch and what separates a
// launch from it is occupancy and the dependent load/barrier chain, not the
// tensor-core rate; a warp-level mma keeps tiles small enough to fill 132
// SMs.  `wgmma` (m64nNk32 s8, A from registers, B from shared memory through
// a descriptor) where the rate binds: the conv's int8 launches that fill the
// card many times over (ternary_conv2d.cu, route 1).  The wgmma B operand is
// decoded once into shared memory in the K-major no-swizzle layout, since a
// descriptor can only point at bytes, not at a decode.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tmma {

// One packed byte -> four int8 trits in one 32-bit register (lane s holds the
// trit of bit shift 2s, i.e. the s-th consecutive element of the reduction).
__device__ __forceinline__ uint32_t decode_s8x4(uint32_t byte) {
  // spread the four 2-bit codes into the low bits of four byte lanes
  const uint32_t s = (byte & 0x3u) | ((byte & 0xCu) << 6) | ((byte & 0x30u) << 12) |
                     ((byte & 0xC0u) << 18);
  const uint32_t b0 = s & 0x01010101u;
  const uint32_t b1 = (s >> 1) & 0x01010101u;
  const uint32_t minus = (b0 | b1) ^ 0x01010101u;   // NOR(b1, b0)
  return b1 | (minus * 0xFFu);                      // +1 -> 0x01, -1 -> 0xFF, 0 -> 0x00
}

// The two codes in bits 0-3 of v (a nibble: v = byte >> (4*h), h = 0 or 1;
// higher bits are ignored) -> a bf16x2 whose low half holds the element of
// the lower shift.  One byte permute over two 4-entry tables indexed by the
// code: the low bytes {0x80, 0x00, 0x80, 0x80} and the high bytes
// {0xBF, 0x00, 0x3F, 0x3F} of bf16 -1.0 (0xBF80), 0 and +1.0 (0x3F80).
__device__ __forceinline__ uint32_t decode_bf16x2(uint32_t v) {
  const uint32_t c = (v & 0x3u) | ((v << 6) & 0x300u);   // code 0 at bits 0-1, code 1 at 8-9
  // selector nibbles: low byte <- table[code], high byte <- table[4 + code]
  return __byte_perm(0x80800080u, 0x3F3F00BFu, c * 0x11u + 0x4040u);
}

// Exact three-way split of two float32 values into bf16x2 registers:
// x = hi + mid + lo bit for bit, each term a bf16 value obtained by
// truncating the remainder to its top 16 bits (8 significant bits).  The
// remainders x - hi and r - mid are exact in float32 (same sign, |hi| <= |x|),
// and the last remainder has at most 8 significant bits, so lo is exact too —
// for finite normal x whose lo term does not underflow (|x| above ~2^-110).
// The products of each term with a trit are exact, which makes three mmas
// over the terms an exact float32 x ternary product up to accumulation order.
struct Bf16x3 {
  uint32_t hi, mid, lo;
};

__device__ __forceinline__ float trunc_bf16(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

__device__ __forceinline__ Bf16x3 split_bf16x3(float x0, float x1) {
  const float h0 = trunc_bf16(x0), h1 = trunc_bf16(x1);
  const float r0 = x0 - h0, r1 = x1 - h1;
  const float m0 = trunc_bf16(r0), m1 = trunc_bf16(r1);
  const float l0 = r0 - m0, l1 = r1 - m1;
  Bf16x3 out;
  out.hi = __byte_perm(__float_as_uint(h0), __float_as_uint(h1), 0x7632);
  out.mid = __byte_perm(__float_as_uint(m0), __float_as_uint(m1), 0x7632);
  out.lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
  return out;
}

// d += a * b on the tensor cores: m16n8k32, int8 x int8 -> int32 (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores: m16n8k16, bf16 x bf16 -> float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous global -> shared copies of 4, 8 or 16 bytes.  With
// src_bytes = 0 nothing is read and the destination is zero-filled; the
// source address must still be a valid, aligned address.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? kBytes : 0;
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem_src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(gmem_src), "n"(kBytes), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending committed groups of this thread are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}


// ---- wgmma (sm_90a): a warpgroup's asynchronous 64 x N x 32 product --------
//
// The A fragment of m64nNk32 with 8-bit A in registers is, per warp w of the
// warpgroup, the m16n8k32 A fragment of rows 16w .. 16w+15: a thread's four
// registers hold rows g, g+8 (g = lane / 4) x k = 4t .. 4t+3 and 16+4t ..
// 16+4t+3 (t = lane % 4), in the order {(g, lo), (g+8, lo), (g, hi), (g+8, hi)}.
// The accumulator holds, for each 8-column group j, rows g and g+8 x columns
// 8j + 2t, 8j + 2t + 1: d[4j] (g, 2t), d[4j+1] (g, 2t+1), d[4j+2] (g+8, 2t),
// d[4j+3] (g+8, 2t+1).

// A shared-memory matrix descriptor, no swizzle: the operand is made of core
// matrices of 8 rows x 16 bytes (128 contiguous bytes, rows 16 B apart);
// `lbo` is the byte distance between core matrices adjacent along K, `sbo`
// between core matrices adjacent along M or N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Register writes (A fragments, accumulators) ordered before the wgmmas
// that follow; issued by the whole warpgroup.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending committed wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// A use and a redefinition of each register that the compiler cannot see
// through.  ptxas does not know that an in-flight wgmma still reads its A
// registers (nor the accumulators it writes): placed after the wgmma_wait
// that retires the last wgmma reading them, this keeps the registers' values
// live, and their physical registers unused by anything else, until then.
template <typename T, int kRegs>
__device__ __forceinline__ void fence_operands(T (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Shared-memory writes of this thread made visible to the async proxy, which
// reads the wgmma B operand.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among ``threads`` threads (a warpgroup) on named barrier ``id``.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// d[32] (+)= a * b: m64n64k32, A (s8) from registers, B (s8) from shared memory
// through its descriptor, int32 accumulators; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d[48] (+)= a * b: m64n96k32, A (s8) from registers, B (s8) from shared memory
// through its descriptor, int32 accumulators; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace tmma
