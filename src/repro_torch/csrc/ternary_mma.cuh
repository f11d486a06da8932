// Shared pieces of the two packed-ternary kernels for Hopper (sm_90a):
// the 2-bit decode straight into tensor-core fragments, the exact three-way
// bf16 split of a float32 operand, and thin inline-PTX wrappers for the two
// `mma.sync` shapes and for `cp.async`.
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
// `mma.sync` and not `wgmma`: at the shapes these kernels serve (a pool tick's
// conv layers, a 64-row matmul) the bound is 0.2-2 us per launch and what
// separates a launch from it is occupancy and the dependent load/barrier
// chain, not the tensor-core rate.  A warp-level mma keeps tiles small enough
// to fill 132 SMs; `wgmma` + TMA is a later step if the rate ever binds.

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

}  // namespace tmma
