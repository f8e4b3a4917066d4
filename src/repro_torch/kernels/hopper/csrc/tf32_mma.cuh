// 3xTF32 products on Hopper's tensor cores with mma.sync m16n8k8, and the
// cp.async copies that stage f32 tiles for them: shared by the f32 routes of
// B4 (flash_attention.cu) and B5 (ssd_scan.cu).  Each .cu file is its own
// library, so everything here has internal linkage.
//
// An f32 operand is split into two TF32 halves, each rounded to nearest
// with ties away from zero (cvt.rna's rounding): hi = tf32(x), lo =
// tf32(x - hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo is
// below f32 rounding).  One-pass TF32 keeps about three decimal digits.  The tensor
// cores add into their f32 accumulator by truncation, so callers keep each
// chain short: a few k-steps into a zeroed fragment, then an IEEE f32 add.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8,
// row-major) holds rows g, g + 8 at columns t, t + 4 as a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) holds column g
// at rows t, t + 4; the accumulator rows g, g + 8 at columns 2t, 2t + 1 as
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  Where
// the k index is summed, an accumulator fragment serves as the A fragment
// of the next product unchanged if A's column j stands for k row 2j (j < 4)
// or 2 (j - 4) + 1: a = {c0, c2, c1, c3}, with B's rows read in that order
// (row 2t for b0, 2t + 1 for b1).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, the 13 low bits cleared) in two integer instructions instead
// of cvt's longer sequence: half a TF32 step added to the magnitude's bits
// carries into the kept bits exactly where cvt.rna rounds up, and an
// infinity stays one.  Not for NaNs: a high payload (0x7fffffff, the card's
// own NaN) carries into the sign bit.  The splits run at every fragment
// load, so their cost is much of the kernels' (PERF.md section 6).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as two TF32 halves: hi = tf32(x), lo = tf32(x - hi), the bits of
// cvt.rna.tf32.f32 for every x that is not a NaN.  Where x is a NaN or an
// infinity, x - hi is the card's NaN, 0x7fffffff; capping lo's bits at
// 0x7fffefff before the rounding add keeps it a NaN (0x7fffe000), so a NaN
// or an infinity in an operand gives NaN products, as the plain versions
// give.  No other x - hi reaches the cap (its bits are a finite float's, or
// negative as an int).  flash_attention.cu's tf32_split_check holds these
// bits to cvt.rna's on the card.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  const int d = __float_as_int(x - __uint_as_float(hi));
  lo = static_cast<uint32_t>(min(d, 0x7fffefff) + 0x1000) & 0xffffe000u;
}

// c += a b, m16n8k8, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment from four f32 values (a0 .. a3), split into halves.
__device__ __forceinline__ void split_a(uint32_t (&ah)[4], uint32_t (&al)[4], float a0, float a1,
                                       float a2, float a3) {
  split(a0, ah[0], al[0]);
  split(a1, ah[1], al[1]);
  split(a2, ah[2], al[2]);
  split(a3, ah[3], al[3]);
}

// c += a b in 3xTF32, B's two f32 values split here: a_lo b_hi, a_hi b_lo,
// a_hi b_hi, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(c, al, h0, h1);
  mma(c, ah, l0, l1);
  mma(c, ah, h0, h1);
}

}  // namespace tf32
}  // namespace
