// tf32x3 — f32 products on Hopper's TF32 tensor cores, to f32 accuracy.
//
// An f32 operand a is split into two TF32 values, hi = tf32(a) and
// lo = tf32(a - hi), both rounded to nearest (ties away), as
// cvt.rna.tf32.f32 rounds. hi keeps 10
// mantissa bits, lo the next 11 (a - hi is exact in f32), so hi + lo is
// within 2^-22 |a| of a. A product is then taken as three TF32 products
// accumulated in f32,
//
//   a·b ≈ lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b),
//
// the small terms first; the dropped lo·lo term is ~2^-22 relative. An
// operand that is exact in TF32 (a widened bf16, 8 mantissa bits) has
// lo = 0, and its product with a split operand takes two terms; two exact
// operands take one. Three products cost 3x the operations at 7.4x the
// CUDA cores' f32 rate (495 against 67 TFLOP/s on an H100 SXM).
//
// The product is one warp-wide mma.sync.m16n8k8 (row-major A, "col" B,
// f32 accumulators). Fragments, with g = lane / 4 and t = lane % 4:
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8]:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <stdint.h>

namespace tf32x3 {

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, on
// the magnitude), taken with integer operations on the f32 bits: add half
// a TF32 ulp (bit 12), and the carry rounds the 10 kept mantissa bits up
// exactly when the 13 dropped bits are at least half an ulp. The tensor
// cores ignore the low 13 bits of a TF32 operand, so to_tf32 leaves them
// as the addition writes them. (The conversion instruction itself issues
// at a fraction of the integer pipes' rate, and a split takes two.)
// Finite inputs only: an inf becomes NaN here, and a value within half a
// TF32 ulp of FLT_MAX rounds to inf (its lo then to NaN); the wrappers
// (fed_mix.py, flash_attention.py) state this contract.
__device__ __forceinline__ uint32_t to_tf32(float a) { return __float_as_uint(a) + 0x1000u; }

// a = hi + lo (+ ~2^-22 |a|); hi's low 13 bits are cleared so that a - hi
// is taken from the TF32 value
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a) & 0xffffe000u;
  lo = to_tf32(a - __uint_as_float(hi));
}

// a widened bf16 (its raw 16 bits) as a TF32 operand: exact, lo = 0
__device__ __forceinline__ uint32_t bf16_bits(uint16_t v) { return (uint32_t)v << 16; }

// c += a · b, one m16n8k8 TF32 tensor-core product, f32 accumulation. Not
// volatile: the compiler may interleave products on other accumulators
// between the dependent ones.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The split-f32 step for one A fragment and N B fragments:
// c[n] += a · b[n], term by term over the N accumulators (all lo·hi, then
// all hi·lo, then all hi·hi), so that no product waits on the one before
// it. An operand exact in TF32 (kExactA / kExactB: a widened bf16) has
// lo = 0 and its term is left out: two products, or one when both are.
template <int N, bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_split(float (&c)[N][4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[N][2],
                                          const uint32_t (&b_lo)[N][2]) {
  if constexpr (!kExactA) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[n], a_lo, b_hi[n]);
  }
  if constexpr (!kExactB) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[n], a_hi, b_lo[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], a_hi, b_hi[n]);
}

}  // namespace tf32x3
