// tf32x3 — f32 products on Hopper's TF32 tensor cores, to f32 accuracy.
//
// An f32 operand a is split into two TF32 values: hi = tf32(a), rounded
// to nearest (ties away) as cvt.rna.tf32.f32 rounds, and lo = a - hi
// (exact in f32), of which the tensor cores read the top 11 significant
// bits. hi keeps 10 mantissa bits, so hi + lo is within 2^-21 |a| of a.
// A product is then taken as three TF32 products accumulated in f32,
//
//   a·b ≈ lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b),
//
// the small terms first; the dropped lo·lo term is ~2^-22 relative. An
// operand that is exact in TF32 (a widened bf16, 8 mantissa bits, or an
// int8) has lo = 0, and its product with a split operand takes two terms;
// two exact operands take one. Three products cost 3x the operations at
// 7.4x the CUDA cores' f32 rate (495 against 67 TFLOP/s on an H100 SXM).
//
// Non-finite values. split() passes them through: hi = 0 and lo = a, so
// that an inf meets only the other operand's hi, which has that operand's
// sign and is zero only where the operand is; w·inf = ±inf and 0·inf = NaN
// as in IEEE f32 (an inf hi beside a lo of 0, or of the other sign, would
// have given NaN). Only inf·inf in one product gives NaN where IEEE gives
// ±inf. A finite value whose rounding would carry into the all-ones
// exponent (within half a TF32 ulp of FLT_MAX) is truncated instead, so it
// stays finite. split_fast() is the same split for the values that need
// none of this, in three operations against split()'s seven; for the
// others its lo is NaN, or its hi inf and its lo -inf, so every product
// that meets such a value comes out inf or NaN, never silently finite.
// The kernels run on split_fast() and take a tile whose result holds an
// inf or a NaN again with split(): the IEEE result at no cost to finite
// data.
//
// The product is one warp-wide mma.sync.m16n8k8 (row-major A, "col" B,
// f32 accumulators). Fragments, with g = lane / 4 and t = lane % 4:
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8]:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <stdint.h>

namespace tf32x3 {

// 0x7f7ff000, the least magnitude whose rounding to TF32 carries into the
// all-ones exponent
constexpr float kRoundMax = 0x1.ffep+127f;

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, on
// the magnitude), taken with integer operations on the f32 bits: add half
// a TF32 ulp (bit 12), and the carry rounds the 10 kept mantissa bits up
// exactly when the 13 dropped bits are at least half an ulp; the low 13
// bits are cleared. (The conversion instruction itself issues at a
// fraction of the integer pipes' rate.) A magnitude of kRoundMax or more,
// or a NaN, is truncated instead.
__device__ __forceinline__ uint32_t to_tf32(float a) {
  const uint32_t u = __float_as_uint(a);
  return (fabsf(a) < kRoundMax ? u + 0x1000u : u) & 0xffffe000u;
}

// a = hi + lo (+ < 2^-21 |a|), for any a: see the head of this file
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t u = __float_as_uint(a);
  const bool finite = fabsf(a) <= 0x1.fffffep+127f;  // FLT_MAX; NaN: false
  const uint32_t h = to_tf32(a);
  hi = finite ? h : 0u;
  lo = finite ? __float_as_uint(a - __uint_as_float(h)) : u;
}

// split() for |a| < kRoundMax; any other a gives a NaN lo (an inf or NaN
// a: inf - inf, or NaN) or an inf hi with a -inf lo (the rounding carried)
__device__ __forceinline__ void split_fast(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// split() when kFull, else split_fast()
template <bool kFull>
__device__ __forceinline__ void split_as(float a, uint32_t& hi, uint32_t& lo) {
  if constexpr (kFull) split(a, hi, lo);
  else split_fast(a, hi, lo);
}

// whether a result holds no inf or NaN (the fast split's results are then
// split()'s)
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= 0x1.fffffep+127f; }

// An operand exact in TF32 (a widened bf16 or int8) is one TF32 value, hi;
// its second slot, read by its cross term with the other operand's lo
// (mma_split), holds its finite part on the full split: hi where finite,
// 0 where not, so that a non-finite exact value meets only the other
// operand's hi. On the fast path both slots hold hi: a non-finite value
// then gives NaN, and the tile is taken again with exact().
__device__ __forceinline__ void exact(uint32_t bits, uint32_t& hi, uint32_t& fin) {
  hi = bits;
  fin = (bits & 0x7f800000u) == 0x7f800000u ? 0u : bits;
}

// a widened bf16 (its raw 16 bits) as TF32 bits: exact
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
// it. An operand exact in TF32 (kExactA / kExactB) has no lo term: its
// products take two terms, or one when both are exact. Its lo slot holds
// its finite part (exact()), which the cross term with the other
// operand's lo reads in place of hi.
template <int N, bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_split(float (&c)[N][4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[N][2],
                                          const uint32_t (&b_lo)[N][2]) {
  if constexpr (!kExactA) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[n], a_lo, kExactB ? b_lo[n] : b_hi[n]);
  }
  if constexpr (!kExactB) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[n], kExactA ? a_lo : a_hi, b_lo[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], a_hi, b_hi[n]);
}

}  // namespace tf32x3
