// wgmma — the pieces of Hopper's warpgroup products (sm_90a) that the
// split-f32 attention kernels share: the 128-byte-swizzled K-major tiles
// tf32 wgmma reads from shared memory and their descriptors, the mbarrier
// ring between a producer warpgroup and its consumers, the tf32 products
// (m64n64k8 and m64n128k8, A from shared memory or from registers), and
// the producer's loads of raw operand bits and their split into TF32 hi
// and lo parts (tf32x3.cuh) as they are stored.
//
// Layout: a tile whose rows are 128 bytes (32 f32 of the reduction
// dimension K) is an "atom": 64 rows x 128 bytes = 8 KB, row r's 16-byte
// chunk c stored at chunk c ^ (r % 8). A K-major operand wider than 32
// columns is a run of atoms, one per 32 columns. tf32 wgmma takes only
// K-major operands from shared memory, so an operand whose reduction runs
// over its rows is stored transposed by the producer.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace wgmma {

constexpr int kAtom = 8192;               // 64 rows x 128 bytes
constexpr int kWarps = 4;                 // a barrier phase: one arrival per warp of a warpgroup
constexpr uint32_t kTrunc = 0xffffe000u;  // the bits of an f32 the tensor cores read

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (r, k) of an atom: row r's 16-byte chunk k / 4
// sits at chunk (k / 4) ^ (r % 8)
__device__ __forceinline__ int sw128(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

// wgmma's shared-memory descriptor of an atom at `addr` (1024-byte
// aligned, or advanced by a k8 step's 32 bytes inside it): 128-byte
// swizzle, 8-row groups 1024 bytes apart (the leading offset is unused).
// Adding 2 to a descriptor advances it by one k8 step.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival for the warp, once all its lanes are here (a barrier counts
// kWarps arrivals: 128 lanes arriving one by one on one word serialize)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}
// until the barrier's phase of parity `parity` has completed; a wait that
// outlasts 2^26 tries (seconds) traps, so that a fault in the ring's
// bookkeeping fails the launch instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}
// the producer's shared-memory stores, made visible to the tensor cores'
// (async proxy) reads before its arrival
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers a product in flight reads or writes: nothing may touch them
// before the wait that precedes this (the compiler sees them redefined here)
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: wait for
// all of them, or arrive without waiting (a producer's side)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// d[64 x 64] += A[64 x 8] · B[64 x 8]ᵀ, TF32 from shared memory (both
// K-major), f32 accumulators in the m16n8 C layout of each warp's 16 rows:
// d[4j + c] is row g + 8(c / 2), column 8j + 2t + c % 2 (g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 8] · B[64 x 8]ᵀ: A from registers (a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows),
// B from shared memory (K-major)
__device__ __forceinline__ void mma_rs64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 8] · B[128 x 8]ᵀ: A from registers as above, B from
// shared memory (K-major)
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// The producer's loads keep the raw bits of 4 elements (a uint4 for f32,
// the low two words for bf16) and widen them only when it stores them, so
// that a stage's loads issue back to back: a conversion right after each
// load would stall the warp on it. A stage takes 16-byte (f32) or 8-byte
// (bf16) loads when all its rows and columns lie inside the operand and
// its rows are aligned (the wrappers take any row stride: `vec`), else
// element by element, zero past the edges.
template <typename T>
__device__ __forceinline__ uint4 ld_raw(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(u.x, u.y, 0u, 0u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 ld_raw_masked(const T* row, int col, int width) {
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  if (row != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (col + i >= width) continue;
      if constexpr (sizeof(T) == 4) b[i] = __float_as_uint(row[col + i]);
      else b[i] = reinterpret_cast<const uint16_t*>(row)[col + i];
    }
  }
  if constexpr (sizeof(T) == 4) return make_uint4(b[0], b[1], b[2], b[3]);
  else return make_uint4(b[0] | (b[1] << 16), b[2] | (b[3] << 16), 0u, 0u);
}
// ld_raw's 4 elements as f32
template <typename T>
__device__ __forceinline__ float4 widen(const uint4& r) {
  if constexpr (sizeof(T) == 4)
    return make_float4(__uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                       __uint_as_float(r.w));
  else
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}
// whether 4-element loads from rows of `base` at multiples of 4 columns are
// aligned
template <typename T>
__device__ __forceinline__ bool aligned4(const T* base, long long stride) {
  return ((uintptr_t)base & (4 * sizeof(T) - 1)) == 0 && (stride & 3) == 0;
}

// one value as its TF32 hi part and its lo slot. f32, fast: hi the value
// truncated to the bits the tensor cores read, lo = x - hi (exact; an inf
// or NaN gives a NaN lo, so that the result is never silently finite);
// full: tf32x3::split. A widened bf16 is exact: hi its bits, the lo slot
// (read by the cross term with an f32 operand's lo) the bits, or its
// finite part on the full split (tf32x3::exact)
template <typename T, bool kSlow>
__device__ __forceinline__ void split_in(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (kSlow) tf32x3::exact(__float_as_uint(x), hi, lo);
    else hi = lo = __float_as_uint(x);
  } else if constexpr (kSlow) {
    tf32x3::split(x, hi, lo);
  } else {
    hi = __float_as_uint(x) & kTrunc;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

}  // namespace wgmma
