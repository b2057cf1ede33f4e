// wgmma — the pieces of Hopper's warpgroup products (sm_90a) that the
// split-f32 attention kernels share: the 128-byte-swizzled K-major tiles
// tf32 wgmma reads from shared memory and their descriptors, the mbarrier
// ring between a producer warpgroup and its consumers, the tf32 products
// (m64n64k8 and m64n128k8, A from shared memory or from registers), the
// producer's loads of raw operand bits and their split into TF32 hi and lo
// parts (tf32x3.cuh) as they are stored, a copy engine's bulk copy onto an
// mbarrier, the rings a warpgroup's first thread fills by such copies
// (its own, WgFeed, or one that two warpgroups read, PairFeed), and the 16
// KB stages (an atom of hi parts and one of lo) of 64-row tiles as stored
// or transposed, with their products over an atom.
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
// one arrival on `bar` that also expects `bytes` of transactions: the
// phase completes once the arrivals are in and the copies below have
// landed that many bytes
__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// a copy engine's bulk copy (TMA, no tensor map) of `bytes` (a multiple
// of 16) from global memory at `src` (16-byte aligned) to shared memory at
// `dst`, counted on the mbarrier `bar` as it lands
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// A warpgroup's own ring of R shared-memory slots of `bytes` each from
// `base`, which its first thread fills with bulk copies: slot s's full
// mbarrier (one arrival with the copies' bytes) at bars + 8 s, its empty
// one (one arrival a warp) at bars + 8 (R + s). Stage m of the
// warpgroup's sequence lives in slot m % R; m runs on across a block's
// passes, so the barriers' parities follow from it.
template <int R>
struct WgRing {
  uint32_t base, bars, bytes;
  __device__ __forceinline__ uint32_t slot(uint32_t m) const { return base + (m % R) * bytes; }
  __device__ __forceinline__ uint32_t full(uint32_t m) const { return bars + 8 * (m % R); }
  __device__ __forceinline__ uint32_t empty(uint32_t m) const { return bars + 8 * (R + m % R); }
  // stage m, once it has landed
  __device__ __forceinline__ uint32_t take(uint32_t m) const {
    bar_wait(full(m), (m / R) & 1);
    return slot(m);
  }
  // the first thread: land stage m from one global stage of `part` bytes,
  // or two (the second at the slot's second part), once every warp has
  // freed stage m - R
  __device__ __forceinline__ void land(uint32_t m, const void* a, const void* b,
                                       uint32_t part) const {
    if (m >= (uint32_t)R) bar_wait(empty(m), (m / R - 1) & 1);
    bar_arrive_tx(full(m), b != nullptr ? 2 * part : part);
    bulk_copy(slot(m), a, part, full(m));
    if (b != nullptr) bulk_copy(slot(m) + part, b, part, full(m));
  }
};

// A warpgroup's feed of its ring: `land(m)` (its first thread's) lands
// stage m of the warpgroup's sequence, m0 .. end - 1 in this pass; the
// first R stages at the start, stage m + R as every warp frees stage m
template <int R, class Land>
struct WgFeed {
  const WgRing<R>& r;
  Land& land;
  uint32_t m0, end;
  bool first;  // the warpgroup's first thread
  __device__ __forceinline__ void start() const {
    if (first)
      for (uint32_t m = m0; m < m0 + R && m < end; ++m) land(m);
    __syncwarp();
  }
  // stage m, once it has landed
  __device__ __forceinline__ uint32_t take(uint32_t m) const { return r.take(m); }
  // every warp frees stage m; the first thread then lands stage m + R
  // (once the other warps have freed m too), and its warp reconverges
  // before the next warpgroup instruction
  __device__ __forceinline__ void release(uint32_t m) const {
    warp_arrive(r.empty(m));
    if (first && m + R < end) land(m + R);
    __syncwarp();
  }
};

// whether the barrier's phase of parity `parity` has completed (no wait)
__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The feed of one ring that two warpgroups read in the same order, each
// freeing every stage (its empty mbarrier counts 2 kWarps arrivals): the
// first thread of warpgroup 0 lands stage m .. end - 1 of the pass, from
// m0, in order and lazily, so that neither warpgroup waits for the other
// but where it must: at each free of its own it lands every stage whose
// slot both have freed (a test, no wait), and before it takes stage m it
// lands every stage up to m, waiting for the frees these need. The other
// warpgroup only takes and frees. `next` is the lander's next stage.
template <int R, class Land>
struct PairFeed {
  const WgRing<R>& r;
  Land& land;
  uint32_t next, end;
  bool lander;
  // whether stage next's slot is free: both have freed the stage R before
  __device__ __forceinline__ bool slot_free() const {
    return next < (uint32_t)R || bar_test(r.empty(next), (next / R - 1) & 1);
  }
  __device__ __forceinline__ void start() {
    if (lander)
      while (next < end && slot_free()) land(next++);
    __syncwarp();
  }
  __device__ __forceinline__ uint32_t take(uint32_t m) {
    if (lander)
      while (next <= m && next < end) land(next++);  // WgRing::land waits for the slot
    __syncwarp();
    return r.take(m);
  }
  __device__ __forceinline__ void release(uint32_t m) {
    warp_arrive(r.empty(m));
    if (lander)
      while (next < end && slot_free()) land(next++);
    __syncwarp();
  }
};

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

// ---------------------------------------------------------------------------
// 16 KB stages of 64-row tiles (the flash backward kernels, and the forward
// at hd = vd = 256): an atom of TF32 hi parts and one of lo parts, of the
// rows of an operand as stored or of 32 of them transposed
// ---------------------------------------------------------------------------

constexpr int kStage = 2 * kAtom;

// A stage "as stored": rows row0 .. row0 + 63 of a [n x width] operand,
// columns col0 .. col0 + 31, one atom of hi parts and one of lo. Thread p
// loads the 4-column group p % 8 of rows p / 8 + 16i (i < 4): 128
// contiguous bytes (f32) a row.
template <typename T>
__device__ __forceinline__ void get_rows(uint4 (&x)[4], const T* base, long long stride,
                                         int row0, int n, int col0, int width, bool vec, int p) {
  const int col = col0 + 4 * (p & 7);
  if (vec && row0 + 64 <= n && col0 + 32 <= width) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = ld_raw<T>(base + (long long)(row0 + (p >> 3) + 16 * i) * stride + col);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + (p >> 3) + 16 * i;
      x[i] = ld_raw_masked<T>(row < n ? base + (long long)row * stride : nullptr, col, width);
    }
  }
}

// get_rows' values split into the stage's hi and lo atoms. A bf16 operand
// stored as it is meets only other bf16 operands (S, dP: one product) and
// takes no lo part.
template <typename T, bool kSlow>
__device__ __forceinline__ void put_rows(unsigned char* hi, unsigned char* lo,
                                         const uint4 (&x)[4], int p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = sw128((p >> 3) + 16 * i, 4 * (p & 7));
    const float4 f = widen<T>(x[i]);
    uint4 h, l;
    split_in<T, kSlow>(f.x, h.x, l.x);
    split_in<T, kSlow>(f.y, h.y, l.y);
    split_in<T, kSlow>(f.z, h.z, l.z);
    split_in<T, kSlow>(f.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    if constexpr (sizeof(T) == 4) *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A stage transposed: rows row0 .. row0 + 31 of a [n x width] operand,
// columns col0 .. col0 + 63, stored as [64 columns][32 rows] (K-major over
// the rows). Thread p loads row row0 + p % 32 at columns col0 + 16(p / 32)
// + 4m (m < 4).
template <typename T>
__device__ __forceinline__ void get_cols(uint4 (&x)[4], const T* base, long long stride,
                                         int row0, int n, int col0, int width, bool vec, int p) {
  const int row = row0 + (p & 31), col = col0 + 16 * (p >> 5);
  if (vec && row0 + 32 <= n && col0 + 64 <= width) {
    const T* r = base + (long long)row * stride + col;
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = ld_raw<T>(r + 4 * m);
  } else {
    const T* r = row < n ? base + (long long)row * stride : nullptr;
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = ld_raw_masked<T>(r, col + 4 * m, width);
  }
}

// get_cols' values transposed into the stage's hi and lo atoms. Inside each
// group of 8 rows, position t holds row 2t and position t + 4 row 2t + 1:
// the order in which an m64n64 accumulator hands its columns over as an A
// fragment (split_frags), and in which the dV warpgroup stores dSᵀ. For a
// fixed (m, e) a warp's 32 stores fill one 128-byte row: no bank conflict.
template <typename T, bool kSlow>
__device__ __forceinline__ void put_cols(unsigned char* hi, unsigned char* lo,
                                         const uint4 (&x)[4], int p) {
  const int l = p & 31, w = p >> 5;
  const int pos = (l & ~7) | ((l & 1) ? 4 + ((l & 7) >> 1) : (l & 7) >> 1);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 f = widen<T>(x[m]);
    const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = sw128(16 * w + 4 * m + e, pos);
      uint32_t h, lw;
      split_in<T, kSlow>(v[e], h, lw);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = lw;
    }
  }
}

// an m64n64 accumulator (P or dS), or its half v[4j + c] for 4 of its k8
// steps j, as the hi/lo A fragments of a product over its columns: element
// (row, column 8j + 2t + e) goes to A column t + 4e of k8 step j
template <int N>
__device__ __forceinline__ void split_frags(const float (&v)[N], uint32_t (&hi)[N],
                                            uint32_t (&lo)[N], bool slow) {
  if (slow) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = (i & ~3) | (((i & 1) << 1) | ((i >> 1) & 1));
      tf32x3::split(v[i], hi[a], lo[a]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = (i & ~3) | (((i & 1) << 1) | ((i >> 1) & 1));
      hi[a] = __float_as_uint(v[i]) & kTrunc;
      lo[a] = __float_as_uint(v[i] - __uint_as_float(hi[a]));
    }
  }
}

// d += A·Bᵀ over one atom's 4 k8 steps, both from shared memory: per step
// lo·hi, hi·lo, hi·hi (bf16: hi·hi alone, both operands exact in TF32)
template <bool kBf16>
__device__ __forceinline__ void ss_atom(float (&d)[32], uint64_t a_hi, uint64_t a_lo,
                                        uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t o = 2 * ks;  // 32 bytes
    if constexpr (!kBf16) {
      mma_ss(d, a_lo + o, b_hi + o);
      mma_ss(d, a_hi + o, b_lo + o);
    }
    mma_ss(d, a_hi + o, b_hi + o);
  }
}

// d += A·Bᵀ over one atom's 4 k8 steps, A's fragments j0 .. j0 + 3 from
// registers: per step lo·hi, hi·lo, hi·hi (bf16 B: A's lo with B's lo
// slot, then hi·hi)
template <bool kBf16, int N>
__device__ __forceinline__ void rs_atom(float (&d)[32], const uint32_t (&ah)[N],
                                        const uint32_t (&al)[N], int j0, uint64_t b_hi,
                                        uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = 4 * (j0 + kk);
    const uint64_t o = 2 * kk;
    if constexpr (!kBf16) {
      mma_rs64(d, al[j], al[j + 1], al[j + 2], al[j + 3], b_hi + o);
      mma_rs64(d, ah[j], ah[j + 1], ah[j + 2], ah[j + 3], b_lo + o);
    } else {
      mma_rs64(d, al[j], al[j + 1], al[j + 2], al[j + 3], b_lo + o);
    }
    mma_rs64(d, ah[j], ah[j + 1], ah[j + 2], ah[j + 3], b_hi + o);
  }
}


// Stage s of a 64-row tile's "image" at head width HD (128 or 256; the
// bytes of the HD / 32 16 KB stages that a bulk copy lands as they are;
// 128 threads, thread p), full split: as stored, the tile's columns 32s ..
// 32s + 31; transposed, 32-row half s / (HD / 64) of its 64-column chunk
// s % (HD / 64). Rows past n and columns past width zero.
template <typename T, int HD>
__device__ __forceinline__ void put_image_stage(unsigned char* dst, const T* base,
                                                long long stride, int row0, int n, int width,
                                                int s, bool transposed, int p) {
  constexpr int kChunks = HD / 64;
  uint4 x[4];
  const bool vec = aligned4(base, stride);
  if (transposed) {
    get_cols<T>(x, base, stride, row0 + 32 * (s / kChunks), n, 64 * (s % kChunks), width, vec,
                p);
    put_cols<T, true>(dst, dst + kAtom, x, p);
  } else {
    get_rows<T>(x, base, stride, row0, n, 32 * s, width, vec, p);
    put_rows<T, true>(dst, dst + kAtom, x, p);
  }
}

}  // namespace wgmma
