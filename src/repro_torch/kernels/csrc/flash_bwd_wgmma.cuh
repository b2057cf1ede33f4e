// flash_bwd_wgmma — what the flash backward kernels on Hopper's warpgroup
// products share (flash_attention_bwd_vd.cu at v's own head_dim,
// flash_attention_bwd_256.cu at hd = vd = 256): the 64-row tiles, the
// prep kernel (delta = rowsum(dO ∘ O) and the tiles' masks of non-finite
// columns), a block's key tile and query tiles, and the ordered sum of the
// GQA group's dK and dV partials. See flash_attention_bwd_vd.cu's head for
// the layouts and the non-finite rules.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace wgmma;

constexpr int kT = 64;          // rows of a query or key tile
constexpr int kThreads = 128;   // the prep kernel: 4 warps
constexpr int kReduceThreads = 256;
constexpr int kW = 8;           // mask words a tile: 256 columns

// element strides of one [B, H, S, d] operand (the d stride is 1)
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ bool visible(int i, int j, int n_q, int n_k, int window,
                                        int num_meta) {
  return i < n_q && j < n_k && j <= i && (window <= 0 || i - j < window || j < num_meta);
}

// whether every pair of query tile q0 and key tile k0 is visible
__device__ __forceinline__ bool all_visible(int q0, int k0, int n_q, int n_k, int window,
                                            int num_meta) {
  return k0 + kT - 1 <= q0 && q0 + kT <= n_q && k0 + kT <= n_k &&
         (window <= 0 || q0 + kT - 1 - k0 < window || k0 + kT <= num_meta);
}

// column d of a mask of kW words in shared memory
__device__ __forceinline__ bool flagged(const uint32_t* m, int d) {
  return (m[d >> 5] >> (d & 31)) & 1u;
}

struct Args {
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;
  const float* delta;
  const uint32_t* qflags;  // [B, Hq, n_qt, kW]
  const uint32_t* dflags;  // [B, Hq, n_qt, kW]
  const uint32_t* kflags;  // [B, Hkv, n_kt, kW]
  float* dkp;              // G > 1: [B, Hq, T, HD] f32 partials
  float* dvp;              // G > 1: [B, Hq, T, VD]
  int batch, hq, group, n_q, n_k, hd, vd, window, num_meta;
  float scale;
};

// ---------------------------------------------------------------------------
// 1. delta and the tiles' masks of non-finite columns
// ---------------------------------------------------------------------------

// the columns (< cols <= 256) of a tile's rows that hold an inf or NaN,
// kW words into dst; words: kW words of shared scratch
template <typename T>
__device__ __forceinline__ void tile_mask(uint32_t* dst, const T* base, long long stride,
                                          int rows, int cols, uint32_t* words) {
  __syncthreads();  // words is free
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c0 = 0; c0 < 32 * kW; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    bool bad = false;
    if (c < cols)
      for (int r = 0; r < rows; ++r) bad |= !tf32x3::finite(to_f32(base[r * stride + c]));
    const uint32_t w = __ballot_sync(0xffffffffu, bad);
    if (lane == 0) words[(c0 >> 5) + warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < kW) dst[threadIdx.x] = words[threadIdx.x];
}

// blockIdx.y < hq: query head h, rows of tile blockIdx.x: delta, the masks
// of q and dO. Otherwise kv head blockIdx.y - hq: the mask of k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_vd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ o, const T* __restrict__ dout,
                         const __grid_constant__ Args a, float* __restrict__ delta,
                         uint32_t* __restrict__ qflags, uint32_t* __restrict__ dflags,
                         uint32_t* __restrict__ kflags) {
  __shared__ uint32_t words[kW];
  const int tile = blockIdx.x, b = blockIdx.z;
  const int r0 = tile * kT;
  if (blockIdx.y >= a.hq) {
    const int hk = blockIdx.y - a.hq, hkv = gridDim.y - a.hq, n_kt = (a.n_k + kT - 1) / kT;
    if (r0 >= a.n_k) return;
    tile_mask(kflags + (((long long)b * hkv + hk) * n_kt + tile) * kW,
              k + b * a.sk.b + hk * a.sk.h + (long long)r0 * a.sk.s, a.sk.s,
              min(kT, a.n_k - r0), a.hd, words);
    return;
  }
  const int h = blockIdx.y, n_qt = (a.n_q + kT - 1) / kT;
  if (r0 >= a.n_q) return;
  const int rows = min(kT, a.n_q - r0);
  const T* qb = q + b * a.sq.b + h * a.sq.h + (long long)r0 * a.sq.s;
  const T* ob = o + b * a.so.b + h * a.so.h + (long long)r0 * a.so.s;
  const T* db = dout + b * a.sdo.b + h * a.sdo.h + (long long)r0 * a.sdo.s;
  const long long tix = (((long long)b * a.hq + h) * n_qt + tile) * kW;
  tile_mask(qflags + tix, qb, a.sq.s, rows, a.hd, words);
  tile_mask(dflags + tix, db, a.sdo.s, rows, a.vd, words);
  // a row whose softmax is NaN (lse NaN) has P = NaN at the keys the dK/dV
  // pass skips too: all of dV's columns, as a non-finite dO row gives
  const float* lr = a.lse + ((long long)b * a.hq + h) * a.n_q + r0;
  if (__syncthreads_or(threadIdx.x < rows && lr[threadIdx.x] != lr[threadIdx.x]) &&
      threadIdx.x < kW)
    dflags[tix + threadIdx.x] = ~0u;
  // delta: a warp per row over vd; NaN where the row of dO holds an inf or
  // NaN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s = 0.f;
    bool bad = false;
    for (int d = lane; d < a.vd; d += 32) {
      const float dv = to_f32(db[r * a.sdo.s + d]);
      bad |= !tf32x3::finite(dv);
      s += to_f32(ob[r * a.so.s + d]) * dv;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) delta[((long long)b * a.hq + h) * a.n_q + r0 + r] = bad ? nan_f32() : s;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

template <int N>
__device__ __forceinline__ bool all_finite(const float (&a)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) ok &= tf32x3::finite(a[i]);
  return ok;
}

// The block's key tile and query head, and the query tiles that see a key
// of the tile: from the diagonal on; with a window and no meta token in the
// tile, those within window - 1 rows of its last key
struct KVTile {
  int h, b, hk, k0, n_qt, qt_first, qt_last, ntiles;
  __device__ __forceinline__ explicit KVTile(const Args& a) {
    int idx = blockIdx.x;
    h = idx % a.hq;
    idx /= a.hq;
    b = idx % a.batch;
    const int kt = idx / a.batch;  // slowest: the heaviest key tiles launch first
    hk = h / a.group;
    k0 = kt * kT;
    n_qt = (a.n_q + kT - 1) / kT;
    qt_first = kt;
    qt_last = n_qt - 1;
    if (a.window > 0 && k0 >= a.num_meta)
      qt_last = min(qt_last, (k0 + kT - 1 + a.window - 1) / kT);
    ntiles = max(0, qt_last - qt_first + 1);
  }
};

// ---------------------------------------------------------------------------
// 3. G > 1: dK, dV as the sum of the G partials of each kv head, in head
//    order
// ---------------------------------------------------------------------------

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_vd_reduce_kernel(T* __restrict__ dk, T* __restrict__ dv,
                           const __grid_constant__ Args a) {
  const long long idx = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const int hkv = a.hq / a.group;
  const long long total = (long long)a.batch * hkv * a.n_k * HD;
  if (idx >= total) return;
  const int d = (int)(idx % HD);
  long long rest = idx / HD;
  const int j = (int)(rest % a.n_k);
  rest /= a.n_k;
  const int hk = (int)(rest % hkv);
  const int b = (int)(rest / hkv);
  float sk = 0.f, sv = 0.f;
  for (int hh = 0; hh < a.group; ++hh) {
    const long long row = ((long long)b * a.hq + hk * a.group + hh) * a.n_k + j;
    sk += a.dkp[row * HD + d];
    if (d < VD) sv += a.dvp[row * VD + d];
  }
  if (d < a.hd) store(dk + b * a.sdk.b + hk * a.sdk.h + (long long)j * a.sdk.s + d, sk);
  if (d < a.vd) store(dv + b * a.sdv.b + hk * a.sdv.h + (long long)j * a.sdv.s + d, sv);
}

}  // namespace
