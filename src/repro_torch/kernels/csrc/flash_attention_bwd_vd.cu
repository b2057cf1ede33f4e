// flash_attention_bwd_vd — the backward of flash_attention.cu where v's
// head_dim vd differs from q's and k's hd (DeepSeek-V2's MLA: q/k 192 =
// 128 nope + 64 rope, v 128), hand-written for Hopper (sm_90a).
//
// Given the forward's q [B, Hq, Sq, hd], k [B, Hkv, T, hd], v [B, Hkv, T,
// vd], its output o [B, Hq, Sq, vd], the row log-sum-exp lse [B, Hq, Sq]
// (f32, in units of the scaled scores, written by flash_fwd_kernel_wgmma
// when a gradient is needed) and dO like o, it writes dq like q, dk like k
// and dv like v:
//
//   P = exp(scale·Q·Kᵀ - lse) on the visible keys (0 elsewhere),
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP - delta),  delta = rowsum(dO ∘ O),
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q,
//
// summed over the G query heads of each kv head (GQA; MLA has G = 1). The
// visible keys are the forward's: j <= i, and, when window > 0, i - j <
// window or j < num_meta. Every operand is read through its (batch, head,
// row) strides; the head_dim stride is 1. scale is hd^-1/2.
//
// Replaces: no Pallas kernel. The JAX package computes MLA's prefill
// attention in jnp (src/repro/models/mla.py:104 attention_core) and its
// gradient by autodiff; this kernel gives that gradient, with inf and NaN
// where the autodiff (and the port's plain version under autograd) does.
// flash_attention_bwd.cu takes vd = hd <= 128 and is not changed.
//
// What bounds it on the card: operations. The function's five products
// take 2·(3·hd + 2·vd) flops per visible (query, key) pair and query head
// (S and dK, dQ over hd; dP and dV over vd): 1,664 at (192, 128), 4.5e11
// flops at DeepSeek-V2's training shape (128 heads, 2048 positions), 2.7
// ms at the split-f32 rate against 0.4 ms for its 1.3 GB of operands.
//
// What the design does about it: a simple kernel that is right, on the
// split-f32 mma.sync.m16n8k8 of flash_attention_bwd.cu (tf32x3.cuh), the
// FlashAttention-2 two passes. Its constraint is the register file: a
// 64-key tile's dK (64 x 192) and dV (64 x 128) accumulators are 80 KB
// of f32, and four warps hold 64 KB of registers in all. So the columns
// of the accumulated gradients are split over blocks, each recomputing
// the scores S = Q·Kᵀ over all of hd and dP = dO·Vᵀ over all of vd:
// 1. flash_bwd_vd_prep_kernel, one block per (64-row tile, head, b):
//    delta = rowsum(dO ∘ O) over vd, one warp per row, and per tile a
//    bitmask of the columns where q (over hd), dO (over vd; every column
//    for a tile with a NaN softmax row) or k (kv heads, over hd) hold an
//    inf or NaN: kW = 8 words, 256 columns.
// 2. flash_bwd_vd_dkdv_kernel<T, HD, VD>, one block of 4 warps per
//    (64-key tile, query head, b, 64-column slice of hd): K and V staged
//    once, the 64-row tiles of Q and dO that see a key of the tile staged
//    one at a time with cp.async (Q, K, V and dO of a 64-row tile are 168
//    KB at (192, 128) in f32: no room for a second buffer), Sᵀ = K·Qᵀ and
//    dPᵀ = V·dOᵀ with keys as the M dimension, then dK[:, slice] += dSᵀ·Q
//    and, where the slice lies inside vd, dV[:, slice] += Pᵀ·dO, both on
//    the fragments flash_attention_bwd.cu uses (the C fragments of Sᵀ and
//    dPᵀ are the A fragments of the second products). At G = 1 the block
//    writes dK and dV in the operands' dtype; at G > 1 an f32 partial per
//    query head, which
// 3. flash_bwd_vd_reduce_kernel sums over the group in head order.
// 4. flash_bwd_vd_dq_kernel<T, HD, VD>, one block per (64-row query tile,
//    query head, b, slice of hd: 96 columns at hd 192, else 64): Q and dO
//    staged once, the visible K and V tiles one at a time, S and dP, then
//    dQ[:, slice] += dS·K.
// Products at (192, 128): the dK/dV pass 3 x (S, dP) + dK + dV, the dQ
// pass 2 x (S, dP) + dQ: 4,224 flops a pair, 2.5x the function's 1,664
// (6.9 ms at the split-f32 rate at DeepSeek-V2's training shape).
// Accumulators a thread: 64 (dK and dV slices) or 48 (dQ), beside S and
// dP's 64, so that nothing spills.
// Shared tiles are row-major with pitches of width + 4 (f32) and + 8
// (bf16) halves, so that both fragment patterns fall on distinct banks.
// The products run on the fast split; a block whose result holds an inf or
// NaN runs again on the full split (out of line), as in
// flash_attention_bwd.cu. No atomics: the same bits every run.
//
// Non-finite values as the autodiff gives them, by the rules of
// flash_attention_bwd.cu: P is NaN at every key of a row whose softmax is
// NaN (lse NaN); delta is NaN for a row of dO with an inf or NaN; dS is
// exactly 0 at masked pairs, so 0 · inf gives NaN inside the visited
// tiles; the tiles a pass skips hold only masked pairs, and their masks
// (q for dK, dO for dV, k for dQ) are ORed and written as NaN into those
// columns. Shapes: hd <= 192 and vd <= 128, in two instantiations of
// (HD, VD): (32, 32) (the reduced config's (24, 16)) and (192, 128), the
// columns past hd and vd zero (each instantiation adds minutes to the
// build); the wrapper raises for others. hd = vd = 256 does not fit: Q,
// K, V and dO of a 64-row tile would be 266 KB in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kT = 64;          // rows of a query or key tile
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kReduceThreads = 256;
constexpr int kW = 8;           // mask words a tile: 256 columns
// k8 steps of the score products unrolled at a time (of 1, 2 and 4, 2
// ran fastest at (192, 128) in f32)
constexpr int kDepthUnroll = 2;

// element strides of one [B, H, S, d] operand (the d stride is 1)
struct Strides {
  long long b, h, s;
};

// shared row pitch in elements: width + 4 words (f32) / + 8 halves (bf16)
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / (int)sizeof(T);
}

// columns of dK and dV a dK/dV block accumulates, and of dQ a dQ block
template <int HD>
__host__ __device__ constexpr int kv_cols() {
  return HD < 64 ? HD : 64;
}
template <int HD>
__host__ __device__ constexpr int q_cols() {
  return HD % 96 == 0 ? 96 : HD < 64 ? HD : 64;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ bool visible(int i, int j, int n_q, int n_k, int window,
                                        int num_meta) {
  return i < n_q && j < n_k && j <= i && (window <= 0 || i - j < window || j < num_meta);
}

// element idx of a shared tile as a TF32 hi/lo pair: f32 split (kFull:
// tf32x3::split, else split_fast); a bf16 is exact, its value in both
// slots on the fast path and its finite part in lo's on the full one
template <bool kFull>
__device__ __forceinline__ void frag(const float* s, int idx, uint32_t& hi, uint32_t& lo) {
  tf32x3::split_as<kFull>(s[idx], hi, lo);
}
template <bool kFull>
__device__ __forceinline__ void frag(const __nv_bfloat16* s, int idx, uint32_t& hi,
                                     uint32_t& lo) {
  const uint32_t bits = tf32x3::bf16_bits(reinterpret_cast<const uint16_t*>(s)[idx]);
  if constexpr (kFull) tf32x3::exact(bits, hi, lo);
  else hi = lo = bits;
}

// stage rows row0 .. row0 + 63 (of n) of one head, D columns (cols of
// them read, the rest zero)
template <typename T, int D>
__device__ __forceinline__ void copy_tile(T* dst, const T* base, long long stride, int row0,
                                          int n, int cols) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
  constexpr int PT = pitch<T, D>();
  static_assert(kT * CPR % kThreads == 0, "whole chunks a thread");
  // not unrolled: unrolled, the loop's addresses do not depend on the
  // tile and ptxas hoists them all out of the walk over tiles (24 + 16
  // chunks a thread at (192, 128), each an address, an offset and a
  // predicate), which spilled
#pragma unroll 1
  for (int i = 0; i < kT * CPR / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / CPR, col = (e % CPR) * EPC;
    const int row = row0 + r;
    int nbytes = 0;
    const T* src = base;
    if (row < n && col < cols) {
      src = base + row * stride + col;
      nbytes = min(EPC, cols - col) * (int)sizeof(T);
    }
    cp_async::chunk16(dst + r * PT + col, src, nbytes);
  }
}

// A fragment (16 rows from r0, k8 step ks) of a row-major [row][d] tile
template <bool kFull, typename T, int PT>
__device__ __forceinline__ void load_a(const T* s, int r0, int ks, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int base = (r0 + g) * PT + ks * 8 + t;
  frag<kFull>(s, base, hi[0], lo[0]);
  frag<kFull>(s, base + 8 * PT, hi[1], lo[1]);
  frag<kFull>(s, base + 4, hi[2], lo[2]);
  frag<kFull>(s, base + 8 * PT + 4, hi[3], lo[3]);
}

// acc[j] (16 rows x 8 columns j) += A·Bᵀ over D, A the 16 rows from r0 of
// tile `a`, B the 64 rows of tile `bm` (both [row][d], pitch of D):
// S = Q·Kᵀ, Sᵀ = K·Qᵀ over hd; dP = dO·Vᵀ, dPᵀ = V·dOᵀ over vd
template <bool kFull, bool kExact, typename T, int D>
__device__ __forceinline__ void product_abt(float (&acc)[8][4], const T* a, int r0,
                                            const T* bm, int g, int t) {
  constexpr int PT = pitch<T, D>();
#pragma unroll kDepthUnroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4];
    load_a<kFull, T, PT>(a, r0, ks, g, t, ah, al);
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = (j * 8 + g) * PT + ks * 8 + t;
      frag<kFull>(bm, idx, bh[j][0], bl[j][0]);
      frag<kFull>(bm, idx + 4, bh[j][1], bl[j][1]);
    }
    tf32x3::mma_split<8, kExact, kExact>(acc, ah, al, bh, bl);
  }
}

// acc[n] (16 rows x NC columns) += M·B over the tile's 64 rows, M the
// 16 x 64 matrix whose C fragments the caller holds (m[j]: columns
// 8j + 2t, + 1 of rows g, g + 8), B the NC columns from `bm` of a
// row-major tile of pitch PT read as the "col" operand (b0 = B[8kk +
// 2t][8n + g]): A's columns t and t + 4 stand for rows 2t and 2t + 1, so
// M's C fragment is its A fragment. dV += Pᵀ·dO, dK += dSᵀ·Q, dQ += dS·K
// on a slice of their columns. The n8 tiles go in groups of NG, to bound
// the registers; each tile's products go into zeroed accumulators that
// are then added to acc (the tensor cores' f32 accumulation truncates:
// flash_attention_bwd.cu).
template <bool kFull, bool kExactB, typename T, int PT, int NC>
__device__ __forceinline__ void product_mb(float (&acc)[NC / 8][4], const float (&m)[8][4],
                                           const T* bm, int g, int t) {
  constexpr int NN = NC / 8;
  constexpr int NG = NN % 8 == 0 ? 8 : NN % 4 == 0 ? 4 : NN;
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      tf32x3::split_as<kFull>(m[kk][0], ah[0], al[0]);
      tf32x3::split_as<kFull>(m[kk][2], ah[1], al[1]);
      tf32x3::split_as<kFull>(m[kk][1], ah[2], al[2]);
      tf32x3::split_as<kFull>(m[kk][3], ah[3], al[3]);
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int idx = (kk * 8 + 2 * t) * PT + (n0 + n) * 8 + g;
        frag<kFull>(bm, idx, bh[n][0], bl[n][0]);
        frag<kFull>(bm, idx + PT, bh[n][1], bl[n][1]);
      }
      tf32x3::mma_split<NG, false, kExactB>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[i][c] = 0.f;
}

template <int N>
__device__ __forceinline__ bool all_finite(const float (&a)[N][4]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) ok &= tf32x3::finite(a[i][c]);
  return ok;
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

// ---------------------------------------------------------------------------
// 2. one column slice of dK and dV of one 64-key tile, from one query head
// ---------------------------------------------------------------------------

template <typename T, int HD, int VD>
constexpr size_t dkdv_smem() {
  return sizeof(T) * (size_t)kT * 2 * (pitch<T, HD>() + pitch<T, VD>()) +
         sizeof(float) * 2 * kT + sizeof(uint32_t) * 2 * kW;
}

// the block's work and its store, on the fast split (kSlow false) or the
// full one; on the fast split a result that holds an inf or NaN is not
// stored: it returns true and the kernel takes the block again
template <typename T, int HD, int VD, bool kSlow>
__device__ __forceinline__ bool dkdv_block(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, const T* __restrict__ dout,
                                           T* __restrict__ dk, T* __restrict__ dv,
                                           const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PH = pitch<T, HD>(), PV = pitch<T, VD>();
  constexpr int C = kv_cols<HD>();
  constexpr int NC = C / 8;
  constexpr int NSL = HD / C;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [kT][PH]
  T* Qs = Ks + kT * PH;                // [kT][PH]
  T* Vs = Qs + kT * PH;                // [kT][PV]
  T* dOs = Vs + kT * PV;               // [kT][PV]
  float* lse_s = reinterpret_cast<float*>(dOs + kT * PV);  // [kT]
  float* del_s = lse_s + kT;                               // [kT]
  uint32_t* fk_s = reinterpret_cast<uint32_t*>(del_s + kT);  // [kW]
  uint32_t* fv_s = fk_s + kW;                                // [kW]

  int idx = blockIdx.x;
  const int sl = idx % NSL;  // fastest: a tile's slices run side by side
  idx /= NSL;
  const int h = idx % a.hq;
  idx /= a.hq;
  const int b = idx % a.batch;
  const int kt = idx / a.batch;  // slowest: the heaviest key tiles launch first
  const int hk = h / a.group;
  const int k0 = kt * kT, c0 = sl * C;
  const bool has_dv = c0 < a.vd;  // the slice lies inside vd (VD is a multiple of C)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (threadIdx.x >> 5) * 16;  // the warp's first key in the tile
  const int n_qt = (a.n_q + kT - 1) / kT;

  const T* qb = q + b * a.sq.b + h * a.sq.h;
  const T* db = dout + b * a.sdo.b + h * a.sdo.h;
  const long long row_base = ((long long)b * a.hq + h) * a.n_q;

  // the query tiles that see a key of this tile: from the diagonal on; with
  // a window and no meta token in the tile, those within window - 1 rows of
  // its last key
  const int qt_first = kt;
  int qt_last = n_qt - 1;
  if (a.window > 0 && k0 >= a.num_meta)
    qt_last = min(qt_last, (k0 + kT - 1 + a.window - 1) / kT);

  copy_tile<T, HD>(Ks, k + b * a.sk.b + hk * a.sk.h, a.sk.s, k0, a.n_k, a.hd);
  copy_tile<T, VD>(Vs, v + b * a.sv.b + hk * a.sv.h, a.sv.s, k0, a.n_k, a.vd);
  cp_async::commit();

  float acc_dk[NC][4], acc_dv[NC][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int qt = qt_first; qt <= qt_last; ++qt) {
    const int q0 = qt * kT;
    copy_tile<T, HD>(Qs, qb, a.sq.s, q0, a.n_q, a.hd);
    copy_tile<T, VD>(dOs, db, a.sdo.s, q0, a.n_q, a.vd);
    if (threadIdx.x < kT) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < a.n_q ? a.lse[row_base + i] : 0.f;
      del_s[threadIdx.x] = i < a.n_q ? a.delta[row_base + i] : 0.f;
    }
    cp_async::commit();
    cp_async::wait<0>();
    __syncthreads();  // tile qt staged

    // Sᵀ = K·Qᵀ over hd and dPᵀ = V·dOᵀ over vd: the warp's 16 keys x 64
    // queries
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product_abt<kSlow, kBf16, T, HD>(s, Ks, kr, Qs, g, t);
    product_abt<kSlow, kBf16, T, VD>(dp, Vs, kr, dOs, g, t);
    // Pᵀ and dSᵀ in place: keys kr + g (c = 0, 1) and + 8 (c = 2, 3),
    // queries 8j + 2t (+ 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + kr + g + (c >> 1) * 8;
        const int ql = j * 8 + 2 * t + (c & 1);
        const bool vis = visible(q0 + ql, key, a.n_q, a.n_k, a.window, a.num_meta);
        const float lq = lse_s[ql];
        // P is NaN at every key, masked ones included, in a row whose
        // softmax is NaN (lse NaN); dS is exactly 0 at masked pairs
        const float p = vis ? expf(s[j][c] * a.scale - lq) : lq != lq ? lq : 0.f;
        s[j][c] = p;
        dp[j][c] = vis ? p * (dp[j][c] - del_s[ql]) : 0.f;
      }
    // dV[:, slice] += Pᵀ·dO, dK[:, slice] += dSᵀ·Q
    if (has_dv) product_mb<kSlow, kBf16, T, PV, C>(acc_dv, s, dOs + c0, g, t);
    product_mb<kSlow, kBf16, T, PH, C>(acc_dk, dp, Qs + c0, g, t);
    __syncthreads();  // every warp is done with Qs and dOs
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    const bool bad = !all_finite(acc_dk) || (has_dv && !all_finite(acc_dv));
    if (__syncthreads_or(bad)) return true;  // every warp is done with the tiles
  }

  // the query tiles skipped (every pair masked): 0 · inf where q (for dK)
  // or dO (for dV) holds an inf or NaN
  if (threadIdx.x < kW) {
    uint32_t mk = 0u, mv = 0u;
    const long long ftile = ((long long)b * a.hq + h) * n_qt;
    for (int qt = 0; qt < n_qt; ++qt) {
      if (qt >= qt_first && qt <= qt_last) continue;
      mk |= a.qflags[(ftile + qt) * kW + threadIdx.x];
      mv |= a.dflags[(ftile + qt) * kW + threadIdx.x];
    }
    fk_s[threadIdx.x] = mk;
    fv_s[threadIdx.x] = mv;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    if (key >= a.n_k) continue;
    T* dkr = dk + b * a.sdk.b + hk * a.sdk.h + (long long)key * a.sdk.s;
    T* dvr = dv + b * a.sdv.b + hk * a.sdv.h + (long long)key * a.sdv.s;
    float* dkb = a.dkp + (((long long)b * a.hq + h) * a.n_k + key) * HD;
    float* dvb = a.dvp + (((long long)b * a.hq + h) * a.n_k + key) * VD;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = c0 + n * 8 + 2 * t;
      float2 vk = make_float2(acc_dk[n][2 * r] * a.scale, acc_dk[n][2 * r + 1] * a.scale);
      float2 vv = make_float2(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      if (flagged(fk_s, d)) vk.x = nan_f32();
      if (flagged(fk_s, d + 1)) vk.y = nan_f32();
      if (flagged(fv_s, d)) vv.x = nan_f32();
      if (flagged(fv_s, d + 1)) vv.y = nan_f32();
      if (a.group == 1) {
        if (d < a.hd) store(dkr + d, vk.x);
        if (d + 1 < a.hd) store(dkr + d + 1, vk.y);
        if (has_dv && d < a.vd) store(dvr + d, vv.x);
        if (has_dv && d + 1 < a.vd) store(dvr + d + 1, vv.y);
      } else {
        *reinterpret_cast<float2*>(dkb + d) = vk;
        if (has_dv) *reinterpret_cast<float2*>(dvb + d) = vv;
      }
    }
  }
  return false;
}

template <typename T, int HD, int VD>
__device__ __noinline__ void dkdv_block_full(const T* q, const T* k, const T* v, const T* dout,
                                             T* dk, T* dv, const Args& a) {
  dkdv_block<T, HD, VD, true>(q, k, v, dout, dk, dv, a);
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_vd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dk,
                         T* __restrict__ dv, const __grid_constant__ Args a) {
  if (dkdv_block<T, HD, VD, false>(q, k, v, dout, dk, dv, a))
    dkdv_block_full<T, HD, VD>(q, k, v, dout, dk, dv, a);
}

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

// ---------------------------------------------------------------------------
// 4. one column slice of dQ of one 64-row query tile of query head h
// ---------------------------------------------------------------------------

template <typename T, int HD, int VD>
constexpr size_t dq_smem() {
  return sizeof(T) * (size_t)kT * 2 * (pitch<T, HD>() + pitch<T, VD>()) +
         sizeof(uint32_t) * kW;
}

template <typename T, int HD, int VD, bool kSlow>
__device__ __forceinline__ bool dq_block(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         T* __restrict__ dq, const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PH = pitch<T, HD>(), PV = pitch<T, VD>();
  constexpr int C = q_cols<HD>();
  constexpr int NC = C / 8;
  constexpr int NSL = HD / C;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [kT][PH]
  T* Ks = Qs + kT * PH;                // [kT][PH]
  T* dOs = Ks + kT * PH;               // [kT][PV]
  T* Vs = dOs + kT * PV;               // [kT][PV]
  uint32_t* fq_s = reinterpret_cast<uint32_t*>(Vs + kT * PV);  // [kW]

  const int n_qt = (a.n_q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int sl = idx % NSL;
  idx /= NSL;
  const int h = idx % a.hq;
  idx /= a.hq;
  const int b = idx % a.batch;
  const int qt = n_qt - 1 - idx / a.batch;  // most keys first
  const int hk = h / a.group;
  const int q0 = qt * kT, c0 = sl * C;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile

  const T* kb = k + b * a.sk.b + hk * a.sk.h;
  const T* vb = v + b * a.sv.b + hk * a.sv.h;
  const long long row_base = ((long long)b * a.hq + h) * a.n_q;

  const int q_last = min(q0 + kT, a.n_q) - 1;
  const int kt_last = min((a.n_k - 1) / kT, q_last / kT);
  // the forward's walk: key tiles up to the diagonal, skipping those wholly
  // outside the window that hold no meta token
  auto skipped = [&](int kt) {
    const int k0 = kt * kT;
    return kt > kt_last ||
           (a.window > 0 && k0 >= a.num_meta && q0 - (k0 + kT - 1) >= a.window);
  };

  copy_tile<T, HD>(Qs, q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.n_q, a.hd);
  copy_tile<T, VD>(dOs, dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, a.n_q, a.vd);
  cp_async::commit();

  // this lane's rows: qr + g and qr + g + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr + g + 8 * r;
    lse_r[r] = i < a.n_q ? a.lse[row_base + i] : 0.f;
    del_r[r] = i < a.n_q ? a.delta[row_base + i] : 0.f;
  }

  float acc[NC][4];
  zero(acc);
  for (int kt = 0; kt <= kt_last; ++kt) {
    if (skipped(kt)) continue;
    const int k0 = kt * kT;
    copy_tile<T, HD>(Ks, kb, a.sk.s, k0, a.n_k, a.hd);
    copy_tile<T, VD>(Vs, vb, a.sv.s, k0, a.n_k, a.vd);
    cp_async::commit();
    cp_async::wait<0>();
    __syncthreads();  // tile kt staged

    // S = Q·Kᵀ over hd and dP = dO·Vᵀ over vd: the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product_abt<kSlow, kBf16, T, HD>(s, Qs, qr, Ks, g, t);
    product_abt<kSlow, kBf16, T, VD>(dp, dOs, qr, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + qr + g + (c >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (c & 1);
        const bool vis = visible(i, key, a.n_q, a.n_k, a.window, a.num_meta);
        const float p = vis ? expf(s[j][c] * a.scale - lse_r[c >> 1]) : 0.f;
        s[j][c] = vis ? p * (dp[j][c] - del_r[c >> 1]) : 0.f;  // dS
      }
    // dQ[:, slice] += dS·K
    product_mb<kSlow, kBf16, T, PH, C>(acc, s, Ks + c0, g, t);
    __syncthreads();  // every warp is done with Ks and Vs
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    if (__syncthreads_or(!all_finite(acc))) return true;
  }

  // the key tiles skipped (every pair masked): 0 · inf where k holds an inf
  // or NaN
  const int n_kt = (a.n_k + kT - 1) / kT;
  if (threadIdx.x < kW) {
    uint32_t m = 0u;
    const long long ftile = ((long long)b * (a.hq / a.group) + hk) * n_kt;
    for (int j = 0; j < n_kt; ++j)
      if (skipped(j)) m |= a.kflags[(ftile + j) * kW + threadIdx.x];
    fq_s[threadIdx.x] = m;
  }
  __syncthreads();
  T* dqb = dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr + g + 8 * r;
    if (i >= a.n_q) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = c0 + n * 8 + 2 * t;
      if (d < a.hd)
        store(dqb + (long long)i * a.sdq.s + d,
              flagged(fq_s, d) ? nan_f32() : acc[n][2 * r] * a.scale);
      if (d + 1 < a.hd)
        store(dqb + (long long)i * a.sdq.s + d + 1,
              flagged(fq_s, d + 1) ? nan_f32() : acc[n][2 * r + 1] * a.scale);
    }
  }
  return false;
}

template <typename T, int HD, int VD>
__device__ __noinline__ void dq_block_full(const T* q, const T* k, const T* v, const T* dout,
                                           T* dq, const Args& a) {
  dq_block<T, HD, VD, true>(q, k, v, dout, dq, a);
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_vd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dq,
                       const __grid_constant__ Args a) {
  if (dq_block<T, HD, VD, false>(q, k, v, dout, dq, a)) dq_block_full<T, HD, VD>(q, k, v, dout, dq, a);
}

template <typename T, int HD, int VD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, Args a, uint32_t* qflags,
                   uint32_t* dflags, uint32_t* kflags, float* delta, cudaStream_t stream) {
  static_assert(VD <= HD && VD % kv_cols<HD>() == 0, "dV's slices are dK's first ones");
  const size_t b1 = dkdv_smem<T, HD, VD>(), b2 = dq_smem<T, HD, VD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_vd_dkdv_kernel<T, HD, VD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_vd_dq_kernel<T, HD, VD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.n_q + kT - 1) / kT, n_kt = (a.n_k + kT - 1) / kT;
  const int hkv = a.hq / a.group;
  flash_bwd_vd_prep_kernel<T><<<dim3(n_qt > n_kt ? n_qt : n_kt, a.hq + hkv, a.batch), kThreads,
                                0, stream>>>((const T*)q, (const T*)k, (const T*)o,
                                             (const T*)dout, a, delta, qflags, dflags, kflags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_vd_dkdv_kernel<T, HD, VD>
      <<<n_kt * a.hq * a.batch * (HD / kv_cols<HD>()), kThreads, b1, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dk, (T*)dv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.group > 1) {
    const long long total = (long long)a.batch * hkv * a.n_k * HD;
    flash_bwd_vd_reduce_kernel<T, HD, VD>
        <<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
           stream>>>((T*)dk, (T*)dv, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  flash_bwd_vd_dq_kernel<T, HD, VD>
      <<<n_qt * a.hq * a.batch * (HD / q_cols<HD>()), kThreads, b2, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, a);
  return cudaGetLastError();
}

// (HD, VD): (32, 32) where hd and vd fit, else (192, 128) (zero-padded
// columns; hd <= 192, vd <= 128)
template <typename T>
cudaError_t launch_dims(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, Args a,
                        uint32_t* qflags, uint32_t* dflags, uint32_t* kflags, float* delta,
                        cudaStream_t stream) {
  if (a.vd > 128 || a.hd > 192) return cudaErrorInvalidValue;  // the wrapper raises before
  auto run = a.hd <= 32 && a.vd <= 32 ? launch<T, 32, 32> : launch<T, 192, 128>;
  return run(q, k, v, o, dout, dq, dk, dv, a, qflags, dflags, kflags, delta, stream);
}

}  // namespace

extern "C" {

// q [batch, hq, n_q, hd], k [batch, hq/group, n_k, hd], v [batch,
// hq/group, n_k, vd], o and dout [batch, hq, n_q, vd], dq like q, dk like
// k, dv like v; each given by its (batch, head, row) element strides, the
// head_dim stride 1; f32 when is_bf16 == 0, else bf16; hd <= 192, vd <=
// 128, n_q <= n_k. lse [batch, hq, n_q] f32 from the forward. Workspaces
// (the wrapper allocates them): delta, batch x hq x n_q floats; at group >
// 1 dkp and dvp, batch x hq x n_k x HD (and VD) floats (HD, VD: the
// instantiation's widths, launch_dims), else unused; qflags and dflags,
// batch x hq x ceil(n_q / 64) x 8 words, kflags batch x hq/group x
// ceil(n_k / 64) x 8. Three or four launches on `stream` (delta and the
// masks, the dK/dV slices, their sum over the group when group > 1, the
// dQ slices); returns the first failure of cudaGetLastError().
int flash_attention_bwd_vd_launch(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, void* dq, void* dk,
                                  void* dv, float* delta, float* dkp, float* dvp, void* qflags,
                                  void* dflags, void* kflags,
                                  const long long* strides,  // 24: q, k, v, o, dout, dq, dk, dv x (b, h, s)
                                  int batch, int hq, int group, int n_q, int n_k, int hd,
                                  int vd, float scale, int window, int num_meta, int is_bf16,
                                  void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  Args a;
  a.sq = st[0];
  a.sk = st[1];
  a.sv = st[2];
  a.so = st[3];
  a.sdo = st[4];
  a.sdq = st[5];
  a.sdk = st[6];
  a.sdv = st[7];
  a.lse = lse;
  a.delta = delta;
  a.qflags = (const uint32_t*)qflags;
  a.dflags = (const uint32_t*)dflags;
  a.kflags = (const uint32_t*)kflags;
  a.dkp = dkp;
  a.dvp = dvp;
  a.batch = batch;
  a.hq = hq;
  a.group = group;
  a.n_q = n_q;
  a.n_k = n_k;
  a.hd = hd;
  a.vd = vd;
  a.window = window;
  a.num_meta = num_meta;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_dims<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, a, (uint32_t*)qflags,
                                           (uint32_t*)dflags, (uint32_t*)kflags, delta, s);
  return (int)launch_dims<float>(q, k, v, o, dout, dq, dk, dv, a, (uint32_t*)qflags,
                                 (uint32_t*)dflags, (uint32_t*)kflags, delta, s);
}

}  // extern "C"
