// flash_attention_bwd — the backward of flash_attention.cu, hand-written for
// Hopper (sm_90a).
//
// Given the forward's q [B, Hq, Sq, hd], k/v [B, Hkv, T, hd], its output o,
// the row log-sum-exp lse [B, Hq, Sq] (f32, in units of the scaled scores,
// written by the forward when a gradient is needed) and dO like o, it writes
// dq like q and dk, dv like k and v:
//
//   P = exp(scale·Q·Kᵀ - lse) on the visible keys (0 elsewhere),
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP - delta),  delta = rowsum(dO ∘ O),
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q,
//
// summed over the G query heads of each kv head (GQA). The visible keys are
// the forward's: j <= i, and, when window > 0, i - j < window or j <
// num_meta. Every operand is read through its (batch, head, row) strides;
// the head_dim stride is 1.
//
// Replaces: no Pallas kernel. The JAX package computes this gradient in jnp:
// the custom VJP _flash_vjp_bwd (src/repro/models/attention.py:138) at >=
// 4096 query rows, autodiff of _direct_attention (:50) below that. This
// kernel follows the VJP's FlashAttention-2 scheme, and gives inf and NaN
// where the autodiff (and the port's plain version under autograd) does.
//
// What bounds it on the card: operations. Five products of 2·hd flops per
// visible (query, key) pair and query head; this two-pass design takes
// seven (S and dP in each pass), every one split-f32 on the TF32 tensor
// cores (tf32x3.cuh: three TF32 products per f32 product; bf16 operands are
// exact in TF32 and take fewer).
//
// What the design does about it (FlashAttention-2's two passes on
// mma.sync.m16n8k8, as flash_attention.cu runs the forward). Four launches:
// 1. flash_bwd_prep_kernel, one block per (64-row tile, head, b): delta =
//    rowsum(dO ∘ O), one warp per row, and per tile a bitmask over hd of the
//    columns where q, dO (query heads) or k (kv heads) hold an inf or NaN.
// 2. flash_bwd_dkdv_kernel, one block of 4 warps per (64-key tile, query
//    head, b), warp w owning keys 16w..: K and V are staged once; the 64-row
//    tiles of Q and dO that see a key of the tile (from the diagonal on, and
//    with a window only those within it unless the tile holds a meta token)
//    stream through two cp.async buffers, with their rows' lse and delta.
//    Per query tile it computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with keys as the
//    M dimension, so that their C fragments, turned into Pᵀ and dSᵀ in
//    registers, are the A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q: A's
//    columns t and t + 4 stand for queries 2t and 2t + 1, which dO's and Q's
//    B fragments read row-major (b0 = dO[2t][g]), as the forward reads V.
//    dK and dV stay in registers over the walk and go to a per-query-head
//    f32 partial: a block walks one head, so the meta tiles' long walks
//    (every query tile sees them) are split G ways, and the blocks are
//    launched heaviest first (key tiles in ascending order: the meta tiles,
//    then the window's, then the causal tail's shrinking walks).
// 3. flash_bwd_reduce_kernel: dK and dV as the sum of the G partials of
//    each kv head in head order, cast to the operands' dtype. No atomics
//    anywhere: a fixed order, the same bits every run.
// 4. flash_bwd_dq_kernel, one block of 4 warps per (64-row query tile,
//    query head, b), the tiles with the most keys first: Q and dO staged
//    once, the forward's walk over the visible K and V tiles through two
//    cp.async buffers, S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K with K in
//    V's role.
// Shared tiles are row-major with pitches of hd + 4 (f32) and hd + 8 (bf16)
// halves, so that both fragment patterns, (row g, column t) and (row 2t,
// column g), fall on distinct banks. The products run on the fast split; a
// block whose result holds an inf or NaN runs again on the full split,
// whose products follow IEEE (out of line, so that the fast path keeps its
// registers). exp is expf, P uses the forward's log-sum-exp units.
//
// Non-finite values as the autodiff gives them (the plain version's softmax
// backward sums p·dP over every key, masked ones included, and the masked
// scores' gradient is exactly 0):
// - a row whose softmax is NaN (a visible score that is NaN or +inf: the
//   forward then writes lse = NaN) has P = NaN at every key, masked ones
//   included, so its dO reaches every key's dV as NaN;
// - a row whose dO holds an inf or NaN has delta = NaN (the autodiff's
//   Σ_j p·dP meets 0·inf at a masked key; a row that sees every key gets
//   NaN here where the autodiff may give ±inf, if all of V's column has one
//   sign);
// - dS is exactly 0 at masked pairs inside a tile, so 0 · inf gives NaN in
//   dK (from q) and dQ (from k), and P = 0 gives NaN in dV (from dO), as
//   the autodiff's products do;
// - the tiles a pass skips hold only masked pairs: pass 2 ORs the prep's
//   masks of q (for dK) and dO (for dV; all columns for a tile with a NaN
//   softmax row) over the query tiles it skips, and
//   pass 4 those of k (for dQ) over the key tiles it skips, and write NaN
//   into those columns.
// Head dims up to 64 (32 or 64 columns, zero-padded): Hymba's and
// musicgen's 64, the width this design was made for; hd in (64, 256] is
// flash_attention_bwd_256.cu's (at head width 128 or 256). The masks of
// non-finite columns take 4 words a tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps, each 16 rows of a tile
constexpr int kReduceThreads = 256;
constexpr int kT = 64;          // rows of a query or key tile
constexpr int kW = 4;           // mask words a tile: 128 columns

// a 64-row tile's columns holding an inf or NaN, one bit each
template <int W>
struct __align__(16) Mask {
  uint32_t w[W];
};

// element strides of one [B, H, S, hd] operand (the hd stride is 1)
struct Strides {
  long long b, h, s;
};

// shared row pitch in elements: hd + 4 words (f32) / hd + 8 halves (bf16)
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / (int)sizeof(T);
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

// stage rows row0 .. row0 + KT - 1 (of n) of one head, hd columns,
// zero-padded
template <typename T, int HD, int KT = kT>
__device__ __forceinline__ void copy_tile(T* dst, const T* base, long long stride, int row0,
                                          int n, int hd) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;             // chunks per row
  constexpr int PT = pitch<T, HD>();
#pragma unroll
  for (int i = 0; i < KT * CPR / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / CPR, col = (e % CPR) * EPC;
    const int row = row0 + r;
    int nbytes = 0;
    const T* src = base;
    if (row < n && col < hd) {
      src = base + row * stride + col;
      nbytes = min(EPC, hd - col) * (int)sizeof(T);
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

// acc[j] (16 rows x 8 columns j) += A·Bᵀ over HD, A the 16 rows from r0 of
// tile `a`, B the 8·NJ rows of tile `bm` ([row][d], b0 = B[8j + g][d t]):
// S = Q·Kᵀ, Sᵀ = K·Qᵀ, dP = dO·Vᵀ, dPᵀ = V·dOᵀ.
template <bool kFull, bool kExact, typename T, int HD, int NJ>
__device__ __forceinline__ void product_abt(float (&acc)[NJ][4], const T* a, int r0,
                                            const T* bm, int g, int t) {
  constexpr int PT = pitch<T, HD>();
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t ah[4], al[4];
    load_a<kFull, T, PT>(a, r0, ks, g, t, ah, al);
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = (j * 8 + g) * PT + ks * 8 + t;
      frag<kFull>(bm, idx, bh[j][0], bl[j][0]);
      frag<kFull>(bm, idx + 4, bh[j][1], bl[j][1]);
    }
    tf32x3::mma_split<NJ, kExact, kExact>(acc, ah, al, bh, bl);
  }
}

// acc[n] (16 rows x DC columns from c0) += M·B over the tile's 8·NK rows, M
// the 16 x 8·NK matrix whose C fragments the caller holds (m[j]: columns
// 8j + 2t, + 1 of rows g, g + 8), B a row-major [row][d] tile read as the
// "col" operand (b0 = B[8kk + 2t][c0 + 8n + g]): A's columns t and t + 4
// stand for rows 2t and 2t + 1, so M's C fragment is its A fragment. dV += Pᵀ·dO, dK += dSᵀ·Q,
// dQ += dS·K. The n8 tiles go eight at a time, to bound the registers. The
// tile's products go into zeroed accumulators that are then added to acc:
// the tensor cores' f32 accumulation truncates instead of rounding to
// nearest, and summed into one running accumulator over a walk of
// thousands of rows its error exceeded the f32 tolerance (dV of a meta
// key: 2.5e-4). Summed per k8 step instead of per tile, the error stays
// the same and the dK/dV pass takes 0.5 ms longer at Hymba's shape
// (scripts/torch_flash_bwd_error.py).
template <bool kFull, bool kExactB, typename T, int HD, int DC, int NK>
__device__ __forceinline__ void product_mb(float (&acc)[DC / 8][4], const float (&m)[NK][4],
                                           const T* bm, int c0, int g, int t) {
  constexpr int PT = pitch<T, HD>();
  constexpr int NG = DC / 8 < 8 ? DC / 8 : 8;  // n8 tiles per group
#pragma unroll
  for (int n0 = 0; n0 < DC / 8; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      tf32x3::split_as<kFull>(m[kk][0], ah[0], al[0]);
      tf32x3::split_as<kFull>(m[kk][2], ah[1], al[1]);
      tf32x3::split_as<kFull>(m[kk][1], ah[2], al[2]);
      tf32x3::split_as<kFull>(m[kk][3], ah[3], al[3]);
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int idx = (kk * 8 + 2 * t) * PT + c0 + (n0 + n) * 8 + g;
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

// the column mask as a bit test: column d of the 32·W bits (a chain of
// selects, so that the mask stays in registers)
template <int W>
__device__ __forceinline__ bool flagged(const Mask<W>& m, int d) {
  uint32_t w = m.w[0];
#pragma unroll
  for (int i = 1; i < W; ++i)
    if ((d >> 5) == i) w = m.w[i];
  return (w >> (d & 31)) & 1u;
}

template <int W>
__device__ __forceinline__ void or_into(Mask<W>& a, const Mask<W>& b) {
#pragma unroll
  for (int i = 0; i < W; ++i) a.w[i] |= b.w[i];
}

template <int W>
__device__ __forceinline__ Mask<W> no_mask() {
  Mask<W> m;
#pragma unroll
  for (int i = 0; i < W; ++i) m.w[i] = 0u;
  return m;
}

// ---------------------------------------------------------------------------
// 1. delta and the tiles' masks of non-finite columns
// ---------------------------------------------------------------------------

// a tile's columns holding an inf or NaN (thread c owns columns c, c + 128,
// ...), as a mask of W words
template <typename T, int W>
__device__ __forceinline__ Mask<W> tile_mask(const T* base, long long stride, int rows, int hd,
                                             uint32_t* words) {
  __syncthreads();  // words is free
#pragma unroll
  for (int part = 0; part < W / 4; ++part) {
    const int c = threadIdx.x + part * kThreads;
    bool bad = false;
    if (c < hd)
      for (int r = 0; r < rows; ++r) bad |= !tf32x3::finite(to_f32(base[r * stride + c]));
    const uint32_t w = __ballot_sync(0xffffffffu, bad);
    if ((threadIdx.x & 31) == 0) words[part * 4 + (threadIdx.x >> 5)] = w;
  }
  __syncthreads();
  Mask<W> m;
#pragma unroll
  for (int i = 0; i < W; ++i) m.w[i] = words[i];
  return m;
}

// blockIdx.y < hq: query head h, rows of tile blockIdx.x (kT rows): delta,
// the masks of q and dO. Otherwise kv head blockIdx.y - hq: the mask of k.
template <typename T, int kT, int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                      const T* __restrict__ dout, const float* __restrict__ lse, Strides sq,
                      Strides sk, Strides so, Strides sdo, float* __restrict__ delta,
                      Mask<W>* __restrict__ qflags, Mask<W>* __restrict__ dflags,
                      Mask<W>* __restrict__ kflags, int hq, int n_q, int n_k, int hd) {
  __shared__ uint32_t words[W];
  const int tile = blockIdx.x, b = blockIdx.z;
  const int r0 = tile * kT;
  if (blockIdx.y >= hq) {
    const int hk = blockIdx.y - hq, hkv = gridDim.y - hq, n_kt = (n_k + kT - 1) / kT;
    if (r0 >= n_k) return;
    const Mask<W> m = tile_mask<T, W>(k + b * sk.b + hk * sk.h + (long long)r0 * sk.s,
                                      sk.s, min(kT, n_k - r0), hd, words);
    if (threadIdx.x == 0) kflags[((long long)b * hkv + hk) * n_kt + tile] = m;
    return;
  }
  const int h = blockIdx.y, n_qt = (n_q + kT - 1) / kT;
  if (r0 >= n_q) return;
  const int rows = min(kT, n_q - r0);
  const T* qb = q + b * sq.b + h * sq.h + (long long)r0 * sq.s;
  const T* ob = o + b * so.b + h * so.h + (long long)r0 * so.s;
  const T* db = dout + b * sdo.b + h * sdo.h + (long long)r0 * sdo.s;
  const long long tix = ((long long)b * hq + h) * n_qt + tile;
  const Mask<W> mq = tile_mask<T, W>(qb, sq.s, rows, hd, words);
  Mask<W> md = tile_mask<T, W>(db, sdo.s, rows, hd, words);
  // a row whose softmax is NaN (lse NaN) has P = NaN at the keys the dK/dV
  // pass skips too: all of dV's columns, as a non-finite dO row gives
  const float* lr = lse + ((long long)b * hq + h) * n_q + r0;
  if (__syncthreads_or(threadIdx.x < rows && lr[threadIdx.x] != lr[threadIdx.x])) {
#pragma unroll
    for (int i = 0; i < W; ++i) md.w[i] = ~0u;
  }
  if (threadIdx.x == 0) {
    qflags[tix] = mq;
    dflags[tix] = md;
  }
  // delta: a warp per row; NaN where the row of dO holds an inf or NaN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s = 0.f;
    bool bad = false;
    for (int d = lane; d < hd; d += 32) {
      const float dv = to_f32(db[r * sdo.s + d]);
      bad |= !tf32x3::finite(dv);
      s += to_f32(ob[r * so.s + d]) * dv;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) delta[((long long)b * hq + h) * n_q + r0 + r] = bad ? nan_f32() : s;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of one 64-key tile, from one query head
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t dkdv_smem() {
  return sizeof(T) * (size_t)pitch<T, HD>() * kT * 6 + sizeof(float) * 4 * kT;
}

struct Args {
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;
  const float* delta;
  const void* qflags;  // Mask<kW> per tile
  const void* dflags;
  const void* kflags;
  float* dkp;  // [B, Hq, T, HD] f32 partials
  float* dvp;
  int batch, hq, group, n_q, n_k, hd, window, num_meta;
  float scale;
};

// the block's work and its store, on the fast split (kSlow false) or the
// full one; on the fast split a result that holds an inf or NaN is not
// stored: it returns true and the kernel takes the block again
template <typename T, int HD, bool kSlow>
__device__ __forceinline__ bool dkdv_block(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const T* __restrict__ dout, const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PT = pitch<T, HD>();
  constexpr int NJ = kT / 8, DC = HD, NT = DC / 8;
  constexpr int W = kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [kT][PT]
  T* Vs = Ks + kT * PT;                // [kT][PT]
  T* Qs = Vs + kT * PT;                // [2][kT][PT]
  T* dOs = Qs + 2 * kT * PT;           // [2][kT][PT]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kT * PT);  // [2][kT]
  float* del_s = lse_s + 2 * kT;                               // [2][kT]

  int idx = blockIdx.x;
  const int h = idx % a.hq;
  idx /= a.hq;
  const int b = idx % a.batch;
  const int kt = idx / a.batch;  // slowest: the heaviest key tiles launch first
  const int hk = h / a.group;
  const int k0 = kt * kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16;  // the warp's first key in the tile
  const int c0 = 0;          // its first dK/dV column: it owns every one
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

  auto issue = [&](int qt, int buf) {
    copy_tile<T, HD>(Qs + buf * kT * PT, qb, a.sq.s, qt * kT, a.n_q, a.hd);
    copy_tile<T, HD>(dOs + buf * kT * PT, db, a.sdo.s, qt * kT, a.n_q, a.hd);
    if (threadIdx.x < kT) {
      const int i = qt * kT + threadIdx.x;
      lse_s[buf * kT + threadIdx.x] = i < a.n_q ? a.lse[row_base + i] : 0.f;
      del_s[buf * kT + threadIdx.x] = i < a.n_q ? a.delta[row_base + i] : 0.f;
    }
  };

  copy_tile<T, HD>(Ks, k + b * a.sk.b + hk * a.sk.h, a.sk.s, k0, a.n_k, a.hd);
  copy_tile<T, HD>(Vs, v + b * a.sv.b + hk * a.sv.h, a.sv.s, k0, a.n_k, a.hd);
  if (qt_first <= qt_last) issue(qt_first, 0);
  cp_async::commit();

  float acc_dk[NT][4], acc_dv[NT][4];
  zero(acc_dk);
  zero(acc_dv);
  int buf = 0;
  for (int qt = qt_first; qt <= qt_last; ++qt) {
    cp_async::wait<0>();
    __syncthreads();  // tile qt staged in buf; every warp is done with buf ^ 1
    if (qt < qt_last) issue(qt + 1, buf ^ 1);
    cp_async::commit();
    const T* Qt = Qs + buf * kT * PT;
    const T* dOt = dOs + buf * kT * PT;
    const float* lt = lse_s + buf * kT;
    const float* dl = del_s + buf * kT;
    const int q0 = qt * kT;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: the warp's 16 keys x kT queries
    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
    product_abt<kSlow, kBf16, T, HD>(s, Ks, kr, Qt, g, t);
    product_abt<kSlow, kBf16, T, HD>(dp, Vs, kr, dOt, g, t);
    // Pᵀ and dSᵀ in place: keys kr + g (c = 0, 1) and + 8 (c = 2, 3),
    // queries 8j + 2t (+ 1); exactly 0 at masked pairs
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + kr + g + (c >> 1) * 8;
        const int ql = j * 8 + 2 * t + (c & 1);
        const bool vis = visible(q0 + ql, key, a.n_q, a.n_k, a.window, a.num_meta);
        // P is NaN at every key, masked ones included, in a row whose
        // softmax is NaN (lse NaN); dS is exactly 0 at masked pairs
        const float p = vis ? expf(s[j][c] * a.scale - lt[ql]) : lt[ql] != lt[ql] ? lt[ql] : 0.f;
        s[j][c] = p;
        dp[j][c] = vis ? p * (dp[j][c] - dl[ql]) : 0.f;
      }
    // dV += Pᵀ·dO, dK += dSᵀ·Q (the warp's columns)
    product_mb<kSlow, kBf16, T, HD, DC>(acc_dv, s, dOt, c0, g, t);
    product_mb<kSlow, kBf16, T, HD, DC>(acc_dk, dp, Qt, c0, g, t);
    buf ^= 1;
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    const bool bad = !all_finite(acc_dk) || !all_finite(acc_dv);
    if (__syncthreads_or(bad)) return true;  // every warp is done with the buffers
  }

  // the query tiles skipped (every pair masked): 0 · inf where q (for dK)
  // or dO (for dV) holds an inf or NaN
  Mask<W> fk = no_mask<W>(), fv = fk;
  const Mask<W>* qflags = static_cast<const Mask<W>*>(a.qflags);
  const Mask<W>* dflags = static_cast<const Mask<W>*>(a.dflags);
  const long long ftile = ((long long)b * a.hq + h) * n_qt;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt >= qt_first && qt <= qt_last) continue;
    or_into(fk, qflags[ftile + qt]);
    or_into(fv, dflags[ftile + qt]);
  }
  float* dkb = a.dkp + ((long long)b * a.hq + h) * a.n_k * HD;
  float* dvb = a.dvp + ((long long)b * a.hq + h) * a.n_k * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    if (key >= a.n_k) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = c0 + n * 8 + 2 * t;
      float2 vk = make_float2(acc_dk[n][2 * r] * a.scale, acc_dk[n][2 * r + 1] * a.scale);
      float2 vv = make_float2(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      if (flagged(fk, d)) vk.x = nan_f32();
      if (flagged(fk, d + 1)) vk.y = nan_f32();
      if (flagged(fv, d)) vv.x = nan_f32();
      if (flagged(fv, d + 1)) vv.y = nan_f32();
      *reinterpret_cast<float2*>(dkb + (long long)key * HD + d) = vk;
      *reinterpret_cast<float2*>(dvb + (long long)key * HD + d) = vv;
    }
  }
  return false;
}

template <typename T, int HD>
__device__ __noinline__ void dkdv_block_full(const T* q, const T* k, const T* v, const T* dout,
                                             const Args& a) {
  dkdv_block<T, HD, true>(q, k, v, dout, a);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const __grid_constant__ Args a) {
  if (dkdv_block<T, HD, false>(q, k, v, dout, a)) dkdv_block_full<T, HD>(q, k, v, dout, a);
}

// ---------------------------------------------------------------------------
// 3. dK, dV: the G partials of each kv head summed in head order
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(T* __restrict__ dk, T* __restrict__ dv, const __grid_constant__ Args a) {
  const long long idx = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const int hkv = a.hq / a.group;
  const long long total = (long long)a.batch * hkv * a.n_k * a.hd;
  if (idx >= total) return;
  const int d = (int)(idx % a.hd);
  long long rest = idx / a.hd;
  const int j = (int)(rest % a.n_k);
  rest /= a.n_k;
  const int hk = (int)(rest % hkv);
  const int b = (int)(rest / hkv);
  float sk = 0.f, sv = 0.f;
  for (int hh = 0; hh < a.group; ++hh) {
    const long long off =
        (((long long)b * a.hq + hk * a.group + hh) * a.n_k + j) * HD + d;
    sk += a.dkp[off];
    sv += a.dvp[off];
  }
  store(dk + b * a.sdk.b + hk * a.sdk.h + (long long)j * a.sdk.s + d, sk);
  store(dv + b * a.sdv.b + hk * a.sdv.h + (long long)j * a.sdv.s + d, sv);
}

// ---------------------------------------------------------------------------
// 4. dQ of one 64-row query tile of query head h
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t dq_smem() {
  return sizeof(T) * (size_t)pitch<T, HD>() * kT * 6;
}

template <typename T, int HD, bool kSlow>
__device__ __forceinline__ bool dq_block(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         T* __restrict__ dq, const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PT = pitch<T, HD>();
  constexpr int NJ = kT / 8, DC = HD, NT = DC / 8;
  constexpr int W = kW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [kT][PT]
  T* dOs = Qs + kT * PT;               // [kT][PT]
  T* Ks = dOs + kT * PT;               // [2][kT][PT]
  T* Vs = Ks + 2 * kT * PT;            // [2][kT][PT]

  const int n_qt = (a.n_q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int h = idx % a.hq;
  idx /= a.hq;
  const int b = idx % a.batch;
  const int qt = n_qt - 1 - idx / a.batch;  // most keys first
  const int hk = h / a.group;
  const int q0 = qt * kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr = warp * 16;  // the warp's first row in the tile
  const int c0 = 0;          // its first dQ column: it owns every one

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
  auto next_tile = [&](int kt) {
    for (++kt; kt <= kt_last; ++kt)
      if (!skipped(kt)) return kt;
    return -1;
  };

  copy_tile<T, HD>(Qs, q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.n_q, a.hd);
  copy_tile<T, HD>(dOs, dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, a.n_q, a.hd);
  int kt = next_tile(-1);
  if (kt >= 0) {
    copy_tile<T, HD>(Ks, kb, a.sk.s, kt * kT, a.n_k, a.hd);
    copy_tile<T, HD>(Vs, vb, a.sv.s, kt * kT, a.n_k, a.hd);
  }
  cp_async::commit();

  // this lane's rows: qr + g and qr + g + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr + g + 8 * r;
    lse_r[r] = i < a.n_q ? a.lse[row_base + i] : 0.f;
    del_r[r] = i < a.n_q ? a.delta[row_base + i] : 0.f;
  }

  float acc[NT][4];
  zero(acc);
  int buf = 0;
  while (kt >= 0) {
    const int nxt = next_tile(kt);
    cp_async::wait<0>();
    __syncthreads();  // tile kt staged in buf; every warp is done with buf ^ 1
    if (nxt >= 0) {
      copy_tile<T, HD>(Ks + (buf ^ 1) * kT * PT, kb, a.sk.s, nxt * kT, a.n_k, a.hd);
      copy_tile<T, HD>(Vs + (buf ^ 1) * kT * PT, vb, a.sv.s, nxt * kT, a.n_k, a.hd);
    }
    cp_async::commit();
    const T* Kt = Ks + buf * kT * PT;
    const T* Vt = Vs + buf * kT * PT;
    const int k0 = kt * kT;

    // S = Q·Kᵀ and dP = dO·Vᵀ: the warp's 16 rows x kT keys
    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
    product_abt<kSlow, kBf16, T, HD>(s, Qs, qr, Kt, g, t);
    product_abt<kSlow, kBf16, T, HD>(dp, dOs, qr, Vt, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + qr + g + (c >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (c & 1);
        const bool vis = visible(i, key, a.n_q, a.n_k, a.window, a.num_meta);
        const float p = vis ? expf(s[j][c] * a.scale - lse_r[c >> 1]) : 0.f;
        s[j][c] = vis ? p * (dp[j][c] - del_r[c >> 1]) : 0.f;  // dS
      }
    // dQ += dS·K (the warp's columns)
    product_mb<kSlow, kBf16, T, HD, DC>(acc, s, Kt, c0, g, t);
    buf ^= 1;
    kt = nxt;
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    if (__syncthreads_or(!all_finite(acc))) return true;
  }

  // the key tiles skipped (every pair masked): 0 · inf where k holds an inf
  // or NaN
  const int n_kt = (a.n_k + kT - 1) / kT;
  Mask<W> fq = no_mask<W>();
  const Mask<W>* kflags = static_cast<const Mask<W>*>(a.kflags);
  const long long ftile = ((long long)b * (a.hq / a.group) + hk) * n_kt;
  for (int j = 0; j < n_kt; ++j)
    if (skipped(j)) or_into(fq, kflags[ftile + j]);
  T* dqb = dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + qr + g + 8 * r;
    if (i >= a.n_q) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = c0 + n * 8 + 2 * t;
      if (d < a.hd)
        store(dqb + (long long)i * a.sdq.s + d,
              flagged(fq, d) ? nan_f32() : acc[n][2 * r] * a.scale);
      if (d + 1 < a.hd)
        store(dqb + (long long)i * a.sdq.s + d + 1,
              flagged(fq, d + 1) ? nan_f32() : acc[n][2 * r + 1] * a.scale);
    }
  }
  return false;
}

template <typename T, int HD>
__device__ __noinline__ void dq_block_full(const T* q, const T* k, const T* v, const T* dout,
                                           T* dq, const Args& a) {
  dq_block<T, HD, true>(q, k, v, dout, dq, a);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    const __grid_constant__ Args a) {
  if (dq_block<T, HD, false>(q, k, v, dout, dq, a)) dq_block_full<T, HD>(q, k, v, dout, dq, a);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, Args a, float* delta,
                   cudaStream_t stream) {
  constexpr int W = kW;
  const size_t b1 = dkdv_smem<T, HD>(), b2 = dq_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.n_q + kT - 1) / kT, n_kt = (a.n_k + kT - 1) / kT;
  const int hkv = a.hq / a.group;
  flash_bwd_prep_kernel<T, kT, W>
      <<<dim3(n_qt > n_kt ? n_qt : n_kt, a.hq + hkv, a.batch), kThreads, 0, stream>>>(
          (const T*)q, (const T*)k, (const T*)o, (const T*)dout, a.lse, a.sq, a.sk, a.so, a.sdo,
          delta, (Mask<W>*)a.qflags, (Mask<W>*)a.dflags, (Mask<W>*)a.kflags, a.hq, a.n_q,
          a.n_k, a.hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<n_kt * a.hq * a.batch, kThreads, b1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)a.batch * hkv * a.n_k * a.hd;
  flash_bwd_reduce_kernel<T, HD><<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                                   kReduceThreads, 0, stream>>>((T*)dk, (T*)dv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<n_qt * a.hq * a.batch, kThreads, b2, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv, Args a, float* delta,
                      cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, a, delta, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, a, delta, stream);
  return cudaErrorInvalidValue;  // the wrapper raises before
}

}  // namespace

extern "C" {

// q [batch, hq, n_q, hd], k/v [batch, hq/group, n_k, hd], o and dout like q,
// dq like q, dk/dv like k; each given by its (batch, head, row) element
// strides, the hd stride 1; f32 when is_bf16 == 0, else bf16; hd <= 64,
// n_q <= n_k. lse [batch, hq, n_q] f32 from the forward. Workspaces (the
// wrapper allocates them): delta, batch x hq x n_q floats; dkp and dvp,
// batch x hq x n_k x hd_pad floats each (hd_pad: hd rounded up to 32 or
// 64); qflags and dflags, batch x hq x ceil(n_q / 64) entries of 16
// bytes, and kflags batch x hq/group x ceil(n_k / 64), 16-byte aligned.
// Four launches on `stream` (delta and the masks, dK and dV per query
// head, their sum over the group, dQ); returns the first failure of
// cudaGetLastError().
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, void* dq, void* dk,
                               void* dv, float* delta, float* dkp, float* dvp, void* qflags,
                               void* dflags, void* kflags,
                               const long long* strides,  // 24: q, k, v, o, dout, dq, dk, dv x (b, h, s)
                               int batch, int hq, int group, int n_q, int n_k, int hd,
                               float scale, int window, int num_meta, int is_bf16,
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
  a.qflags = qflags;
  a.dflags = dflags;
  a.kflags = kflags;
  a.dkp = dkp;
  a.dvp = dvp;
  a.batch = batch;
  a.hq = hq;
  a.group = group;
  a.n_q = n_q;
  a.n_k = n_k;
  a.hd = hd;
  a.window = window;
  a.num_meta = num_meta;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, dq, dk, dv, a, delta, s);
  return (int)launch_hd<float>(hd, q, k, v, o, dout, dq, dk, dv, a, delta, s);
}

}  // extern "C"
