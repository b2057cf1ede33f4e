// flash_attention_bwd_256 — the backward of flash_attention.cu at hd = vd
// in (64, 256], at two head widths HD: 128 (DBRX's, qwen2's and the dense
// models' head_dim; hd 65-128 zero-padded to 128) and 256 (gemma-2b's; hd
// 129-256 zero-padded to 256), hand-written for Hopper (sm_90a) on its
// warpgroup products (wgmma). One source, templated on HD; each width has
// kernels of its own name (flash_bwd_128_* and flash_bwd_256_*).
//
// Given the forward's q [B, Hq, Sq, hd], k/v [B, Hkv, T, hd], its output o,
// the row log-sum-exp lse [B, Hq, Sq] (f32, in units of the scaled scores)
// and dO like o, it writes dq like q and dk, dv like k and v:
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
// Replaces: no Pallas kernel. The JAX package computes this gradient in jnp
// (the custom VJP _flash_vjp_bwd, src/repro/models/attention.py:138, at
// >= 4096 query rows; autodiff of _direct_attention, :50, below); the port's
// flash_attention_bwd.cu takes hd <= 64 and this file hd in (64, 256].
//
// What bounds it on the card: operations. Five products of 2·hd flops per
// visible (query, key) pair and query head; the two passes below take seven
// (S and dP once in each): at gemma-2b's training shape (B 1, MQA 8/1, S
// 2048, causal) 6.0e10 flops, 0.364 ms at the split-f32 rate (165 TFLOP/s;
// the function's five products 0.260) against 0.02 ms for its 76 MB of
// operands; at DBRX's (B 1, GQA 48/8 at 128, S 2048, causal) 1.8e11 flops,
// 1.09 ms (the five products 0.78) against 0.07 ms for 235 MB.
//
// What the design does about it (described at HD = 256; at 128 every tile
// has half the atoms and stages, a warpgroup's dK or dV is 64 floats a
// thread and each dQ warpgroup owns 64 columns: the same walk, rings and
// swaps, with the flash_attention_bwd.cu design's 255 registers and 900
// bytes of spill at 128 gone). At 256 columns a 64-row f32 tile is 64 KB,
// 128 KB as TF32 hi and lo: a pass cannot keep both of its block's fixed
// operands split in shared memory (256 KB, past the 227 KB a block has), as
// flash_attention_bwd_vd.cu does at (192, 128), and splitting every streamed
// tile in a producer warpgroup is what bounds that kernel (its producer
// alone took 13.5 of 16.2 ms). So:
// 1. flash_bwd_vd_prep_kernel (flash_bwd_wgmma.cuh): delta and the tiles'
//    masks of non-finite columns.
// 2. flash_bwd_256_image_kernel splits every operand once into "images":
//    the exact bytes of the shared-memory stages the passes read, TF32 hi
//    and lo atoms in wgmma's 128-byte-swizzled K-major layout, full split
//    (tf32x3::split, IEEE at inf and NaN; bf16 exact): Q, dO, K and V as
//    stored (64-row tile x 32-column atom) and Qᵀ, dOᵀ and Kᵀ transposed
//    (32-row half x 64-column chunk, in the key order of P's A fragments),
//    eight 16 KB stages a 64-row tile: at gemma-2b's shape 147 MB written
//    from 38 MB of operands.
// 3. flash_bwd_256_dkdv_kernel, one block per (64-key tile, query head, b),
//    the key tiles with the most query tiles first, 256 threads: a dK
//    warpgroup and a dV warpgroup, each with its own ring of three 32 KB
//    slots, which its first thread fills by bulk copies (cp.async.bulk, the
//    copy engine, onto the slot's full mbarrier) as the warpgroup frees
//    them: no thread loads, converts or stores an operand, and no producer
//    warp holds registers (a ninth warp would cap every thread at 168
//    registers, the share of the SM quarter that holds three warps; eight
//    leave 255). Per query tile that sees a key of the tile: Sᵀ = K·Qᵀ (dK
//    warpgroup) and dPᵀ = V·dOᵀ (dV warpgroup), keys as M, each k8 atom a
//    stage of both operands (K and Q, or V and dO), both from shared
//    memory; Pᵀ to the dV warpgroup and dSᵀ back through two 16 KB swaps;
//    dK += dSᵀ·Q and dV += Pᵀ·dO over the Qᵀ and dOᵀ stages, A from
//    registers (P and dS split there), each stage into a zeroed m64n64
//    partial added to the running sum (the tensor cores' f32 accumulation
//    truncates: flash_attention_bwd.cu). dK and dV (64 x 256) stay in
//    registers, 128 floats a thread in each warpgroup. The rows' lse and
//    delta are loaded under the products.
// 4. flash_bwd_vd_reduce_kernel<T, 256, 256>: at G > 1, dK and dV as the
//    sum of the G per-query-head partials, in head order.
// 5. flash_bwd_256_dq_kernel, one block per (64-row query tile, query head,
//    b), the tiles with the most keys first, 256 threads, rings as above:
//    S = Q·Kᵀ (first warpgroup) and dP = dO·Vᵀ (second) over (Q, K) and
//    (dO, V) stages; P to the second through a swap, dS back to the first;
//    then each warpgroup dQ += dS·K for its own 128 of dQ's columns over
//    Kᵀ's stages (64 floats a thread).
// Products: S and dP once in each pass, dK, dV and dQ once: seven. The
// passes stream every operand, the fixed ones too, from the images (L2 for
// the kv heads' and the block's own tile, device memory for the rest):
// 768 KB a (64-key, 64-query) pair in the dK/dV pass, 640 KB in the dQ
// pass. The products run on the fast split of P and dS; a block whose
// result holds an inf or NaN runs again with the full split of P and dS in
// the same launch, through the same rings (the images are the full split
// either way). No atomics: the same bits every run.
//
// Non-finite values as flash_attention_bwd.cu gives them: P is NaN at every
// key of a row whose softmax is NaN (lse NaN); delta is NaN for a row of dO
// with an inf or NaN; dS is exactly 0 at masked pairs, so 0 · inf gives NaN
// inside the visited tiles; the tiles a pass skips hold only masked pairs,
// and their masks (q for dK, dO for dV, k for dQ) are ORed and written as
// NaN into those columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_wgmma.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace wgmma;

constexpr int kSlot = 2 * kStage;  // a ring slot: two operands' stages
constexpr int kR = 3;             // ring slots a consumer warpgroup
constexpr int kWorkers = 256;     // two consumer warpgroups
constexpr int kSwap = 64 * 64 * 4;
constexpr int kSmem = 2 * kR * kSlot + 2 * kSwap + 1024;  // + the alignment to 1024 bytes
// mbarriers: per warpgroup, full[kR] and empty[kR] of its ring
constexpr int kBars = 4 * kR;

// The images: Q, dO, Qᵀ, dOᵀ per query head, K, V, Kᵀ per kv head; each
// [B, H, tiles, HD / 32 stages of kStage bytes]
enum Image { kQ, kDO, kQT, kDOT, kK, kV, kKT, kImages };

struct Images {
  unsigned char* p[kImages];
};

template <int HD>
__device__ __forceinline__ const unsigned char* stage_of(const Images& im, int which,
                                                         const Args& a, int b, int h, int tile,
                                                         int s) {
  const bool kv = which >= kK;
  const int heads = kv ? a.hq / a.group : a.hq;
  const int tiles = ((kv ? a.n_k : a.n_q) + kT - 1) / kT;
  return im.p[which] + ((((long long)b * heads + h) * tiles + tile) * (HD / 32) + s) * kStage;
}

// ---------------------------------------------------------------------------
// 2. the images
// ---------------------------------------------------------------------------

// grid (tiles, HD / 32 stages, B x (4 Hq + 3 Hkv)), 128 threads: stage s of
// one tile of one image, split with tf32x3::split (bf16: exact)
template <typename T, int HD>
__device__ __forceinline__ void image_stage(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, const T* __restrict__ dout,
                                            const Args& a, const Images& im) {
  const int hkv = a.hq / a.group, per_b = 4 * a.hq + 3 * hkv;
  const int b = blockIdx.z / per_b, j = blockIdx.z % per_b;
  const int which = j < 4 * a.hq ? j / a.hq : kK + (j - 4 * a.hq) / hkv;
  const int h = j < 4 * a.hq ? j % a.hq : (j - 4 * a.hq) % hkv;
  const bool kv = which >= kK;
  const int n = kv ? a.n_k : a.n_q;
  const int tile = blockIdx.x, s = blockIdx.y;
  if (tile * kT >= n) return;
  const T* base;
  Strides st;
  switch (which) {
    case kQ: case kQT: base = q; st = a.sq; break;
    case kDO: case kDOT: base = dout; st = a.sdo; break;
    case kK: case kKT: base = k; st = a.sk; break;
    default: base = v; st = a.sv; break;
  }
  unsigned char* dst = const_cast<unsigned char*>(stage_of<HD>(im, which, a, b, h, tile, s));
  put_image_stage<T, HD>(dst, base + b * st.b + h * st.h, st.s, tile * kT, n, a.hd, s,
                         which == kQT || which == kDOT || which == kKT, threadIdx.x);
}

// the kernels by head width (the profiler's names tell the two apart)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_256_image_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const __grid_constant__ Args a, const __grid_constant__ Images im) {
  image_stage<T, 256>(q, k, v, dout, a, im);
}
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_128_image_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const __grid_constant__ Args a, const __grid_constant__ Images im) {
  image_stage<T, 128>(q, k, v, dout, a, im);
}

// ---------------------------------------------------------------------------
// Each consumer warpgroup's ring: its first thread lands a stage as the
// warpgroup frees the one kR stages before it
// ---------------------------------------------------------------------------

using Ring = WgRing<kR>;

// d = A·Bᵀ over the NA atoms of two operands' (64 x 32 NA) stages m0 ..
// m0 + NA - 1: each atom's stage freed one group later
template <bool kBf16, int NA, class F>
__device__ __forceinline__ void ss_tile(float (&d)[32], const F& f, uint32_t m0) {
  zero(d);
#pragma unroll
  for (int c = 0; c < NA; ++c) {
    const uint32_t st = f.r.take(m0 + c);
    mma_fence();
    ss_atom<kBf16>(d, desc(st), desc(st + kAtom), desc(st + kStage), desc(st + kStage + kAtom));
    mma_commit();
    if (c > 0) {
      mma_wait<1>();
      f.release(m0 + c - 1);
    }
  }
  mma_wait<0>();
  keep(d);
  f.release(m0 + NA - 1);
}

// part += A·B over one 32-row stage m, A's fragments j0 .. j0 + 3 from
// registers, B the stage's atoms; the stage freed once its group is done
template <bool kBf16, int N, class F>
__device__ __forceinline__ void rs_stage(float (&part)[32], uint32_t (&fh)[N], uint32_t (&fl)[N],
                                         int j0, const F& f, uint32_t m) {
  const uint32_t st = f.r.take(m);
  mma_fence();
  rs_atom<kBf16>(part, fh, fl, j0, desc(st), desc(st + kAtom));
  mma_commit();
  mma_wait<0>();
  keep(part);
  keep(fh);
  keep(fl);
  f.release(m);
}

// ---------------------------------------------------------------------------
// 3. dK and dV of one 64-key tile, from one query head
// ---------------------------------------------------------------------------

// A warpgroup's stages of a query tile: NA = HD / 32 of (K or V atom c, Q
// or dO atom c), then NA of Qᵀ or dOᵀ (32-query half hh, 64-column chunk c:
// image stage NC hh + c, NC = HD / 64)
template <typename T, int HD>
__device__ __forceinline__ int dkdv_block(T* __restrict__ dk, T* __restrict__ dv, const Args& a,
                                          const Images& im, unsigned char* smem, const Ring& r,
                                          uint32_t* masks, uint32_t pass, uint32_t m0) {
  constexpr int NC = HD / 64, NA = HD / 32, kKVSPT = 2 * NA;
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool slow = pass == 1;
  const KVTile tl(a);
  const int h = tl.h, b = tl.b, hk = tl.hk, k0 = tl.k0, n_qt = tl.n_qt;
  const int qt_first = tl.qt_first, qt_last = tl.qt_last, ntiles = tl.ntiles;
  const int wg = threadIdx.x >> 7;  // 0: dK, 1: dV
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = k0 / kT;
  const uint32_t m_end = m0 + (uint32_t)(ntiles * kKVSPT);
  auto land = [&](uint32_t m) {
    const int j = (int)(m - m0), qt = qt_first + j / kKVSPT, i = j % kKVSPT;
    if (i < NA)
      r.land(m, stage_of<HD>(im, wg ? kV : kK, a, b, hk, kt, i),
             stage_of<HD>(im, wg ? kDO : kQ, a, b, h, qt, i), kStage);
    else
      r.land(m, stage_of<HD>(im, wg ? kDOT : kQT, a, b, h, qt, i - NA), nullptr, kStage);
  };
  const WgFeed<kR, decltype(land)> f{r, land, m0, m_end, tid == 0};
  f.start();
  // Pᵀ (swap 0) and dSᵀ (swap 1), element r of thread tid's accumulator at
  // r * 128 + tid
  float* swap_p = reinterpret_cast<float*>(smem + 2 * kR * kSlot);
  float* swap_ds = swap_p + 64 * 64;
  const long long row_base = ((long long)b * a.hq + h) * a.n_q;
  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0 and key0 + 8
  float acc[NC][32], sacc[32], part[32];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  bool bad = false;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = (qt_first + tile) * kT;
    const uint32_t mt = m0 + (uint32_t)(tile * kKVSPT);
    // the log-sum-exp (dK's) or delta (dV's) of this thread's queries q0 +
    // 8j + 2t + e, loaded under the products
    float lv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        lv[2 * j + e] = qi < a.n_q ? (wg == 0 ? a.lse : a.delta)[row_base + qi] : 0.f;
      }
    // Sᵀ = K·Qᵀ (dK's), dPᵀ = V·dOᵀ (dV's): keys key0 (c < 2) and key0 + 8,
    // queries q0 + 8j + 2t + c % 2
    ss_tile<kBf16, NA>(sacc, f, mt);
    const bool all = all_visible(q0, k0, a.n_q, a.n_k, a.window, a.num_meta);
    if (wg == 0) {
      if (tile > 0) named_sync(3, 256);  // the dV warpgroup is done with Pᵀ
      // Pᵀ; NaN at every key, masked ones included, in a row whose softmax
      // is NaN (lse NaN)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + 8 * (c >> 1), qi = q0 + 8 * j + 2 * t + (c & 1);
          const float l = lv[2 * j + (c & 1)];
          const bool vis = all || visible(qi, key, a.n_q, a.n_k, a.window, a.num_meta);
          swap_p[(4 * j + c) * 128 + tid] = vis ? expf(sacc[4 * j + c] * a.scale - l)
                                                : l != l ? l : 0.f;
        }
      named_arrive(1, 256);  // Pᵀ is in its swap
      named_sync(2, 256);    // dSᵀ is in its
    } else {
      named_sync(1, 256);
      // dSᵀ = Pᵀ ∘ (dPᵀ - delta) on the visible pairs, exactly 0 elsewhere
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = 4 * j + c;
          const int key = key0 + 8 * (c >> 1), qi = q0 + 8 * j + 2 * t + (c & 1);
          const bool vis = all || visible(qi, key, a.n_q, a.n_k, a.window, a.num_meta);
          swap_ds[rr * 128 + tid] =
              vis ? swap_p[rr * 128 + tid] * (sacc[rr] - lv[2 * j + (c & 1)]) : 0.f;
        }
      named_arrive(2, 256);
    }
    // dK += dSᵀ·Q, dV += Pᵀ·dO: a 32-query half of dSᵀ or Pᵀ at a time (its
    // fragments from the swap), 64 columns at a time: stages Qᵀ or dOᵀ
    // (half hh, chunk c)
    const float* src = wg == 0 ? swap_ds : swap_p;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t fh[16], fl[16];
      float half[16];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) half[rr] = src[(16 * hh + rr) * 128 + tid];
      split_frags(half, fh, fl, slow);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        zero(part);
        rs_stage<kBf16>(part, fh, fl, 0, f, mt + NA + NC * hh + c);
#pragma unroll
        for (int rr = 0; rr < 32; ++rr) acc[c][rr] += part[rr];
      }
    }
    if (wg == 1) named_arrive(3, 256);  // done with Pᵀ
  }
  if (wg == 0 && ntiles > 0) named_sync(3, 256);  // the last tile's arrival
  if (!slow) {
#pragma unroll
    for (int c = 0; c < NC; ++c) bad |= !all_finite(acc[c]);
    if (__syncthreads_or(bad)) return (int)m_end;
  }
  // the query tiles skipped (every pair masked): 0 · inf where q (dK) or dO
  // (dV; every column of a tile with a NaN softmax row) holds an inf or NaN
  uint32_t* m = masks + wg * kW;
  if (tid < kW) {
    const uint32_t* flags = wg == 0 ? a.qflags : a.dflags;
    uint32_t bits = 0u;
    const long long ftile = ((long long)b * a.hq + h) * n_qt;
    for (int qt = 0; qt < n_qt; ++qt)
      if (qt < qt_first || qt > qt_last) bits |= flags[(ftile + qt) * kW + tid];
    m[tid] = bits;
  }
  named_sync(4 + wg, 128);
  const float sc = wg == 0 ? a.scale : 1.f;
  T* out = wg == 0 ? dk : dv;
  const Strides so = wg == 0 ? a.sdk : a.sdv;
  float* partial = wg == 0 ? a.dkp : a.dvp;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 8 * rr;
    if (key >= a.n_k) continue;
    T* row = out + b * so.b + hk * so.h + (long long)key * so.s;
    float* prow = partial + (((long long)b * a.hq + h) * a.n_k + key) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t;
        float2 val = make_float2(acc[c][4 * j + 2 * rr] * sc, acc[c][4 * j + 2 * rr + 1] * sc);
        if (flagged(m, d)) val.x = nan_f32();
        if (flagged(m, d + 1)) val.y = nan_f32();
        if (a.group == 1) {
          if (d < a.hd) store(row + d, val.x);
          if (d + 1 < a.hd) store(row + d + 1, val.y);
        } else {
          *reinterpret_cast<float2*>(prow + d) = val;
        }
      }
  }
  return -1;
}

// The kernels' mbarriers (per warpgroup, full[kR] with one arrival and
// empty[kR] with one a warp) and this warpgroup's ring over `tiles`. Each
// kernel then runs its block's pass 0 on the fast split and, for a block
// whose result holds an inf or a NaN, pass 1 on the full split, in one
// inlined body (a call out of line would make ptxas serialize every wgmma
// of the kernel), the ring's stage count going on from one to the other.
__device__ __forceinline__ Ring init_rings(unsigned char* tiles, uint64_t* bars) {
  const uint32_t bu = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBars; ++i) bar_init(bu + 8 * i, i % (2 * kR) < kR ? 1 : kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  return Ring{smem_u32(tiles) + wg * kR * kSlot, bu + 16 * kR * wg, kSlot};
}

// 256 threads: the dK warpgroup and the dV warpgroup
template <typename T, int HD>
__device__ __forceinline__ void dkdv_kernel(T* __restrict__ dk, T* __restrict__ dv,
                                            const Args& a, const Images& im) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kBars];
  __shared__ uint32_t masks[2 * kW];
  unsigned char* tiles = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const Ring r = init_rings(tiles, bars);
  uint32_t m0 = 0;
  for (uint32_t pass = 0;; ++pass) {
    const int n = dkdv_block<T, HD>(dk, dv, a, im, tiles, r, masks, pass, m0);
    if (n < 0) break;
    m0 = (uint32_t)n;
  }
}
template <typename T>
__global__ void __launch_bounds__(kWorkers, 1)
flash_bwd_256_dkdv_kernel(T* __restrict__ dk, T* __restrict__ dv, const __grid_constant__ Args a,
                          const __grid_constant__ Images im) {
  dkdv_kernel<T, 256>(dk, dv, a, im);
}
template <typename T>
__global__ void __launch_bounds__(kWorkers, 1)
flash_bwd_128_dkdv_kernel(T* __restrict__ dk, T* __restrict__ dv, const __grid_constant__ Args a,
                          const __grid_constant__ Images im) {
  dkdv_kernel<T, 128>(dk, dv, a, im);
}

// ---------------------------------------------------------------------------
// 5. dQ of one 64-row query tile of query head h
// ---------------------------------------------------------------------------

// A warpgroup's stages of a key tile: NA = HD / 32 of (Q or dO atom c, K
// or V atom c), then NC = HD / 64 of Kᵀ: its own NC / 2 64-column chunks
// (c = (NC / 2) wg + cc) by 32-key half hh, stage k being cc = k / 2, hh =
// k % 2 (image stage NC hh + c)

// the block's query tile and its walk over the key tiles
struct QTile {
  int h, b, hk, q0, kt_last;
  const Args& a;
  __device__ __forceinline__ explicit QTile(const Args& args) : a(args) {
    const int n_qt = (a.n_q + kT - 1) / kT;
    int idx = blockIdx.x;
    h = idx % a.hq;
    idx /= a.hq;
    b = idx % a.batch;
    q0 = (n_qt - 1 - idx / a.batch) * kT;  // most keys first
    hk = h / a.group;
    kt_last = min((a.n_k - 1) / kT, (min(q0 + kT, a.n_q) - 1) / kT);
  }
  // the forward's walk: key tiles up to the diagonal, skipping those wholly
  // outside the window that hold no meta token
  __device__ __forceinline__ bool skipped(int kt) const {
    const int k0 = kt * kT;
    return kt > kt_last || (a.window > 0 && k0 >= a.num_meta && q0 - (k0 + kT - 1) >= a.window);
  }
  __device__ __forceinline__ int next(int kt) const {
    for (++kt; kt <= kt_last; ++kt)
      if (!skipped(kt)) return kt;
    return -1;
  }
  __device__ __forceinline__ int visited() const {
    int n = 0;
    for (int kt = next(-1); kt >= 0; kt = next(kt)) ++n;
    return n;
  }
};

template <typename T, int HD>
__device__ __forceinline__ int dq_block(T* __restrict__ dq, const Args& a, const Images& im,
                                        unsigned char* smem, const Ring& r, uint32_t* masks,
                                        uint32_t pass, uint32_t m0) {
  constexpr int NA = HD / 32, NC = HD / 64, kQSPT = NA + NC;
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool slow = pass == 1;
  const QTile qt(a);
  const int h = qt.h, b = qt.b, hk = qt.hk, q0 = qt.q0;
  const int wg = threadIdx.x >> 7;  // 0: S, 1: dP
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tq = q0 / kT;
  const uint32_t m_end = m0 + (uint32_t)(qt.visited() * kQSPT);
  // the first thread's cursor: the next stage to land is stage li of key
  // tile lkt
  int lkt = qt.next(-1), li = 0;
  auto land = [&](uint32_t m) {
    if (li < NA) {
      r.land(m, stage_of<HD>(im, wg ? kDO : kQ, a, b, h, tq, li),
             stage_of<HD>(im, wg ? kV : kK, a, b, hk, lkt, li), kStage);
    } else {
      const int k = li - NA;
      r.land(m, stage_of<HD>(im, kKT, a, b, hk, lkt, NC * (k & 1) + (NC / 2) * wg + (k >> 1)),
             nullptr, kStage);
    }
    if (++li == kQSPT) {
      li = 0;
      lkt = qt.next(lkt);
    }
  };
  const WgFeed<kR, decltype(land)> f{r, land, m0, m_end, tid == 0};
  f.start();
  float* swap_p = reinterpret_cast<float*>(smem + 2 * kR * kSlot);
  float* swap_ds = swap_p + 64 * 64;
  const long long row_base = ((long long)b * a.hq + h) * a.n_q;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0 and row0 + 8
  float rv[2];  // lse (S's warpgroup) or delta (dP's) of the rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row0 + 8 * rr;
    rv[rr] = i < a.n_q ? (wg == 0 ? a.lse : a.delta)[row_base + i] : 0.f;
  }
  float acc[NC / 2][32], s[32], part[32];
  uint32_t fh[32], fl[32];
#pragma unroll
  for (int cc = 0; cc < NC / 2; ++cc) zero(acc[cc]);
  uint32_t mt = m0;
  for (int kt = qt.next(-1); kt >= 0; kt = qt.next(kt), mt += kQSPT) {
    const int k0 = kt * kT;
    // S = Q·Kᵀ or dP = dO·Vᵀ: rows row0 (c < 2) and row0 + 8, keys k0 + 8j +
    // 2t + c % 2
    ss_tile<kBf16, NA>(s, f, mt);
    const bool all = all_visible(q0, k0, a.n_q, a.n_k, a.window, a.num_meta);
    if (wg == 0) {
      // P, then dS from the dP warpgroup
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = 4 * j + c;
          const int i = row0 + 8 * (c >> 1), key = k0 + 8 * j + 2 * t + (c & 1);
          const bool vis = all || visible(i, key, a.n_q, a.n_k, a.window, a.num_meta);
          swap_p[rr * 128 + tid] = vis ? expf(s[rr] * a.scale - rv[c >> 1]) : 0.f;
        }
      named_arrive(1, 256);
      named_sync(2, 256);
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) s[rr] = swap_ds[rr * 128 + tid];
    } else {
      // dS = P ∘ (dP - delta) on the visible pairs, exactly 0 elsewhere
      named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = 4 * j + c;
          const int i = row0 + 8 * (c >> 1), key = k0 + 8 * j + 2 * t + (c & 1);
          const bool vis = all || visible(i, key, a.n_q, a.n_k, a.window, a.num_meta);
          s[rr] = vis ? swap_p[rr * 128 + tid] * (s[rr] - rv[c >> 1]) : 0.f;
          swap_ds[rr * 128 + tid] = s[rr];
        }
      named_arrive(2, 256);
    }
    split_frags(s, fh, fl, slow);
    // dQ += dS·K over this warpgroup's NC / 2 64-column chunks, each from
    // the two 32-key halves of Kᵀ's stages into one zeroed partial
#pragma unroll
    for (int cc = 0; cc < NC / 2; ++cc) {
      zero(part);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        rs_stage<kBf16>(part, fh, fl, 4 * hh, f, mt + NA + 2 * cc + hh);
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) acc[cc][rr] += part[rr];
    }
  }
  if (!slow) {
    bool bad = false;
#pragma unroll
    for (int cc = 0; cc < NC / 2; ++cc) bad |= !all_finite(acc[cc]);
    if (__syncthreads_or(bad)) return (int)m_end;
  }
  // the key tiles skipped (every pair masked): 0 · inf where k holds an inf
  // or NaN
  const int n_kt = (a.n_k + kT - 1) / kT;
  uint32_t* m = masks + wg * kW;
  if (tid < kW) {
    uint32_t bits = 0u;
    const long long ftile = ((long long)b * (a.hq / a.group) + hk) * n_kt;
    for (int j = 0; j < n_kt; ++j)
      if (qt.skipped(j)) bits |= a.kflags[(ftile + j) * kW + tid];
    m[tid] = bits;
  }
  named_sync(4 + wg, 128);
  T* dqb = dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row0 + 8 * rr;
    if (i >= a.n_q) continue;
#pragma unroll
    for (int cc = 0; cc < NC / 2; ++cc)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * ((NC / 2) * wg + cc) + 8 * j + 2 * t;
        if (d < a.hd)
          store(dqb + (long long)i * a.sdq.s + d,
                flagged(m, d) ? nan_f32() : acc[cc][4 * j + 2 * rr] * a.scale);
        if (d + 1 < a.hd)
          store(dqb + (long long)i * a.sdq.s + d + 1,
                flagged(m, d + 1) ? nan_f32() : acc[cc][4 * j + 2 * rr + 1] * a.scale);
      }
  }
  return -1;
}

// 256 threads: the S warpgroup and the dP warpgroup
template <typename T, int HD>
__device__ __forceinline__ void dq_kernel(T* __restrict__ dq, const Args& a, const Images& im) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kBars];
  __shared__ uint32_t masks[2 * kW];
  unsigned char* tiles = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const Ring r = init_rings(tiles, bars);
  uint32_t m0 = 0;
  for (uint32_t pass = 0;; ++pass) {
    const int n = dq_block<T, HD>(dq, a, im, tiles, r, masks, pass, m0);
    if (n < 0) break;
    m0 = (uint32_t)n;
  }
}
template <typename T>
__global__ void __launch_bounds__(kWorkers, 1)
flash_bwd_256_dq_kernel(T* __restrict__ dq, const __grid_constant__ Args a,
                        const __grid_constant__ Images im) {
  dq_kernel<T, 256>(dq, a, im);
}
template <typename T>
__global__ void __launch_bounds__(kWorkers, 1)
flash_bwd_128_dq_kernel(T* __restrict__ dq, const __grid_constant__ Args a,
                        const __grid_constant__ Images im) {
  dq_kernel<T, 128>(dq, a, im);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, Args a, uint32_t* qflags,
                   uint32_t* dflags, uint32_t* kflags, float* delta, const Images& im,
                   cudaStream_t stream) {
  // the head width's three kernels
  const auto image = HD == 128 ? flash_bwd_128_image_kernel<T> : flash_bwd_256_image_kernel<T>;
  const auto dkdv = HD == 128 ? flash_bwd_128_dkdv_kernel<T> : flash_bwd_256_dkdv_kernel<T>;
  const auto dq_k = HD == 128 ? flash_bwd_128_dq_kernel<T> : flash_bwd_256_dq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.n_q + kT - 1) / kT, n_kt = (a.n_k + kT - 1) / kT;
  const int hkv = a.hq / a.group;
  flash_bwd_vd_prep_kernel<T><<<dim3(n_qt > n_kt ? n_qt : n_kt, a.hq + hkv, a.batch), kThreads,
                                0, stream>>>((const T*)q, (const T*)k, (const T*)o,
                                             (const T*)dout, a, delta, qflags, dflags, kflags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  image<<<dim3(n_qt > n_kt ? n_qt : n_kt, HD / 32, a.batch * (4 * a.hq + 3 * hkv)), kThreads, 0,
          stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, a, im);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<n_kt * a.hq * a.batch, kWorkers, kSmem, stream>>>((T*)dk, (T*)dv, a, im);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.group > 1) {
    const long long total = (long long)a.batch * hkv * a.n_k * HD;
    flash_bwd_vd_reduce_kernel<T, HD, HD>
        <<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
           stream>>>((T*)dk, (T*)dv, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dq_k<<<n_qt * a.hq * a.batch, kWorkers, kSmem, stream>>>((T*)dq, a, im);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [batch, hq, n_q, hd], k/v [batch, hq/group, n_k, hd], o and dout like
// q, dq like q, dk/dv like k; each given by its (batch, head, row) element
// strides, the head_dim stride 1; f32 when is_bf16 == 0, else bf16; 64 <
// hd <= 256 (zero-padded to the head width W: 128 up to hd 128, else 256),
// n_q <= n_k. lse [batch, hq, n_q] f32 from the forward. Workspaces (the
// wrapper allocates them): delta, batch x hq x n_q floats; at group > 1 dkp
// and dvp, batch x hq x n_k x W floats each, else unused; qflags and
// dflags, batch x hq x ceil(n_q / 64) x 8 words, kflags batch x hq/group x
// ceil(n_k / 64) x 8; images, 16-byte aligned, W / 32 16 KB stages a
// 64-row tile: four of batch x hq x ceil(n_q / 64) tiles (Q, dO, Qᵀ, dOᵀ)
// and three of batch x hq/group x ceil(n_k / 64) (K, V, Kᵀ), in that order
// in `images`. Four or five launches on `stream` (delta and the masks, the
// images, dK and dV, their sum over the group when group > 1, dQ); returns
// the first failure of cudaGetLastError().
int flash_attention_bwd_256_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, float* dkp, float* dvp, void* qflags,
                                   void* dflags, void* kflags, void* const* images,
                                   const long long* strides,  // 24: q, k, v, o, dout, dq, dk, dv x (b, h, s)
                                   int batch, int hq, int group, int n_q, int n_k, int hd,
                                   float scale, int window, int num_meta, int is_bf16,
                                   void* stream) {
  if (hd <= 64 || hd > 256) return (int)cudaErrorInvalidValue;  // the wrapper raises before
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
  a.vd = hd;
  a.window = window;
  a.num_meta = num_meta;
  a.scale = scale;
  Images im;
  for (int i = 0; i < kImages; ++i) im.p[i] = (unsigned char*)images[i];
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *qf = (uint32_t*)qflags, *df = (uint32_t*)dflags, *kf = (uint32_t*)kflags;
  if (is_bf16)
    return (int)(hd <= 128 ? launch<__nv_bfloat16, 128>(q, k, v, o, dout, dq, dk, dv, a, qf, df,
                                                        kf, delta, im, s)
                           : launch<__nv_bfloat16, 256>(q, k, v, o, dout, dq, dk, dv, a, qf, df,
                                                        kf, delta, im, s));
  return (int)(hd <= 128 ? launch<float, 128>(q, k, v, o, dout, dq, dk, dv, a, qf, df, kf, delta,
                                              im, s)
                         : launch<float, 256>(q, k, v, o, dout, dq, dk, dv, a, qf, df, kf, delta,
                                              im, s));
}

}  // extern "C"
