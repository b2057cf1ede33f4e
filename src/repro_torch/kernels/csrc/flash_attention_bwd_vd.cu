// flash_attention_bwd_vd — the backward of flash_attention.cu where v's
// head_dim vd differs from q's and k's hd (DeepSeek-V2's MLA: q/k 192 =
// 128 nope + 64 rope, v 128), hand-written for Hopper (sm_90a) on its
// warpgroup products (wgmma).
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
// What the design does about it: the FlashAttention-2 two passes, each on
// split-f32 tf32 wgmma (three TF32 products per f32 product, tf32x3.cuh)
// fed by a producer warpgroup through a ring of 16 KB stages in shared
// memory, a full and an empty mbarrier a slot, the pattern of
// flash_attention.cu's flash_fwd_kernel_wgmma (wgmma.cuh):
// 1. flash_bwd_vd_prep_kernel, one block per (64-row tile, head, b):
//    delta = rowsum(dO ∘ O) over vd, one warp per row, and per tile a
//    bitmask of the columns where q (over hd), dO (over vd; every column
//    for a tile with a NaN softmax row) or k (kv heads, over hd) hold an
//    inf or NaN: kW = 8 words, 256 columns.
// 2. flash_bwd_vd_dkdv_wgmma_kernel<T, HD, VD>, one block per (64-key
//    tile, query head, b), the key tiles with the most query tiles first,
//    384 threads: a dK warpgroup, a dV warpgroup and a producer
//    warpgroup. K and V of the key tile stay resident in shared memory,
//    split once into hi and lo (160 KB at (192, 128)); the producer streams
//    each query tile that sees a key of the tile through a ring of three
//    stages, 20 stages a query tile: Q and dO as stored ([rows][columns],
//    the B operands of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, keys as M), then Qᵀ and
//    dOᵀ (the B operands of dK += dSᵀ·Q and dV += Pᵀ·dO: tf32 wgmma reads
//    only K-major operands from shared memory, so the producer stores them
//    transposed, [columns][rows], in the key order in which the Sᵀ
//    accumulator hands P over as an A fragment: inside each group of 8
//    rows, position t holds row 2t and position t + 4 row 2t + 1), in
//    (32-row half, 64-column chunk) stages; with each tile's first stage
//    it stores the tile's lse and delta. The dK warpgroup computes Sᵀ and
//    Pᵀ, the dV warpgroup dPᵀ; they swap Pᵀ for dSᵀ through 16 KB of f32
//    (thread i of both holds the same positions of an m64n64 accumulator,
//    so each reads only what its twin wrote) behind two named barriers.
//    Each warpgroup waits on full barriers of its own: sharing them, one
//    that runs ahead could wait for a stage two fills of its slot away,
//    which a parity wait cannot tell from the last one. dK (64 x 192) and
//    dV (64 x 128) stay in the two warpgroups' registers, 96 and 64 a
//    thread, within the 168 that 384 threads have, so the A fragments of
//    dV += Pᵀ·dO and dK += dSᵀ·Q are split one 32-query half at a time
//    (ptxas spills 352 bytes at (192, 128); reading dSᵀ two k8 steps at a
//    time spills 136 but ran 0.5 % slower on an H100). (With
//    setmaxnreg, moving registers from the producer to the consumers, the
//    kernel hung: ptxas still compiled every role for 168.) At G = 1 the
//    block writes dK and dV in the operands' dtype; at G > 1 an f32
//    partial per query head, which
// 3. flash_bwd_vd_reduce_kernel sums over the group in head order.
// 4. flash_bwd_vd_dq_wgmma_kernel<T, HD, VD>, one block per (64-row query
//    tile, query head, b), the tiles with the most keys first, 256
//    threads: a consumer and a producer warpgroup. Q and dO stay resident
//    (160 KB); the producer streams each visited key tile's K and V as
//    stored (B operands of S = Q·Kᵀ and dP = dO·Vᵀ) and Kᵀ (B of dQ +=
//    dS·K, in P's key order) through a ring of four stages, 16 a key tile.
// Products at (192, 128): S and dP twice (once a pass), dK, dV and dQ once:
// 2,304 flops a pair against the function's 1,664 (3.75 ms at the
// split-f32 rate at DeepSeek-V2's training shape).
// Every operand is split once, by the producer, as it stores it (hi the
// f32 truncated to the 19 bits the tensor cores read, lo = x - hi); P and
// dS are split in registers. The tensor cores' f32 accumulation truncates
// (flash_attention_bwd.cu), so each stage's share of dK and dV (32 query
// rows) and each key tile's of dQ goes into a zeroed m64n64 partial, one
// 64-column chunk at a time, which is then added to the running sum.
// The products run on the fast split; a block whose result holds an inf or
// NaN runs again on the full split in the same launch, its producer and
// consumers going on through the same ring. No atomics: the same bits
// every run.
//
// Non-finite values as the autodiff gives them, by the rules of
// flash_attention_bwd.cu: P is NaN at every key of a row whose softmax is
// NaN (lse NaN); delta is NaN for a row of dO with an inf or NaN; dS is
// exactly 0 at masked pairs, so 0 · inf gives NaN inside the visited
// tiles; the tiles a pass skips hold only masked pairs, and their masks
// (q for dK, dO for dV, k for dQ) are ORed and written as NaN into those
// columns. Shapes: hd <= 192 and vd <= 128, in two instantiations of
// (HD, VD): (64, 64) (the reduced config's (24, 16)) and (192, 128), the
// columns past hd and vd zero (each instantiation adds minutes to the
// build); the wrapper raises for others. hd = vd = 256 does not fit: K and
// V of a 64-key tile alone, split, would be 256 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_wgmma.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace wgmma;

constexpr int kKVStages = 3;    // the dK/dV pass's ring (224 KB with K, V and the swap)
constexpr int kQStages = 4;     // the dQ pass's ring (224 KB with Q and dO)
// Pᵀ, then dSᵀ, as f32 between the dK/dV pass's consumers
constexpr int kSwap = 64 * 64 * 4;

// ---------------------------------------------------------------------------
// 2. dK and dV of one 64-key tile, from one query head
// ---------------------------------------------------------------------------

// The dK/dV pass's shape: NQ atoms of q/k's columns, ND of v/dO's. A query
// tile is SPT ring stages, two phases of NQ + ND: first Q and dO as stored,
// then Qᵀ and dOᵀ in (32-row half, 64-column chunk) stages, half-major; in
// each phase the dK warpgroup's (Q's) and the dV warpgroup's (dO's)
// alternate while both have any, so that the two consume the ring side by
// side.
template <int HD, int VD>
struct KV {
  static_assert(HD % 64 == 0 && VD % 64 == 0 && VD <= HD, "whole 64-column chunks, vd <= hd");
  static constexpr int NQ = HD / 32, ND = VD / 32;
  static constexpr int PH = NQ + ND;  // stages a phase
  static constexpr int SPT = 2 * PH;
  // the place in its phase of the dK warpgroup's stage i, and of the dV one's
  static __device__ __forceinline__ int pos_k(int i) { return i < ND ? 2 * i : ND + i; }
  static __device__ __forceinline__ int pos_v(int i) { return 2 * i + 1; }
  // mbarriers: the ring's full ones for the dK warpgroup's stages, for the
  // dV one's, the empty ones, then K and V's (resident). A consumer waits
  // on its own full barriers only: sharing them, a consumer that runs
  // ahead could wait for a stage two fills of its slot away, which a
  // parity wait cannot tell from the last one.
  static constexpr int kEmpty = 2 * kKVStages, kResBar = 3 * kKVStages, kBars = kResBar + 1;
  // shared memory: K's hi and lo atoms, V's, the ring, the swap, lse and
  // delta
  static constexpr int kRing = 2 * (NQ + ND) * kAtom;
  static constexpr int kSwapAt = kRing + kKVStages * kStage;
  // two query tiles' lse and delta, 64 rows each
  static constexpr int kVecAt = kSwapAt + kSwap;
  static constexpr int kSmem = kVecAt + 2 * 128 * 4 + 1024;  // + the alignment to 1024 bytes
};

// The block's work, one (64-key tile, query head, b) as 384 threads (see
// the head of this file), in two functions: the producer's warpgroup and
// the consumers'. Each role runs its own passes: pass 0 on the fast split,
// where a result that holds an inf or a NaN is not stored and the ring's
// stage count is returned, from which pass 1, on the full split, goes on;
// else -1. n0: the ring's stage count at the start (the resident barrier
// completes once a pass).
template <typename T, int HD, int VD>
__device__ __forceinline__ int dkdv_producer(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             const T* __restrict__ dout, const Args& a,
                                             unsigned char* smem, uint32_t bars, uint32_t pass,
                                             uint32_t n0) {
  using S = KV<HD, VD>;
  constexpr int NQ = S::NQ, ND = S::ND, SPT = S::SPT, NS = kKVStages;
  const bool slow = pass == 1;
  const uint32_t resbar = bars + 8 * S::kResBar;
  auto empty = [&](uint32_t n) { return bars + 8 * (S::kEmpty + n % NS); };
  const KVTile tl(a);
  const int qt_first = tl.qt_first, k0 = tl.k0;
  const uint32_t n_end = n0 + (uint32_t)(tl.ntiles * SPT);
  const T* qb = q + tl.b * a.sq.b + tl.h * a.sq.h;
  const T* db = dout + tl.b * a.sdo.b + tl.h * a.sdo.h;
  const int tid = threadIdx.x & 127;
  // the producer: K's and V's atoms (resident), then each query tile's
  // SPT stages in the consumers' order, each loaded into registers two
  // stages ahead, split into hi and lo as it is stored, then arrived on
  // by each warp
  const T* kb = k + tl.b * a.sk.b + tl.hk * a.sk.h;
  const T* vb = v + tl.b * a.sv.b + tl.hk * a.sv.h;
  const bool vq = aligned4(qb, a.sq.s), vdo = aligned4(db, a.sdo.s);
  const bool vk = aligned4(kb, a.sk.s), vv = aligned4(vb, a.sv.s);
  constexpr int R = NQ + ND;
  // each query tile's first stage also carries its 64 rows' lse and delta
  // (thread p: lse of row p, then delta of row p - 64) into the tile's half
  // of the two-tile buffer
  const long long row_base = ((long long)tl.b * a.hq + tl.h) * a.n_q;
  float* vec = reinterpret_cast<float*>(smem + S::kVecAt);
  // stage sid: sid < 0: resident atom sid + R (K's, then V's); else stage
  // sid % SPT of query tile qt_first + sid / SPT
  auto load = [&](int sid, uint4 (&x)[4], float& lv) {
    if (sid < 0) {
      const int u = sid + R;
      if (u < NQ) get_rows<T>(x, kb, a.sk.s, k0, a.n_k, 32 * u, a.hd, vk, tid);
      else get_rows<T>(x, vb, a.sv.s, k0, a.n_k, 32 * (u - NQ), a.vd, vv, tid);
      return;
    }
    const int q0 = (qt_first + sid / SPT) * kT, pos = sid % SPT;
    if (pos == 0) {
      const int row = q0 + (tid & 63);
      lv = row < a.n_q ? (tid < 64 ? a.lse : a.delta)[row_base + row] : 0.f;
    }
    const int j = pos % S::PH;
    const bool dv_side = j < 2 * ND && (j & 1);
    const int i = j < 2 * ND ? j >> 1 : j - ND;
    if (pos < S::PH) {
      if (dv_side) get_rows<T>(x, db, a.sdo.s, q0, a.n_q, 32 * i, a.vd, vdo, tid);
      else get_rows<T>(x, qb, a.sq.s, q0, a.n_q, 32 * i, a.hd, vq, tid);
    } else {
      // half i / NC of 32 rows, chunk i % NC of 64 columns (NC: the
      // side's chunks)
      const int nc = dv_side ? ND / 2 : NQ / 2;
      const int r0 = q0 + 32 * (i / nc), c0 = 64 * (i % nc);
      if (dv_side) get_cols<T>(x, db, a.sdo.s, r0, a.n_q, c0, a.vd, vdo, tid);
      else get_cols<T>(x, qb, a.sq.s, r0, a.n_q, c0, a.hd, vq, tid);
    }
  };
  auto store = [&](int sid, const uint4 (&x)[4], float lv) {
    if (sid < 0) {
      const int u = sid + R;
      const int hi = u < NQ ? u : NQ + u, lo = u < NQ ? NQ + u : NQ + ND + u;
      if (slow) put_rows<T, true>(smem + hi * kAtom, smem + lo * kAtom, x, tid);
      else put_rows<T, false>(smem + hi * kAtom, smem + lo * kAtom, x, tid);
      if (sid == -1) {
        fence_proxy();
        warp_arrive(resbar);
      }
      return;
    }
    const uint32_t n = n0 + (uint32_t)sid;
    if (n >= (uint32_t)NS) bar_wait(empty(n), (n / NS - 1) & 1);  // the slot's last use is done
    unsigned char* s = smem + S::kRing + (n % NS) * kStage;
    const int pos = sid % SPT, j = pos % S::PH;
    if (pos == 0) vec[128 * ((sid / SPT) & 1) + tid] = lv;
    if (pos < S::PH) {
      if (slow) put_rows<T, true>(s, s + kAtom, x, tid);
      else put_rows<T, false>(s, s + kAtom, x, tid);
    } else {
      if (slow) put_cols<T, true>(s, s + kAtom, x, tid);
      else put_cols<T, false>(s, s + kAtom, x, tid);
    }
    fence_proxy();
    // the full barrier of the stage's consumer (dV's: odd places among the
    // first 2 ND of a phase)
    warp_arrive(bars + 8 * ((j < 2 * ND && (j & 1) ? NS : 0) + n % NS));
  };
  const int end = tl.ntiles * SPT;
  uint4 x[2][4];
  float lv[2] = {0.f, 0.f};
  int ld = -R, st = -R;  // the next stage to load, to store
#pragma unroll
  for (int d = 0; d < 2; ++d) load(ld++, x[d], lv[d]);  // R >= 2 resident atoms
  auto turn = [&](uint4 (&xd)[4], float& lvd) {
    store(st++, xd, lvd);
    if (ld < end) load(ld++, xd, lvd);
    return st < end;
  };
  while (turn(x[0], lv[0]) && turn(x[1], lv[1])) {
  }
  if (!slow && __syncthreads_or(0)) return (int)n_end;
  return -1;
}

// the consumers: the dK warpgroup (threads 0-127) and the dV one (128-255);
// masks: 2 kW words of shared memory
template <typename T, int HD, int VD>
__device__ __forceinline__ int dkdv_consumer(T* __restrict__ dk, T* __restrict__ dv,
                                             const Args& a, unsigned char* smem, uint32_t bars,
                                             uint32_t* masks, uint32_t pass, uint32_t n0,
                                             uint32_t& phase) {
  using S = KV<HD, VD>;
  constexpr int NQ = S::NQ, ND = S::ND, SPT = S::SPT, NS = kKVStages;
  constexpr int NKC = HD / 64, NVC = VD / 64;
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool slow = pass == 1;
  const uint32_t base = smem_u32(smem);
  const uint32_t ring = base + S::kRing;
  const uint32_t resbar = bars + 8 * S::kResBar;
  auto empty = [&](uint32_t n) { return bars + 8 * (S::kEmpty + n % NS); };
  const KVTile tl(a);
  const int h = tl.h, b = tl.b, hk = tl.hk, k0 = tl.k0, n_qt = tl.n_qt;
  const int qt_first = tl.qt_first, qt_last = tl.qt_last, ntiles = tl.ntiles;
  const uint32_t n_end = n0 + (uint32_t)(ntiles * SPT);
  const int role = threadIdx.x >> 7;  // 0: dK, 1: dV
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Pᵀ, then dSᵀ, element r of thread tid's accumulator at r * 128 + tid
  float* swap = reinterpret_cast<float*>(smem + S::kSwapAt);
  // a stage of the ring, once the producer has filled it: this warpgroup's
  // full barrier of the slot, whose phase bit `phase` keeps per slot
  const uint32_t full = bars + 8 * NS * role;
  auto take = [&](uint32_t n) {
    const uint32_t slot = n % NS;
    bar_wait(full + 8 * slot, (phase >> slot) & 1u);
    phase ^= 1u << slot;
    return ring + slot * kStage;
  };
  // the query tile's lse (rows 0-63), then its delta, from the producer
  auto vec = [&](int tile) {
    return reinterpret_cast<const float*>(smem + S::kVecAt) + 128 * (tile & 1);
  };
  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0 and key0 + 8
  float sacc[32], part[32];
  bool bad = false;
  bar_wait(resbar, pass);

  if (role == 0) {
    // dK: Sᵀ = K·Qᵀ, Pᵀ; dSᵀ from the dV warpgroup; dK += dSᵀ·Q
    float acc[NKC][32];
#pragma unroll
    for (int c = 0; c < NKC; ++c) zero(acc[c]);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int q0 = (qt_first + tile) * kT;
      const uint32_t nb = n0 + (uint32_t)(tile * SPT);
      zero(sacc);
      uint32_t prev = 0;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const uint32_t n = nb + S::pos_k(i);
        const uint32_t st = take(n);
        mma_fence();
        ss_atom<kBf16>(sacc, desc(base + i * kAtom), desc(base + (NQ + i) * kAtom),
                              desc(st), desc(st + kAtom));
        mma_commit();
        if (i > 0) {
          mma_wait<1>();
          warp_arrive(empty(prev));
        }
        prev = n;
      }
      mma_wait<0>();
      warp_arrive(empty(prev));
      keep(sacc);
      const float* lq = vec(tile);  // the log-sum-exp of the tile's rows
      // Pᵀ: keys key0 (c < 2) and key0 + 8, queries q0 + 8j + 2t + c % 2.
      // P is NaN at every key, masked ones included, in a row whose softmax
      // is NaN (lse NaN)
      const bool all = all_visible(q0, k0, a.n_q, a.n_k, a.window, a.num_meta);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + 8 * (c >> 1), qi = q0 + 8 * j + 2 * t + (c & 1);
          const float l = lq[8 * j + 2 * t + (c & 1)];
          const bool vis = all || visible(qi, key, a.n_q, a.n_k, a.window, a.num_meta);
          swap[(4 * j + c) * 128 + tid] = vis ? expf(sacc[4 * j + c] * a.scale - l)
                                              : l != l ? l : 0.f;
        }
      named_arrive(1, 256);  // Pᵀ is in the swap
      named_sync(2, 256);    // dSᵀ is
      // dK += dSᵀ·Q, a 32-query half of dSᵀ at a time (its fragments from
      // the swap), 64 columns of dK at a time: stages Qᵀ (half hh, chunk c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t fh[16], fl[16];
        float half[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) half[r] = swap[(16 * hh + r) * 128 + tid];
        split_frags(half, fh, fl, slow);
#pragma unroll
        for (int c = 0; c < NKC; ++c) {
          const uint32_t n = nb + S::PH + S::pos_k(hh * NKC + c);
          const uint32_t st = take(n);
          zero(part);
          mma_fence();
          rs_atom<kBf16>(part, fh, fl, 0, desc(st), desc(st + kAtom));
          mma_commit();
          mma_wait<0>();
          warp_arrive(empty(n));
          keep(part);
          keep(fh);
          keep(fl);
#pragma unroll
          for (int r = 0; r < 32; ++r) acc[c][r] += part[r];
        }
      }
    }
    if (!slow) {
#pragma unroll
      for (int c = 0; c < NKC; ++c) bad |= !all_finite(acc[c]);
      if (__syncthreads_or(bad)) return (int)n_end;
    }
    // the query tiles skipped (every pair masked): 0 · inf where q holds
    // an inf or NaN
    if (tid < kW) {
      uint32_t m = 0u;
      const long long ftile = ((long long)b * a.hq + h) * n_qt;
      for (int qt = 0; qt < n_qt; ++qt)
        if (qt < qt_first || qt > qt_last) m |= a.qflags[(ftile + qt) * kW + tid];
      masks[tid] = m;
    }
    named_sync(3, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= a.n_k) continue;
      T* dkr = dk + b * a.sdk.b + hk * a.sdk.h + (long long)key * a.sdk.s;
      float* dkb = a.dkp + (((long long)b * a.hq + h) * a.n_k + key) * HD;
#pragma unroll
      for (int c = 0; c < NKC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * c + 8 * j + 2 * t;
          float2 val = make_float2(acc[c][4 * j + 2 * r] * a.scale,
                                   acc[c][4 * j + 2 * r + 1] * a.scale);
          if (flagged(masks, d)) val.x = nan_f32();
          if (flagged(masks, d + 1)) val.y = nan_f32();
          if (a.group == 1) {
            if (d < a.hd) store(dkr + d, val.x);
            if (d + 1 < a.hd) store(dkr + d + 1, val.y);
          } else {
            *reinterpret_cast<float2*>(dkb + d) = val;
          }
        }
    }
    return -1;
  }

  // dV: dPᵀ = V·dOᵀ; Pᵀ from the dK warpgroup, dSᵀ back to it; dV += Pᵀ·dO
  float acc[NVC][32];
#pragma unroll
  for (int c = 0; c < NVC; ++c) zero(acc[c]);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = (qt_first + tile) * kT;
    const uint32_t nb = n0 + (uint32_t)(tile * SPT);
    zero(sacc);
    uint32_t prev = 0;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const uint32_t n = nb + S::pos_v(i);
      const uint32_t st = take(n);
      mma_fence();
      ss_atom<kBf16>(sacc, desc(base + (2 * NQ + i) * kAtom),
                            desc(base + (2 * NQ + ND + i) * kAtom), desc(st), desc(st + kAtom));
      mma_commit();
      if (i > 0) {
        mma_wait<1>();
        warp_arrive(empty(prev));
      }
      prev = n;
    }
    mma_wait<0>();
    warp_arrive(empty(prev));
    keep(sacc);
    const float* dl = vec(tile) + 64;  // delta of the tile's rows
    // dSᵀ = Pᵀ ∘ (dPᵀ - delta) on the visible pairs, exactly 0 elsewhere
    const bool all = all_visible(q0, k0, a.n_q, a.n_k, a.window, a.num_meta);
    named_sync(1, 256);  // Pᵀ is in the swap
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * j + c;
        const int key = key0 + 8 * (c >> 1), qi = q0 + 8 * j + 2 * t + (c & 1);
        const bool vis = all || visible(qi, key, a.n_q, a.n_k, a.window, a.num_meta);
        const float p = swap[r * 128 + tid];
        swap[r * 128 + tid] = vis ? p * (sacc[r] - dl[8 * j + 2 * t + (c & 1)]) : 0.f;
        sacc[r] = p;
      }
    named_arrive(2, 256);  // dSᵀ is in the swap
    // dV += Pᵀ·dO, a 32-query half of Pᵀ at a time, 64 columns of dV at a
    // time: stages dOᵀ (half hh, chunk c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t fh[16], fl[16];
      float half[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) half[r] = sacc[16 * hh + r];
      split_frags(half, fh, fl, slow);
#pragma unroll
      for (int c = 0; c < NVC; ++c) {
        const uint32_t n = nb + S::PH + S::pos_v(hh * NVC + c);
        const uint32_t st = take(n);
        zero(part);
        mma_fence();
        rs_atom<kBf16>(part, fh, fl, 0, desc(st), desc(st + kAtom));
        mma_commit();
        mma_wait<0>();
        warp_arrive(empty(n));
        keep(part);
        keep(fh);
        keep(fl);
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[c][r] += part[r];
      }
    }
  }
  if (!slow) {
#pragma unroll
    for (int c = 0; c < NVC; ++c) bad |= !all_finite(acc[c]);
    if (__syncthreads_or(bad)) return (int)n_end;
  }
  // the query tiles skipped: 0 · inf where dO holds an inf or NaN (every
  // column of a tile with a NaN softmax row)
  uint32_t* mv = masks + kW;
  if (tid < kW) {
    uint32_t m = 0u;
    const long long ftile = ((long long)b * a.hq + h) * n_qt;
    for (int qt = 0; qt < n_qt; ++qt)
      if (qt < qt_first || qt > qt_last) m |= a.dflags[(ftile + qt) * kW + tid];
    mv[tid] = m;
  }
  named_sync(4, 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.n_k) continue;
    T* dvr = dv + b * a.sdv.b + hk * a.sdv.h + (long long)key * a.sdv.s;
    float* dvb = a.dvp + (((long long)b * a.hq + h) * a.n_k + key) * VD;
#pragma unroll
    for (int c = 0; c < NVC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t;
        float2 val = make_float2(acc[c][4 * j + 2 * r], acc[c][4 * j + 2 * r + 1]);
        if (flagged(mv, d)) val.x = nan_f32();
        if (flagged(mv, d + 1)) val.y = nan_f32();
        if (a.group == 1) {
          if (d < a.vd) store(dvr + d, val.x);
          if (d + 1 < a.vd) store(dvr + d + 1, val.y);
        } else {
          *reinterpret_cast<float2*>(dvb + d) = val;
        }
      }
  }
  return -1;
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(384, 1)
flash_bwd_vd_dkdv_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               T* __restrict__ dk, T* __restrict__ dv,
                               const __grid_constant__ Args a) {
  constexpr int NB = KV<HD, VD>::kBars;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[NB];
  __shared__ uint32_t masks[2 * kW];
  unsigned char* tiles = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t bu = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) bar_init(bu + 8 * i, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the fast split's pass, then, for a block whose result holds an inf or
  // a NaN, the full split's, in one inlined body (a call out of line
  // would make ptxas serialize every wgmma of the kernel); each role runs
  // its own passes
  uint32_t n0 = 0;
  if (threadIdx.x >= 256) {
    for (uint32_t pass = 0;; ++pass) {
      const int n = dkdv_producer<T, HD, VD>(q, k, v, dout, a, tiles, bu, pass, n0);
      if (n < 0) break;
      n0 = (uint32_t)n;
    }
  } else {
    uint32_t phase = 0;  // the parity of each slot's next full-barrier phase
    for (uint32_t pass = 0;; ++pass) {
      const int n = dkdv_consumer<T, HD, VD>(dk, dv, a, tiles, bu, masks, pass, n0, phase);
      if (n < 0) break;
      n0 = (uint32_t)n;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dQ of one 64-row query tile of query head h
// ---------------------------------------------------------------------------

// The dQ pass's shape: a key tile is SPT ring stages: NQ atoms of K as
// stored, ND of V, then NQ stages of Kᵀ in (64-column chunk, 32-key half)
template <int HD, int VD>
struct QP {
  static_assert(HD % 64 == 0 && VD % 64 == 0, "whole 64-column chunks");
  static constexpr int NQ = HD / 32, ND = VD / 32;
  static constexpr int SPT = 2 * NQ + ND;
  static constexpr int kRing = 2 * (NQ + ND) * kAtom;
  static constexpr int kSmem = kRing + kQStages * kStage + 1024;
};

template <typename T, int HD, int VD>
__device__ __forceinline__ int dq_block(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        T* __restrict__ dq, const Args& a, unsigned char* smem,
                                        uint32_t bars, uint32_t* masks, uint32_t pass,
                                        uint32_t n0) {
  using S = QP<HD, VD>;
  constexpr int NQ = S::NQ, ND = S::ND, SPT = S::SPT, NS = kQStages;
  constexpr int NKC = HD / 64;
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool slow = pass == 1;
  const uint32_t base = smem_u32(smem);
  const uint32_t ring = base + S::kRing;
  const uint32_t resbar = bars + 16 * NS;
  auto full = [&](uint32_t n) { return bars + 8 * (n % NS); };
  auto empty = [&](uint32_t n) { return bars + 8 * (NS + n % NS); };

  const int n_qt = (a.n_q + kT - 1) / kT;
  int idx = blockIdx.x;
  const int h = idx % a.hq;
  idx /= a.hq;
  const int b = idx % a.batch;
  const int qt = n_qt - 1 - idx / a.batch;  // most keys first
  const int hk = h / a.group;
  const int q0 = qt * kT;
  const T* kb = k + b * a.sk.b + hk * a.sk.h;
  const T* vb = v + b * a.sv.b + hk * a.sv.h;
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
  const int tid = threadIdx.x & 127;

  if (threadIdx.x >= 128) {
    // the producer: Q's and dO's atoms (resident), then each visited key
    // tile's SPT stages, loaded two stages ahead as in the dK/dV pass
    const T* qb = q + b * a.sq.b + h * a.sq.h;
    const T* db = dout + b * a.sdo.b + h * a.sdo.h;
    const bool vq = aligned4(qb, a.sq.s), vdo = aligned4(db, a.sdo.s);
    const bool vk = aligned4(kb, a.sk.s), vv = aligned4(vb, a.sv.s);
    constexpr int R = NQ + ND;
    // a stage: kt == -2: resident atom pos (Q's, then dO's); kt == -1: done;
    // else stage pos of key tile kt
    struct Cursor {
      int kt, pos;
    };
    auto advance = [&](Cursor& c) {
      if (++c.pos < (c.kt == -2 ? R : SPT)) return;
      c.kt = next_tile(c.kt == -2 ? -1 : c.kt);
      c.pos = 0;
    };
    auto load = [&](const Cursor& c, uint4 (&x)[4]) {
      if (c.kt == -2) {
        if (c.pos < NQ) get_rows<T>(x, qb, a.sq.s, q0, a.n_q, 32 * c.pos, a.hd, vq, tid);
        else get_rows<T>(x, db, a.sdo.s, q0, a.n_q, 32 * (c.pos - NQ), a.vd, vdo, tid);
        return;
      }
      const int k0 = c.kt * kT;
      if (c.pos < NQ) {
        get_rows<T>(x, kb, a.sk.s, k0, a.n_k, 32 * c.pos, a.hd, vk, tid);
      } else if (c.pos < NQ + ND) {
        get_rows<T>(x, vb, a.sv.s, k0, a.n_k, 32 * (c.pos - NQ), a.vd, vv, tid);
      } else {
        const int i = c.pos - NQ - ND;  // chunk i / 2, half i % 2
        get_cols<T>(x, kb, a.sk.s, k0 + 32 * (i & 1), a.n_k, 64 * (i >> 1), a.hd, vk, tid);
      }
    };
    uint32_t n = n0;
    auto store = [&](const Cursor& c, const uint4 (&x)[4]) {
      if (c.kt == -2) {
        const int hi = c.pos < NQ ? c.pos : NQ + c.pos;
        const int lo = c.pos < NQ ? NQ + c.pos : NQ + ND + c.pos;
        if (slow) put_rows<T, true>(smem + hi * kAtom, smem + lo * kAtom, x, tid);
        else put_rows<T, false>(smem + hi * kAtom, smem + lo * kAtom, x, tid);
        if (c.pos == R - 1) {
          fence_proxy();
          warp_arrive(resbar);
        }
        return;
      }
      if (n >= (uint32_t)NS) bar_wait(empty(n), (n / NS - 1) & 1);
      unsigned char* s = smem + S::kRing + (n % NS) * kStage;
      if (c.pos < NQ + ND) {
        if (slow) put_rows<T, true>(s, s + kAtom, x, tid);
        else put_rows<T, false>(s, s + kAtom, x, tid);
      } else {
        if (slow) put_cols<T, true>(s, s + kAtom, x, tid);
        else put_cols<T, false>(s, s + kAtom, x, tid);
      }
      fence_proxy();
      warp_arrive(full(n));
      ++n;
    };
    uint4 x[2][4];
    Cursor ld{-2, 0}, st{-2, 0};  // the next stage to load, to store
#pragma unroll
    for (int d = 0; d < 2; ++d) {  // R >= 2 resident atoms
      load(ld, x[d]);
      advance(ld);
    }
    auto turn = [&](uint4 (&xd)[4]) {
      store(st, xd);
      advance(st);
      if (ld.kt != -1) {
        load(ld, xd);
        advance(ld);
      }
      return st.kt != -1;
    };
    while (turn(x[0]) && turn(x[1])) {
    }
    if (!slow && __syncthreads_or(0)) return (int)n;
    return -1;
  }

  // the consumer: S = Q·Kᵀ and dP = dO·Vᵀ (both operands in shared
  // memory), dS in registers, dQ += dS·K (A from registers)
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row_base = ((long long)b * a.hq + h) * a.n_q;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0 and row0 + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    lse_r[r] = i < a.n_q ? a.lse[row_base + i] : 0.f;
    del_r[r] = i < a.n_q ? a.delta[row_base + i] : 0.f;
  }
  auto take = [&](uint32_t n) {
    bar_wait(full(n), (n / NS) & 1);
    return ring + (n % NS) * kStage;
  };
  float acc[NKC][32], s[32], dp[32], part[32];
  uint32_t fh[32], fl[32];
#pragma unroll
  for (int c = 0; c < NKC; ++c) zero(acc[c]);
  uint32_t n = n0;
  bar_wait(resbar, pass);
  for (int kt = next_tile(-1); kt >= 0; kt = next_tile(kt)) {
    const int k0 = kt * kT;
    zero(s);
    zero(dp);
    uint32_t prev = 0;
#pragma unroll
    for (int i = 0; i < NQ + ND; ++i) {
      const uint32_t st = take(n);
      mma_fence();
      if (i < NQ)
        ss_atom<kBf16>(s, desc(base + i * kAtom), desc(base + (NQ + i) * kAtom), desc(st),
                       desc(st + kAtom));
      else
        ss_atom<kBf16>(dp, desc(base + (NQ + i) * kAtom), desc(base + (NQ + ND + i) * kAtom),
                       desc(st), desc(st + kAtom));
      mma_commit();
      if (i > 0) {
        mma_wait<1>();
        warp_arrive(empty(prev));
      }
      prev = n++;
    }
    mma_wait<0>();
    warp_arrive(empty(prev));
    keep(s);
    keep(dp);
    // dS = P ∘ (dP - delta) on the visible pairs, exactly 0 elsewhere:
    // rows row0 (c < 2) and row0 + 8, keys k0 + 8j + 2t + c % 2
    const bool all = all_visible(q0, k0, a.n_q, a.n_k, a.window, a.num_meta);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * j + c;
        const int i = row0 + 8 * (c >> 1), key = k0 + 8 * j + 2 * t + (c & 1);
        const bool vis = all || visible(i, key, a.n_q, a.n_k, a.window, a.num_meta);
        const float p = vis ? expf(s[r] * a.scale - lse_r[c >> 1]) : 0.f;
        s[r] = vis ? p * (dp[r] - del_r[c >> 1]) : 0.f;
      }
    split_frags(s, fh, fl, slow);
    // dQ += dS·K, 64 columns at a time: stages Kᵀ (chunk c, half hh)
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      zero(part);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t st = take(n);
        mma_fence();
        rs_atom<kBf16>(part, fh, fl, 4 * hh, desc(st), desc(st + kAtom));
        mma_commit();
        if (hh == 1) {
          mma_wait<1>();
          warp_arrive(empty(prev));
        }
        prev = n++;
      }
      mma_wait<0>();
      warp_arrive(empty(prev));
      keep(part);
      keep(fh);
      keep(fl);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[c][r] += part[r];
    }
  }
  if (!slow) {
    bool bad = false;
#pragma unroll
    for (int c = 0; c < NKC; ++c) bad |= !all_finite(acc[c]);
    if (__syncthreads_or(bad)) return (int)n;
  }

  // the key tiles skipped (every pair masked): 0 · inf where k holds an inf
  // or NaN
  const int n_kt = (a.n_k + kT - 1) / kT;
  if (tid < kW) {
    uint32_t m = 0u;
    const long long ftile = ((long long)b * (a.hq / a.group) + hk) * n_kt;
    for (int j = 0; j < n_kt; ++j)
      if (skipped(j)) m |= a.kflags[(ftile + j) * kW + tid];
    masks[tid] = m;
  }
  named_sync(1, 128);
  T* dqb = dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= a.n_q) continue;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t;
        if (d < a.hd)
          store(dqb + (long long)i * a.sdq.s + d,
                flagged(masks, d) ? nan_f32() : acc[c][4 * j + 2 * r] * a.scale);
        if (d + 1 < a.hd)
          store(dqb + (long long)i * a.sdq.s + d + 1,
                flagged(masks, d + 1) ? nan_f32() : acc[c][4 * j + 2 * r + 1] * a.scale);
      }
  }
  return -1;
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(256, 1)
flash_bwd_vd_dq_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             T* __restrict__ dq, const __grid_constant__ Args a) {
  constexpr int NS = kQStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];  // full[NS], empty[NS], Q and dO's
  __shared__ uint32_t masks[kW];
  unsigned char* tiles = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t bu = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= 2 * NS; ++i) bar_init(bu + 8 * i, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t n0 = 0;
  for (uint32_t pass = 0;; ++pass) {
    const int n = dq_block<T, HD, VD>(q, k, v, dout, dq, a, tiles, bu, masks, pass, n0);
    if (n < 0) break;
    n0 = (uint32_t)n;
  }
}

template <typename T, int HD, int VD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, Args a, uint32_t* qflags,
                   uint32_t* dflags, uint32_t* kflags, float* delta, cudaStream_t stream) {
  const int b1 = KV<HD, VD>::kSmem, b2 = QP<HD, VD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_vd_dkdv_wgmma_kernel<T, HD, VD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_vd_dq_wgmma_kernel<T, HD, VD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, b2);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.n_q + kT - 1) / kT, n_kt = (a.n_k + kT - 1) / kT;
  const int hkv = a.hq / a.group;
  flash_bwd_vd_prep_kernel<T><<<dim3(n_qt > n_kt ? n_qt : n_kt, a.hq + hkv, a.batch), kThreads,
                                0, stream>>>((const T*)q, (const T*)k, (const T*)o,
                                             (const T*)dout, a, delta, qflags, dflags, kflags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_vd_dkdv_wgmma_kernel<T, HD, VD><<<n_kt * a.hq * a.batch, 384, b1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dk, (T*)dv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.group > 1) {
    const long long total = (long long)a.batch * hkv * a.n_k * HD;
    flash_bwd_vd_reduce_kernel<T, HD, VD>
        <<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
           stream>>>((T*)dk, (T*)dv, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  flash_bwd_vd_dq_wgmma_kernel<T, HD, VD><<<n_qt * a.hq * a.batch, 256, b2, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, a);
  return cudaGetLastError();
}

// (HD, VD): (64, 64) where hd and vd fit, else (192, 128) (zero-padded
// columns; hd <= 192, vd <= 128)
template <typename T>
cudaError_t launch_dims(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, Args a,
                        uint32_t* qflags, uint32_t* dflags, uint32_t* kflags, float* delta,
                        cudaStream_t stream) {
  if (a.vd > 128 || a.hd > 192) return cudaErrorInvalidValue;  // the wrapper raises before
  auto run = a.hd <= 64 && a.vd <= 64 ? launch<T, 64, 64> : launch<T, 192, 128>;
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
// masks, dK and dV, their sum over the group when group > 1, dQ); returns
// the first failure of cudaGetLastError().
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
