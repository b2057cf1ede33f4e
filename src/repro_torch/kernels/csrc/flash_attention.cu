// flash_attention — causal online-softmax attention forward, hand-written
// for Hopper (sm_90a).
//
//   o[b, h, i] = Σ_j softmax_j(q[b, h, i] · k[b, h/G, j] / √hd) v[b, h/G, j]
//
// over the keys j a query i sees: j <= i, and, when window > 0, i - j <
// window or j < num_meta (the pinned meta tokens of models/attention.py
// mask_block). GQA: query head h reads kv head h / G. q [B, Hq, Sq, hd],
// k [B, Hkv, T, hd], v [B, Hkv, T, vd] and o [B, Hq, Sq, vd] (vd = hd, or
// v's own head_dim: MLA's q/k 192 and v 128), f32 or bf16, read and
// written through their strides (only the head_dim stride must be 1), so
// the model's [B, S, H, hd] projections are read in place; f32 scores,
// running max, sum and accumulator; the output in q's dtype.
//
// Replaces: src/repro/kernels/flash_attention.py · flash_attention (Pallas
// _flash_kernel: grid (B, Hq, Sq/bq, Tk/bk), the kv axis sequential, the
// running (m, l, acc) in VMEM scratch). With num_meta = 0 it is that
// kernel's contract; num_meta > 0 adds the meta-token term. When a
// gradient is needed (hd = vd <= 256, or vd != hd on the wgmma kernel
// below at hd <= 192) it also writes each row's log-sum-exp of the scaled
// scores, m + log l, for flash_attention_bwd.cu (flash_attention_bwd_256.cu
// above hd 128, flash_attention_bwd_vd.cu at vd != hd), in an
// instantiation of its own: serving runs the code it
// ran before (a run-time test of a null lse in the shared code cost the
// hd-64 forward 1-2 % in an A/B call on the card).
//
// What bounds it on the card: operations. At Hymba's prefill (B 4, Hq 25,
// S 2048, hd 64, window 1024, 128 meta tokens) the visible part of the
// score matrix needs 4·hd flops per visible (i, j) pair, about 43 GFLOP per
// call over 126 MB of q, k, v and o. Both products run on the TF32 tensor
// cores as split-f32 (tf32x3.cuh): three TF32 products per f32 product,
// 3 x 43.4 GFLOP at 495 TFLOP/s = 0.263 ms, against 0.038 ms for the bytes.
//
// What the design does about it (FlashAttention-2 on mma.sync; vd = hd <=
// 64, Hymba's and musicgen's 64; the wider heads have the wgmma kernels
// below):
// - One block of 4 warps per (b, h, 64-row query tile), the tiles with
//   the most keys launched first; each warp owns 16 query rows.
// - Q is staged once; each warp keeps its Q A-fragments in registers,
//   split into TF32 hi/lo (64 registers at hd = 64).
// - K and V tiles (64 keys) are double-buffered with cp.async: the next
//   visited tile's copies are in flight while this one is computed, one
//   barrier a tile. Each 16-byte chunk takes the widest copy its source
//   allows (cp_async.cuh), since the wrapper accepts any row stride. Both
//   are stored row-major: K is exactly the "col" B operand of S = Q·Kᵀ
//   (b0 = K[g][t]) and V that of O += P·V; pitches of hd + 4 (f32) and
//   hd + 8 (bf16) keep the fragment reads on distinct banks.
// - The online softmax runs on the S accumulator fragments: a row lives in
//   one lane quad, so its max and sum take two __shfl_xor_sync each.
// - P never leaves registers. The C fragment holds keys (2t, 2t + 1) of
//   rows g and g + 8, which is the A fragment of P·V if A's columns t and
//   t + 4 stand for keys 2t and 2t + 1; V's B fragment reads the same keys
//   (b0 = V[2t][g], b1 = V[2t + 1][g]), so no shuffle moves P. P is split
//   into hi/lo in registers.
// - bf16 inputs are exact in TF32: S = Q·Kᵀ takes one product, P·V two
//   (only P has a lo part). The three terms of each product go out term by
//   term over the warp's eight accumulators, so no product waits on the
//   one before it.
// - A warp skips a K tile none of its 16 rows sees, and a tile all its
//   rows see wholly takes no mask.
// - Everything else is the JAX kernel's arithmetic: masked scores are the
//   finite -1e30 of the TPU kernel, never -inf (a row's first visited tile
//   may be fully masked, and the running state washes it out when a
//   visible key arrives); expf, not __expf; the 1e-30 floor on the
//   denominator. Tiles above the diagonal and those wholly outside the
//   window that hold no meta token are skipped; a ragged last query tile
//   is masked and writes no padded row.
// - Non-finite values: the products run on the fast split (tf32x3.cuh),
//   which turns an inf or NaN input into an inf or NaN result; a block
//   whose result holds one is taken again on the full split, whose
//   products follow IEEE (flash_block_full, out of line so that the fast
//   path keeps its registers).
// - Non-finite values in keys a row does not see. The JAX kernel visits
//   every key tile: a masked key has p = 0, and 0 · v[k, e] is NaN where
//   v[k, e] is inf or NaN, so column e of every row that key is masked for
//   comes out NaN (masked scores are replaced by -1e30, so a non-finite k
//   or q never propagates through a masked key). Inside the tiles a warp
//   computes, the arithmetic gives this NaN itself. The tiles it skips
//   (above the diagonal, outside the window, or with no key any of its 16
//   rows sees) take two small launches around the attention, which itself
//   is unchanged: flash_fwd_kernel_vflags, one block per (b, kv head,
//   64-key tile), reads V once (8 % of the call's bytes at Hymba's shape)
//   and writes a bitmask over the hd columns of "holds an inf or NaN";
//   after the attention, flash_fwd_kernel_nanfix ORs, for each warp of
//   each query tile, the masks of the tiles that warp skipped and writes
//   NaN into those columns of its 16 rows, for every query head of the
//   GQA group. Finite input pays the two launches (reading V once and the
//   masks) and no store; no skipped tile is visited. (Taking the OR and
//   the NaN inside the attention kernel made it 3-6 % slower at its
//   255-register limit.)
//
// Head dims in (64, 128] with v's as wide (the dense models' 128: DBRX,
// nemotron, yi, chameleon, qwen2; others zero-padded to 128):
// flash_fwd_kernel_wgmma128, on Hopper's warpgroup products. At
// nemotron-4-15b's prefill (B 4, GQA 48/8, S 2048, causal) the two products
// take 2.1e11 flops, 1.25 ms at the split-f32 rate, against 0.14 ms for its
// 470 MB: operations bound it. (On the mma.sync design above it ran at
// 10 % of that: 169 KB of Q and two K/V buffers left one block of 4 warps
// an SM, and Q's fragments were read again from shared memory for every K
// tile.) It is the 256 design below at half the width, with the
// rows split instead of the columns:
// - Tile: a block per (128-row query tile, head), most keys first, 256
//   threads: two consumer warpgroups, warpgroup w owning rows 64w ..
//   64w + 63 and all of O's 128 columns (64 f32 a thread) and all of S's
//   k8 steps: no exchange of scores, and each K and Vᵀ stage serves 128
//   query rows, which halves the traffic from the L2 per row against
//   64-row tiles.
// - Operands: each warpgroup's Q (64 KB hi and lo) stays resident; K and
//   Vᵀ come from their images (flash_fwd_kernel_image128: four 16 KB
//   stages a 64-key tile each) through one ring of six 16 KB slots that
//   both warpgroups read in the same order (PairFeed, wgmma.cuh): a slot's
//   empty mbarrier counts both warpgroups' 8 warps, and warpgroup 0's
//   first thread lands each stage as soon as both have freed its slot,
//   testing the barrier at every free of its own and waiting only before
//   it takes a stage that has not landed. 128 + 96 KB + the alignment:
//   one block an SM.
// - Order, arithmetic and the non-finite rules as at 256 below. A
//   warpgroup whose 64 rows see no key of a visited tile (warpgroup 0 on
//   the diagonal's second tile) computes it all the same: its masked
//   scores give p = 0, and 0 · inf the NaN that the JAX kernel's visit of
//   every tile gives.
//
// Head dims above 128 with v's as wide, up to 256 (gemma-2b's 256; others
// zero-padded to 256): flash_fwd_kernel_wgmma256, on Hopper's warpgroup
// products. At gemma-2b's prefill (B 4, MQA 8/1, S 2048, causal) the two
// products take 6.9e10 flops, 0.42 ms at the split-f32 rate, against 0.05
// ms for its 151 MB: operations bound it.
// - Tile: a block per (64-row query tile, head), most keys first, 256
//   threads: two consumer warpgroups, warpgroup w owning O's columns 128w
//   .. 128w + 127 (64 f32 a thread, as flash_fwd_kernel_wgmma's one
//   warpgroup owns vd <= 128) and the k8 steps of S = Q·Kᵀ over q/k's
//   columns 128w ..: each computes a partial of S, and the two are summed
//   through 32 KB of shared memory in one order (p0 + p1 in both, the same
//   bits), so both run the same online softmax and hold the same P. The
//   scores are computed once per (query tile, key tile).
// - Operands: Q stays resident for the block's life, hi and lo (128 KB),
//   each warpgroup loading and splitting its own 128 columns. K and Vᵀ are
//   split once per call by flash_fwd_kernel_image256 into "images": the
//   exact bytes of the 16 KB stages the products read (an atom of TF32 hi
//   parts and one of lo, 128-byte swizzled, K as stored, Vᵀ transposed in
//   the key order of P's A fragments; full split, tf32x3::split), per kv
//   head, so MQA's 8 query heads read one copy. Each warpgroup has its own
//   ring of two slots, which its first thread fills by bulk copies (the
//   copy engine, cp.async.bulk onto the slot's full mbarrier) as the
//   warpgroup frees them: no thread loads or splits K or V, and no
//   producer warp holds registers (256 threads: 255 registers each).
// - Order per warpgroup: the next tile's S partial, then this tile's P·V
//   behind it; the exchange and the softmax run under P·V's last group.
// - The rest is the kernels' arithmetic above: the finite -1e30 mask,
//   expf, the 1e-30 floor, the window and meta tokens' tile skipping, GQA,
//   ragged tiles, the full-split pass of a block whose result holds an inf
//   or a NaN (Q and P split again; the images are the full split either
//   way), V's flags and the NaN of skipped tiles around it.
// Beyond 256, and at vd > 128 with vd != hd ((320, 256), hd 512),
// flash_fwd_kernel_wide splits O's columns into slices of kCW = 128, one
// block per (query tile, head, slice). Every slice's block computes the
// full scores Q·Kᵀ over all of hd, in kKC = 64-column chunks staged in a
// two-slot cp.async ring of (Q chunk, K chunk) pairs, so every slice runs
// the same score arithmetic and gets the same m and l; then P·V for its
// own 128 columns of V (staged once a tile, while the chunks are
// computed). Shared memory: 103 KB in f32, two blocks an SM; 52 KB in
// bf16. The scores are recomputed once per slice (hd/128 times). V's
// non-finite flags are one 128-column mask per slice.
//
// V's head_dim apart from Q's and K's, vd <= 128 and hd <= 256
// (DeepSeek-V2's MLA prefill: q/k 192 = 128 nope + 64 rope, v 128):
// flash_fwd_kernel_wgmma, on Hopper's warpgroup products. At DeepSeek's
// prefill (B 4, 128 heads, S 2048, causal) the two products take
// 4·128·(2048·2049/2)·2·(192 + 128) = 6.9e11 flops, 4.2 ms at the split-f32
// rate (165 TFLOP/s) against 0.8 ms for its 2.7 GB of q, k, v and o at
// 3.35 TB/s: operations bound it. (The wide kernel above ran it at 15 % of
// that bound on mma.sync: Q restaged and resplit beside every K chunk,
// every warp splitting the same K and V fragments, one chunk in flight.)
// - Tile: a block per (64-row query tile, head), most keys first, 256
//   threads: a consumer warpgroup (threads 0-127) and a producer
//   warpgroup (128-255). Key tiles of 64.
// - Shared memory, 224 KB, one block an SM: Q stays resident for the
//   block's life as hi and lo parts, hd/64 chunks of 2 x 16 KB (96 KB at
//   hd 192); the rest is a ring of NS = 7 - hd/64 stages of 32 KB (4 at
//   hd 192), each a 64-key x 64-column chunk of K or a 128 x 32-key half
//   of Vᵀ, hi and lo. A key tile is hd/64 + 2 stages, so the ring holds
//   less than one: the consumer frees a stage as soon as its products are
//   done. Each stage has a full and an empty mbarrier, one arrival per
//   warp; the consumer waits once a stage and never on __syncthreads().
//   (A 128-row query tile on two consumer warpgroups would share each K/V
//   tile between twice the rows, but its Q alone, hi and lo, is 192 KB.)
// - Every operand is split once, by the producer, as it is stored: hi is
//   the f32 truncated to the 19 bits the tensor cores read, lo = x - hi
//   (exact in f32), both in shared memory, so no warp splits a fragment.
//   The producer reads global memory into registers two stages ahead of
//   its stores; it keeps the raw bits and widens and splits them as it
//   stores them in the 128-byte-swizzled K-major layout wgmma reads (a
//   conversion right after each load would stall the warp on it), then
//   fences the async proxy and arrives. 16-byte (f32) or 8-byte (bf16)
//   loads where a stage lies inside the operand and its rows are aligned;
//   element by element otherwise, zero past the edges (the wrapper takes
//   any row stride).
// - S = Q·Kᵀ: m64n64k8 TF32 wgmma with both operands in shared memory, both
//   K-major as stored; per k8 step lo·hi, hi·lo, hi·hi into one f32
//   accumulator, chunk by chunk over hd, each chunk's stage released one
//   group later. O += P·V: m64n128k8 with P from registers and Vᵀ from
//   shared memory. tf32 wgmma takes only K-major operands from shared
//   memory, so the producer stores V transposed, [vd][keys]; inside each
//   group of 8 keys, position t holds key 2t and position t + 4 key
//   2t + 1, the order in which the S accumulator (keys 2t, 2t + 1 of rows
//   g, g + 8) hands P over as an A fragment (columns t, t + 4). P is split
//   into hi/lo in registers. Columns past hd, rows past vd and keys past T
//   are stored as zeros.
// - Order: the next tile's S, then this tile's P·V right behind it on the
//   tensor cores; once S has landed, its softmax runs while P·V does. The
//   producer fills the ring in that order (K of tile j + 1 before V of j).
// - Registers: O (64 f32 a thread: 64 rows x 128 columns over 128
//   threads), S (32), P's hi and lo (64); 249-255 a thread, no spill
//   (ptxas, `scripts/torch_kernel_ab.py --set ptxas`). ptxas serializes
//   every wgmma of the kernel if any path could touch a group's registers
//   before its wait (an out-of-line call, or two branches on one condition
//   around an issue and its wait): each branch here issues and waits for
//   its own groups, and the full split's pass is the same inlined body.
// - What bounds it: the function, operations (above); the kernel, its
//   producer and shared memory. Per 64 x 64 tile S reads 288 KB of
//   operands from shared memory (m64n64k8 with both operands there runs at
//   the 128 bytes a clock shared memory gives), P·V 96 KB, the producer's
//   stores 160 KB: 2.4 us of an SM against 2.1 for the tensor cores. On
//   an H100 80GB HBM3 at 700 W (scripts/torch_flash_variants.py) the
//   consumer alone takes 7.7 ms at DeepSeek's prefill, the producer
//   alone 10.2, the kernel 15.6: the producer sets the time, and the two
//   overlap only in part.
// - The arithmetic otherwise is the kernels' above: the finite -1e30
//   mask, expf, the 1e-30 floor, the tile skipping of the window and the
//   meta tokens, GQA, ragged tiles; bf16 is exact in TF32 (S one product,
//   P·V two). The warpgroup computes a key tile for all its 64 rows, so
//   the per-warp skipping above has no counterpart here; a row that sees
//   no key of a tile gets p = 0, or weights the running state washes out
//   exactly. Non-finite values: the fast split gives an inf or NaN a NaN
//   lo, so the result is never silently finite; a block whose result
//   holds one is taken again on the full split (tf32x3::split,
//   tf32x3::exact) in the same launch, its producer and consumer going on
//   through the same ring. The two launches around the attention (V's
//   flags, the NaN of skipped tiles) are the same as for the kernels
//   above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key / value rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kCW = 128;       // O slice at hd > 128
constexpr int kKC = 64;        // column chunk of the scores at hd > 128
constexpr float kNegInf = -1e30f;

// element strides of one [B, H, S, hd] operand (the hd stride is 1)
struct Strides {
  long long b, h, s;
};

// shared row pitch in elements: hd + 4 words (f32) / hd + 8 halves (bf16)
template <typename T, int HD> __host__ __device__ constexpr int pitch() {
  return HD + 16 / (int)sizeof(T);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)pitch<T, HD>() * (kBQ + 4 * kBK);  // Q, K x 2, V x 2
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T nan_as();
template <> __device__ __forceinline__ float nan_as<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ __nv_bfloat16 nan_as<__nv_bfloat16>() {
  return __float2bfloat16_rn(__int_as_float(0x7fc00000));
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

template <typename T> __device__ __forceinline__ void store2(T* dst, float v0, float v1,
                                                             bool both);
template <> __device__ __forceinline__ void store2<float>(float* dst, float v0, float v1,
                                                          bool both) {
  if (both && ((uintptr_t)dst & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (both) dst[1] = v1;
  }
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float v0,
                                                                  float v1, bool both) {
  if (both && ((uintptr_t)dst & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (both) dst[1] = __float2bfloat16_rn(v1);
  }
}

// stage rows row0 .. row0 + 63 (of n) of one head, hd columns, zero-padded
template <typename T, int HD>
__device__ __forceinline__ void copy_tile(T* dst, const T* base, long long stride, int row0,
                                          int n, int hd) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;             // chunks per row
  constexpr int PT = pitch<T, HD>();
#pragma unroll
  for (int i = 0; i < kBK * CPR / kThreads; ++i) {
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

// The block's work and its store, on the fast split (kSlow false) or the
// full one (tf32x3.cuh). On the fast split a result that holds an inf or a
// NaN is not stored: it returns true, and the kernel takes the block again
// on the full split. kLse: also store each row's log-sum-exp (a separate
// instantiation, so that serving runs the code it ran without it).
template <typename T, int HD, bool kSlow, bool kLse>
__device__ __forceinline__ bool flash_block(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, T* __restrict__ o,
                                            float* __restrict__ lse, Strides sq, Strides sk,
                                            Strides sv, Strides so, int group, int n_q, int n_k,
                                            int hd, float scale, int window, int num_meta) {
  constexpr bool kBf16 = sizeof(T) == 2;  // q, k, v exact in TF32
  constexpr int PT = pitch<T, HD>();
  constexpr int KS = HD / 8;              // k8 steps of S = Q·Kᵀ
  constexpr int NT = HD / 8;              // n8 tiles of O
  static_assert(HD <= 64, "hd in (64, 256] runs on the wgmma kernels below");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);     // [kBQ][PT]
  T* Ks = Qs + kBQ * PT;                  // [2][kBK][PT]
  T* Vs = Ks + 2 * kBK * PT;              // [2][kBK][PT]

  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  const int q_last = min(q0 + kBQ, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  // the next K/V tile after kt that some row of this tile sees (-1: none);
  // a tile is skipped when it lies outside the window and holds no meta token
  auto next_tile = [&](int kt) {
    for (++kt; kt <= kt_last; ++kt) {
      const int k0 = kt * kBK;
      if (!(window > 0 && k0 >= num_meta && q0 - (k0 + kBK - 1) >= window)) return kt;
    }
    return -1;
  };

  copy_tile<T, HD>(Qs, qb, sq.s, q0, n_q, hd);
  cp_async::commit();

  int kt = next_tile(-1);
  if (kt >= 0) {
    copy_tile<T, HD>(Ks, kb, sk.s, kt * kBK, n_k, hd);
    copy_tile<T, HD>(Vs, vb, sv.s, kt * kBK, n_k, hd);
  }
  cp_async::commit();
  cp_async::wait<1>();
  __syncthreads();  // Q staged

  // Q A-fragment of k8 step ks: rows (g, g + 8), columns (t, t + 4)
  auto load_q = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int base = (qr + g) * PT + ks * 8 + t;
    frag<kSlow>(Qs, base, hi[0], lo[0]);
    frag<kSlow>(Qs, base + 8 * PT, hi[1], lo[1]);
    frag<kSlow>(Qs, base + 4, hi[2], lo[2]);
    frag<kSlow>(Qs, base + 8 * PT + 4, hi[3], lo[3]);
  };
  // the warp's Q fragments, held in registers for the block's life
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_q(ks, qh[ks], ql[ks]);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int buf = 0;
  while (kt >= 0) {
    const int nxt = next_tile(kt);
    cp_async::wait<0>();
    __syncthreads();  // tile kt staged in buf; every warp is done with buf ^ 1
    if (nxt >= 0) {
      copy_tile<T, HD>(Ks + (buf ^ 1) * kBK * PT, kb, sk.s, nxt * kBK, n_k, hd);
      copy_tile<T, HD>(Vs + (buf ^ 1) * kBK * PT, vb, sv.s, nxt * kBK, n_k, hd);
    }
    cp_async::commit();
    const T* Kt = Ks + buf * kBK * PT;
    const T* Vt = Vs + buf * kBK * PT;
    const int k0 = kt * kBK;

    // the warp's 16 rows see no key of this tile: its state stays as it is
    // (a fully masked tile would add terms the next visible key washes out
    // exactly: exp(-1e30 - m) = 0)
    const int r_lo = q0 + qr, r_hi = r_lo + 15;
    const bool dead = k0 > r_hi || (window > 0 && k0 >= num_meta &&
                                    r_lo - (k0 + kBK - 1) >= window);
    // every key of the tile visible to all 16 rows: no mask needed
    const bool full = k0 + kBK - 1 <= r_lo && k0 + kBK <= n_k &&
                      (window <= 0 || r_hi - k0 < window || k0 + kBK <= num_meta);
    if (!dead) {
      // S = Q·Kᵀ: the warp's 16 rows x 64 keys, eight n8 tiles, the three
      // terms issued term by term over the eight accumulators
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[ks][i];
          al[i] = ql[ks][i];
        }
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = (j * 8 + g) * PT + ks * 8 + t;  // K[key g][d t]
          frag<kSlow>(Kt, idx, bh[j][0], bl[j][0]);
          frag<kSlow>(Kt, idx + 4, bh[j][1], bl[j][1]);
        }
        tf32x3::mma_split<8, kBf16, kBf16>(s, ah, al, bh, bl);
      }

      // mask, then the online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
      float mx[2] = {kNegInf, kNegInf};
      if (full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[j][c] *= scale;
            mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qi = r_lo + g + (c >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (c & 1);
            const bool vis = kj < n_k && kj <= qi &&
                             (window <= 0 || qi - kj < window || kj < num_meta);
            s[j][c] = vis ? s[j][c] * scale : kNegInf;
            mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
          }
      }
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = expf(s[j][c] - m_new[c >> 1]);
          sum[c >> 1] += s[j][c];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // O += P·V over the tile's eight k8 steps of keys; A's columns t and
      // t + 4 stand for keys 2t and 2t + 1, which this lane already holds
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ph[4], pl[4];
        tf32x3::split_as<kSlow>(s[kk][0], ph[0], pl[0]);
        tf32x3::split_as<kSlow>(s[kk][2], ph[1], pl[1]);
        tf32x3::split_as<kSlow>(s[kk][1], ph[2], pl[2]);
        tf32x3::split_as<kSlow>(s[kk][3], ph[3], pl[3]);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int idx = (kk * 8 + 2 * t) * PT + n * 8 + g;  // V[key 2t][d g]
          frag<kSlow>(Vt, idx, bh[n][0], bl[n][0]);
          frag<kSlow>(Vt, idx + PT, bh[n][1], bl[n][1]);
        }
        tf32x3::mma_split<NT, false, kBf16>(acc, ph, pl, bh, bl);
      }
    }
    buf ^= 1;
    kt = nxt;
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    bool bad = !tf32x3::finite(l[0]) || !tf32x3::finite(l[1]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) bad |= !tf32x3::finite(acc[n][c]);
    if (__syncthreads_or(bad)) return true;  // every warp is done with the buffers
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + g + 8 * r;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // the row log-sum-exp of the scaled scores, for the backward; NaN where
    // the row's softmax is NaN (a visible score that is NaN or +inf makes l
    // NaN, which fmaxf above would hide), as the reference's softmax row is
    // then NaN at every key, masked ones included
    if constexpr (kLse) {
      if (t == 0)
        lse[((long long)b * gridDim.y + h) * n_q + qi] = l[r] != l[r] ? l[r] : m[r] + logf(denom);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < hd)
        store2<T>(ob + qi * so.s + d, acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom,
                  d + 1 < hd);
    }
  }
  return false;
}

// the full split's block, out of line: the fast path keeps its registers
template <typename T, int HD, bool kLse>
__device__ __noinline__ void flash_block_full(const T* q, const T* k, const T* v, T* o,
                                              float* lse, Strides sq, Strides sk, Strides sv,
                                              Strides so, int group, int n_q, int n_k, int hd,
                                              float scale, int window, int num_meta) {
  flash_block<T, HD, true, kLse>(q, k, v, o, lse, sq, sk, sv, so, group, n_q, n_k, hd, scale,
                                 window, num_meta);
}

template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                 Strides sv, Strides so, int group, int n_q, int n_k, int hd, float scale,
                 int window, int num_meta) {
  if (flash_block<T, HD, false, kLse>(q, k, v, o, lse, sq, sk, sv, so, group, n_q, n_k, hd,
                                      scale, window, num_meta))
    flash_block_full<T, HD, kLse>(q, k, v, o, lse, sq, sk, sv, so, group, n_q, n_k, hd, scale,
                                  window, num_meta);
}

// vd > 128, or hd > 256: the block's O slice (columns sl·kCW .. + 127 of
// v's vd) over the full scores (hd; see the head of this file). The same
// arithmetic as flash_block otherwise; on the fast split a result that
// holds an inf or a NaN returns true and the block is taken again on the
// full split.
template <typename T, bool kSlow>
__device__ __forceinline__ bool flash_block_wide(const T* __restrict__ q,
                                                 const T* __restrict__ k,
                                                 const T* __restrict__ v, T* __restrict__ o,
                                                 Strides sq, Strides sk, Strides sv, Strides so,
                                                 int group, int n_q, int n_k, int hd, int vd,
                                                 float scale, int window, int num_meta) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PC = pitch<T, kKC>();  // a chunk's row pitch
  constexpr int PT = pitch<T, kCW>();  // the V slice's
  constexpr int KS = kKC / 8;          // k8 steps of a chunk of S = Q·Kᵀ
  constexpr int NT = kCW / 8;          // n8 tiles of the O slice
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [2][kBQ][PC]: the ring's Q chunks
  T* Ks = Qs + 2 * kBQ * PC;           // [2][kBK][PC]: its K chunks
  T* Vs = Ks + 2 * kBK * PC;           // [kBK][PT]: the tile's V slice

  const int n_sl = (vd + kCW - 1) / kCW;  // slices of O
  const int n_ch = (hd + kKC - 1) / kKC;  // chunks of hd (1 or more)
  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most keys first
  const int h = blockIdx.y / n_sl, sl = blockIdx.y % n_sl;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (threadIdx.x >> 5) * 16;
  const int c_sl = sl * kCW, w_sl = min(kCW, vd - c_sl);

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  const int q_last = min(q0 + kBQ, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  auto next_tile = [&](int kt) {
    for (++kt; kt <= kt_last; ++kt) {
      const int k0 = kt * kBK;
      if (!(window > 0 && k0 >= num_meta && q0 - (k0 + kBK - 1) >= window)) return kt;
    }
    return -1;
  };
  // Q's and K's columns c·kKC .. + 63 of tile kt into ring slot `slot`
  // (zero past hd)
  auto stage = [&](int kt, int c, int slot) {
    const int w = min(kKC, hd - c * kKC);
    copy_tile<T, kKC>(Qs + slot * kBQ * PC, qb + c * kKC, sq.s, q0, n_q, w);
    copy_tile<T, kKC>(Ks + slot * kBK * PC, kb + c * kKC, sk.s, kt * kBK, n_k, w);
  };

  int kt = next_tile(-1);
  if (kt >= 0) stage(kt, 0, 0);
  cp_async::commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int slot = 0;
  while (kt >= 0) {
    const int nxt = next_tile(kt);
    const int k0 = kt * kBK;
    const int r_lo = q0 + qr, r_hi = r_lo + 15;
    const bool dead = k0 > r_hi || (window > 0 && k0 >= num_meta &&
                                    r_lo - (k0 + kBK - 1) >= window);
    const bool full = k0 + kBK - 1 <= r_lo && k0 + kBK <= n_k &&
                      (window <= 0 || r_hi - k0 < window || k0 + kBK <= num_meta);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int c = 0; c < n_ch; ++c) {
      cp_async::wait<0>();
      // chunk c staged in `slot`; every warp is done with slot ^ 1 and,
      // at c == 0, with the previous tile's V slice
      __syncthreads();
      if (c + 1 < n_ch) stage(kt, c + 1, slot ^ 1);
      else if (nxt >= 0) stage(nxt, 0, slot ^ 1);
      // the V slice lands by chunk 1's wait (n_ch >= 2), or the wait below
      if (c == 0) copy_tile<T, kCW>(Vs, vb + c_sl, sv.s, k0, n_k, w_sl);
      cp_async::commit();
      if (!dead) {
        const T* Qc = Qs + slot * kBQ * PC;
        const T* Kc = Ks + slot * kBK * PC;
        // columns past hd are 0 in both chunks: they add 0
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ah[4], al[4];
          const int base = (qr + g) * PC + ks * 8 + t;
          frag<kSlow>(Qc, base, ah[0], al[0]);
          frag<kSlow>(Qc, base + 8 * PC, ah[1], al[1]);
          frag<kSlow>(Qc, base + 4, ah[2], al[2]);
          frag<kSlow>(Qc, base + 8 * PC + 4, ah[3], al[3]);
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = (j * 8 + g) * PC + ks * 8 + t;
            frag<kSlow>(Kc, idx, bh[j][0], bl[j][0]);
            frag<kSlow>(Kc, idx + 4, bh[j][1], bl[j][1]);
          }
          tf32x3::mma_split<8, kBf16, kBf16>(s, ah, al, bh, bl);
        }
      }
      slot ^= 1;
    }
    if (n_ch == 1) {  // hd <= 64: no chunk 1 whose wait lands the V slice
      cp_async::wait<0>();
      __syncthreads();
    }
    if (!dead) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = r_lo + g + (c >> 1) * 8;
          const int kj = k0 + j * 8 + 2 * t + (c & 1);
          const bool vis = full || (kj < n_k && kj <= qi &&
                                    (window <= 0 || qi - kj < window || kj < num_meta));
          s[j][c] = vis ? s[j][c] * scale : kNegInf;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
        }
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = expf(s[j][c] - m_new[c >> 1]);
          sum[c >> 1] += s[j][c];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P·V, the slice's 16 n8 tiles in two halves of 8 (half the
      // V fragments live at a time)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ph[4], pl[4];
        tf32x3::split_as<kSlow>(s[kk][0], ph[0], pl[0]);
        tf32x3::split_as<kSlow>(s[kk][2], ph[1], pl[1]);
        tf32x3::split_as<kSlow>(s[kk][1], ph[2], pl[2]);
        tf32x3::split_as<kSlow>(s[kk][3], ph[3], pl[3]);
#pragma unroll
        for (int nh = 0; nh < NT; nh += 8) {
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int idx = (kk * 8 + 2 * t) * PT + (nh + n) * 8 + g;  // V[key 2t][d g]
            frag<kSlow>(Vs, idx, bh[n][0], bl[n][0]);
            frag<kSlow>(Vs, idx + PT, bh[n][1], bl[n][1]);
          }
          tf32x3::mma_split<8, false, kBf16>(*reinterpret_cast<float(*)[8][4]>(acc[nh]), ph,
                                             pl, bh, bl);
        }
      }
    }
    kt = nxt;
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    bool bad = !tf32x3::finite(l[0]) || !tf32x3::finite(l[1]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) bad |= !tf32x3::finite(acc[n][c]);
    if (__syncthreads_or(bad)) return true;  // every warp is done with the buffers
  }

  T* ob = o + b * so.b + h * so.h + c_sl;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + g + 8 * r;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < w_sl)
        store2<T>(ob + qi * so.s + d, acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom,
                  d + 1 < w_sl);
    }
  }
  return false;
}

template <typename T>
__device__ __noinline__ void flash_block_wide_full(const T* q, const T* k, const T* v, T* o,
                                                   Strides sq, Strides sk, Strides sv,
                                                   Strides so, int group, int n_q, int n_k,
                                                   int hd, int vd, float scale, int window,
                                                   int num_meta) {
  flash_block_wide<T, true>(q, k, v, o, sq, sk, sv, so, group, n_q, n_k, hd, vd, scale, window,
                            num_meta);
}

// grid (query tiles, hq x slices of vd, batch)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
                      Strides sv, Strides so, int group, int n_q, int n_k, int hd, int vd,
                      float scale, int window, int num_meta) {
  if (flash_block_wide<T, false>(q, k, v, o, sq, sk, sv, so, group, n_q, n_k, hd, vd, scale,
                                 window, num_meta))
    flash_block_wide_full<T>(q, k, v, o, sq, sk, sv, so, group, n_q, n_k, hd, vd, scale, window,
                             num_meta);
}

// Before the attention: vflags[b][kv head][key tile][slice] = the bitmask
// over 128 of V's vd columns (four 32-bit words; one slice at vd <= 128)
// of "V holds an inf or NaN in this column within the tile's 64 keys".
// One block of 128 threads per (tile, kv head, b); thread c reads column
// sl·128 + c of every row of the tile (a row's columns are consecutive
// threads), eight rows in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_vflags(const T* __restrict__ v, Strides sv, uint4* __restrict__ vflags,
                        int n_k, int hd) {
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_sl = (hd + kThreads - 1) / kThreads;
  const int rows = min(kBK, n_k - kt * kBK);
  __shared__ uint32_t words[kThreads / 32];
  for (int sl = 0; sl < n_sl; ++sl) {
    const int c = sl * kThreads + threadIdx.x;
    const T* col = v + b * sv.b + hk * sv.h + (long long)kt * kBK * sv.s + c;
    bool bad = false;
    if (c < hd) {
      for (int r0 = 0; r0 < rows; r0 += 8) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = r0 + i < rows ? to_f32(col[(r0 + i) * sv.s]) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) bad |= !tf32x3::finite(x[i]);
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, bad);
    if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = word;
    __syncthreads();
    if (threadIdx.x == 0)
      vflags[(((long long)b * gridDim.y + hk) * gridDim.x + kt) * n_sl + sl] =
          make_uint4(words[0], words[1], words[2], words[3]);
    __syncthreads();  // words is rewritten by the next slice
  }
}

// After the attention: for each warp of the attention's query tile qt
// (rows 16w .. 16w + 15), the OR of vflags over the key tiles it did not
// compute (those its block skips: above the diagonal, or outside the
// window with no meta token; and those none of its 16 rows sees), and NaN
// into those columns of its rows, in every query head of the kv head's
// group. One block per (query tile, kv head, b), a warp per attention
// warp; a lane per key tile, then a lane per (row, flagged column); slice
// by slice of 128 columns. (The wide kernel skips the same tiles.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_nanfix(const uint4* __restrict__ vflags, T* __restrict__ o, Strides so,
                        int group, int n_q, int n_k, int hd, int window, int num_meta) {
  const int qt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_kt = (n_k + kBK - 1) / kBK;
  const int n_sl = (hd + kThreads - 1) / kThreads;
  const int q0 = qt * kBQ, q_last = min(q0 + kBQ, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  const int r_lo = q0 + warp * 16, r_hi = r_lo + 15;
  const uint4* vf = vflags + ((long long)b * gridDim.y + hk) * n_kt * n_sl;
  const T nan = nan_as<T>();
  for (int sl = 0; sl < n_sl; ++sl) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int j = lane; j < n_kt; j += 32) {
      const int k0 = j * kBK;
      const bool skipped = j > kt_last || (window > 0 && k0 >= num_meta &&
                                           q0 - (k0 + kBK - 1) >= window);
      const bool dead = k0 > r_hi || (window > 0 && k0 >= num_meta &&
                                      r_lo - (k0 + kBK - 1) >= window);
      if (skipped || dead) {
        const uint4 f = vf[(long long)j * n_sl + sl];
        w[0] |= f.x;
        w[1] |= f.y;
        w[2] |= f.z;
        w[3] |= f.w;
      }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) any |= w[i] = __reduce_or_sync(0xffffffffu, w[i]);
    if (!any) continue;  // finite input: nothing to store
    for (int hh = 0; hh < group; ++hh) {
      T* ob = o + b * so.b + (long long)(hk * group + hh) * so.h;
      for (int i = 0; i < 4; ++i) {
        for (uint32_t m = w[i]; m; m &= m - 1) {
          const int d = sl * kThreads + 32 * i + __ffs(m) - 1;
          if (lane < 16 && r_lo + lane < n_q) ob[(r_lo + lane) * so.s + d] = nan;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// v's head_dim apart from q's and k's, vd <= 128 and hd <= 256 (DeepSeek-V2's
// MLA prefill): flash_fwd_kernel_wgmma, on Hopper's warpgroup products (see
// the head of this file)
// ---------------------------------------------------------------------------
namespace wg {

// the swizzled atoms, the mbarrier ring, the tf32 products and the
// producer's loads and split, shared with flash_attention_bwd_vd.cu
using namespace ::wgmma;

constexpr int kHalf = 2 * kAtom;  // 64 rows x 64 columns (or 128 x 32) of f32
constexpr int kStage = 2 * kHalf;  // a ring stage, or a 64-column chunk of Q: hi + lo
constexpr int kUnits = 7;          // Q's chunks + the ring's stages: 224 KB
constexpr int kSmem = kUnits * kStage + 1024;  // + the alignment to 1024 bytes
constexpr int kThreads = 256;      // the consumer warpgroup, then the producer's
constexpr int kQ = -2;             // the producer's stages: Q's chunks,
constexpr int kFirst = -3;         // then the first key tile's chunks of K

// the producer's loads of one stage: eight 4-element loads a thread. Rows
// row0 + 8i + p / 16 of a [n x width] operand (Q or K), columns col0 +
// 4(p % 16) .. + 3; coalesced, 256 bytes (f32) a row
template <typename T>
__device__ __forceinline__ void get_rows(uint4 (&x)[8], const T* base, long long stride,
                                         int row0, int n, int col0, int width, bool vec,
                                         int p) {
  const int col = col0 + 4 * (p & 15);
  if (vec && row0 + 64 <= n && col0 + 64 <= width) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = ld_raw<T>(base + (row0 + 8 * i + (p >> 4)) * stride + col);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 8 * i + (p >> 4);
      x[i] = ld_raw_masked<T>(row < n ? base + row * stride : nullptr, col, width);
    }
  }
}

// V's 32 keys k0 .. k0 + 31 of a stage: warp w reads keys k0 + 16(w % 2) +
// l % 16 at columns 64(w / 2) + 8C + 4(l / 16) .. + 3 (C < 8), 32 bytes
// (f32) a row, so that the transposed stores below fall on 32 distinct
// banks
template <typename T>
__device__ __forceinline__ void get_vt(uint4 (&x)[8], const T* base, long long stride, int k0,
                                       int n, int vd, bool vec, int p) {
  const int w = p >> 5, l = p & 31;
  const int row = k0 + 16 * (w & 1) + (l & 15);
  const int col = 64 * (w >> 1) + 4 * (l >> 4);
  if (vec && k0 + 32 <= n && vd == 128) {
    const T* r = base + row * stride + col;
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = ld_raw<T>(r + 8 * c);
  } else {
    const T* r = row < n ? base + row * stride : nullptr;
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = ld_raw_masked<T>(r, col + 8 * c, vd);
  }
}

// get_rows' values into a 64 x 64 chunk of hi parts and one of lo parts
// (two 32-column atoms each); a bf16 Q or K has no lo part (S takes one
// product)
template <typename T, bool kSlow>
__device__ __forceinline__ void put_rows(unsigned char* hi, unsigned char* lo,
                                         const uint4 (&x)[8], int p) {
  const int off0 = ((p & 15) >> 3) * kAtom;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = off0 + sw128(8 * i + (p >> 4), 4 * (p & 7));
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

// get_vt's values transposed: Vᵀ [128 columns of vd][32 keys], K-major, so
// that it is the B operand of O += P·V. Inside each group of 8 keys,
// position t holds key 2t and position t + 4 key 2t + 1: the order in
// which the S accumulator hands P over as an A fragment
template <typename T, bool kSlow>
__device__ __forceinline__ void put_vt(unsigned char* hi, unsigned char* lo,
                                       const uint4 (&x)[8], int p) {
  const int w = p >> 5, l = p & 31;
  const int kp = 16 * (w & 1) + (l & 15);
  const int pos = (kp & ~7) | ((kp & 1) ? 4 + ((kp & 7) >> 1) : (kp & 7) >> 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int d0 = 64 * (w >> 1) + 8 * c + 4 * (l >> 4);
    const float4 f = widen<T>(x[c]);
    const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = sw128(d0 + i, pos);
      uint32_t h, lw;
      split_in<T, kSlow>(v[i], h, lw);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = lw;
    }
  }
}

}  // namespace wg

// The block's work on wgmma: one (64-row query tile, head), a consumer
// warpgroup (threads 0-127) and a producer warpgroup (128-255) around a
// ring of NS = 7 - NKC stages of 32 KB in shared memory (see the head of
// this file). pass 0 runs on the fast split: a result that holds an inf
// or a NaN is not stored, and it returns the ring's stage count, from
// which pass 1, on the full split, goes on; else -1. n0: the ring's stage
// count at the start (Q's barrier completes once a pass).
template <typename T, int NKC, bool kLse>
__device__ __forceinline__ int flash_block_wgmma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so, int group, int n_q, int n_k, int hd, int vd,
    float scale, int window, int num_meta, unsigned char* smem, uint32_t bars, uint32_t pass,
    uint32_t n0) {
  using namespace wg;
  const bool slow = pass == 1;
  constexpr int NS = kUnits - NKC;  // the ring's stages
  constexpr int SPT = NKC + 2;      // stages a key tile: NKC chunks of K, two halves of Vᵀ
  constexpr bool kBf16 = sizeof(T) == 2;
  const uint32_t base = smem_u32(smem);
  const uint32_t ring = base + NKC * kStage;
  const uint32_t qbar = bars + 16 * NS;
  auto full = [&](uint32_t n) { return bars + 8 * (n % NS); };
  auto empty = [&](uint32_t n) { return bars + 8 * (NS + n % NS); };

  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int q_last = min(q0 + kBQ, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  auto next_tile = [&](int kt) {
    for (++kt; kt <= kt_last; ++kt) {
      const int k0 = kt * kBK;
      if (!(window > 0 && k0 >= num_meta && q0 - (k0 + kBK - 1) >= window)) return kt;
    }
    return -1;
  };

  if (threadIdx.x >= 128) {
    // the producer, in the consumer's order: Q's NKC chunks, the first
    // visited key tile's NKC chunks of K, then for each visited tile the
    // next one's chunks of K and its own two halves of Vᵀ. Each stage is
    // loaded into registers, split into hi and lo as it is stored, then
    // arrived on by each warp.
    const int p = threadIdx.x - 128;
    // a stage: kt == kQ: Q's chunk st; kt == kFirst: chunk st of K's tile
    // nk (the first); else st < NKC: chunk st of K's tile nk (the next
    // after kt), st >= NKC: half st - NKC of tile kt's Vᵀ. kt == -1: done
    struct Stage {
      int kt, nk, st;
    };
    auto advance = [&](Stage& c) {
      ++c.st;
      if (c.kt == kQ) {
        if (c.st == NKC) c = {kFirst, next_tile(-1), 0};
        if (c.kt == kFirst && c.nk < 0) c.kt = -1;
      } else if (c.kt == kFirst) {
        if (c.st == NKC) c = {c.nk, next_tile(c.nk), NKC};
        if (c.kt >= 0 && c.nk >= 0 && c.st == NKC) c.st = 0;
      } else if (c.st == SPT) {
        c.kt = c.nk;
        if (c.kt >= 0) {
          c.nk = next_tile(c.kt);
          c.st = c.nk >= 0 ? 0 : NKC;
        }
      }
    };
    const bool vq = aligned4(qb, sq.s), vk = aligned4(kb, sk.s), vv = aligned4(vb, sv.s);
    auto load = [&](const Stage& c, uint4 (&x)[8]) {
      if (c.kt == kQ) get_rows<T>(x, qb, sq.s, q0, n_q, 64 * c.st, hd, vq, p);
      else if (c.st < NKC) get_rows<T>(x, kb, sk.s, c.nk * kBK, n_k, 64 * c.st, hd, vk, p);
      else get_vt<T>(x, vb, sv.s, c.kt * kBK + 32 * (c.st - NKC), n_k, vd, vv, p);
    };
    uint32_t n = n0;
    auto store = [&](const Stage& c, const uint4 (&x)[8]) {
      if (c.kt == kQ) {
        if (slow) put_rows<T, true>(smem + c.st * kHalf, smem + (NKC + c.st) * kHalf, x, p);
        else put_rows<T, false>(smem + c.st * kHalf, smem + (NKC + c.st) * kHalf, x, p);
        if (c.st == NKC - 1) {
          fence_proxy();
          warp_arrive(qbar);
        }
        return;
      }
      if (n >= (uint32_t)NS) bar_wait(empty(n), (n / NS - 1) & 1);  // the slot's last use is done
      unsigned char* s = smem + NKC * kStage + (n % NS) * kStage;
      if (c.st < NKC) {
        if (slow) put_rows<T, true>(s, s + kHalf, x, p);
        else put_rows<T, false>(s, s + kHalf, x, p);
      } else {
        if (slow) put_vt<T, true>(s, s + kHalf, x, p);
        else put_vt<T, false>(s, s + kHalf, x, p);
      }
      fence_proxy();
      warp_arrive(full(n));
      ++n;
    };
    // two stages of loads in flight: a turn stores one stage and loads the
    // one two ahead into its registers (loading before the slot wait, or
    // further ahead, measured slower: more loads in flight contend with
    // the tensor cores' shared-memory reads)
    uint4 x[2][8];
    Stage ld{kQ, 0, 0}, st{kQ, 0, 0};  // the next stage to load, to store
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (ld.kt != -1) {
        load(ld, x[d]);
        advance(ld);
      }
    }
    auto turn = [&](uint4 (&xd)[8]) {
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

  // the consumer: S = Q·Kᵀ (64 x 64 on m64n64k8, Q and K from shared
  // memory), the online softmax in registers, O += P·V (64 x 128 on
  // m64n128k8, P from registers, Vᵀ from shared memory). A tile's P·V
  // goes to the tensor cores right behind the next tile's S, and that S's
  // softmax runs once it has landed, while the tensor cores run the P·V.
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t dq_hi = desc(base), dq_lo = desc(base + NKC * kHalf);
  float acc[64], s[32];
  uint32_t ph[32], pl[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) ph[i] = pl[i] = 0u;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};

  // each stage's products are one wgmma group, committed in stage order;
  // stages rel .. n - 1 are committed and not yet released
  uint32_t n = n0, rel = n0;
  // every group done, every stage released
  auto drain = [&]() {
    mma_wait<0>();
    while (rel < n) warp_arrive(empty(rel++));
    keep(acc);
    keep(s);
    keep(ph);
    keep(pl);
  };
  // the ring's next stage, once the producer has filled it
  auto take = [&]() {
    bar_wait(full(n), (n / NS) & 1);
    return ring + (n % NS) * kStage;
  };
  // S = Q·Kᵀ over hd's NKC chunks: per k8 step lo·hi, hi·lo, hi·hi (bf16:
  // hi·hi alone). A chunk's stage is released as soon as the next chunk's
  // group is committed and the wait leaves only that one in flight, so
  // that the producer refills it while S runs.
  auto issue_s = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      const uint32_t sa = take();
      const uint64_t dk_hi = desc(sa), dk_lo = desc(sa + kHalf);
      mma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int kq = 8 * c + ks;
        const uint32_t oq = ((kq >> 2) * kAtom + (kq & 3) * 32) >> 4;
        const uint32_t ok = ((ks >> 2) * kAtom + (ks & 3) * 32) >> 4;
        if constexpr (!kBf16) {
          mma_ss(s, dq_lo + oq, dk_hi + ok);
          mma_ss(s, dq_hi + oq, dk_lo + ok);
        }
        mma_ss(s, dq_hi + oq, dk_hi + ok);
      }
      mma_commit();
      ++n;
      if (c > 0) {
        mma_wait<1>();
        warp_arrive(empty(rel++));
      }
    }
  };
  // O += P·V over the tile's two halves of 32 keys: per k8 step lo·hi,
  // hi·lo, hi·hi (bf16: P's lo with V's lo slot, then hi·hi)
  auto issue_pv = [&]() {
#pragma unroll
    for (int vh = 0; vh < 2; ++vh) {
      const uint32_t sa = take();
      const uint64_t dv_hi = desc(sa), dv_lo = desc(sa + kHalf);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 4 * (4 * vh + kk);
        const uint32_t ov = 2 * kk;  // 32 bytes
        if constexpr (!kBf16) {
          mma_rs(acc, pl[j], pl[j + 1], pl[j + 2], pl[j + 3], dv_hi + ov);
          mma_rs(acc, ph[j], ph[j + 1], ph[j + 2], ph[j + 3], dv_lo + ov);
        } else {
          mma_rs(acc, pl[j], pl[j + 1], pl[j + 2], pl[j + 3], dv_lo + ov);
        }
        mma_rs(acc, ph[j], ph[j + 1], ph[j + 2], ph[j + 3], dv_hi + ov);
      }
      mma_commit();
      ++n;
    }
  };
  // mask, then the online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
  // of the warp's 16: s becomes P, corr the factor O is to be rescaled by
  auto softmax = [&](int k0) {
    const int r0 = q0 + 16 * w + g;
    const bool all = k0 + kBK - 1 <= q0 && k0 + kBK <= n_k &&
                     (window <= 0 || q0 + kBQ - 1 - k0 < window || k0 + kBK <= num_meta);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = r0 + (c >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * t + (c & 1);
        const bool vis = all || (kj < n_k && kj <= qi &&
                                 (window <= 0 || qi - kj < window || kj < num_meta));
        float& x = s[4 * j + c];
        x = vis ? x * scale : kNegInf;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m_new[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = m_new[r];
    }
  };
  // P into hi/lo A fragments: element (row, key 8j + 2t + e) of s goes to
  // A column t + 4e of k8 step j
  auto split_p = [&]() {
    if (slow) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int a = (i & ~3) | (((i & 1) << 1) | ((i >> 1) & 1));
        tf32x3::split(s[i], ph[a], pl[a]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int a = (i & ~3) | (((i & 1) << 1) | ((i >> 1) & 1));
        ph[a] = __float_as_uint(s[i]) & kTrunc;
        pl[a] = __float_as_uint(s[i] - __uint_as_float(ph[a]));
      }
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
  };

  bar_wait(qbar, pass);
  int kt = next_tile(-1);
  if (kt >= 0) {
    issue_s();
    drain();
    softmax(kt * kBK);
    split_p();
  }
  // Tile kt's P is in ph/pl and its factor in corr: the next tile's S
  // goes to the tensor cores first, kt's P·V right behind it; once S has
  // landed (the wait leaves P·V's two groups in flight), its softmax runs
  // under P·V. Each branch issues and waits for its own groups (ptxas
  // serializes every wgmma of the kernel if a path could leave a group in
  // flight where its registers are read).
  while (kt >= 0) {
    const int nxt = next_tile(kt);
    if (nxt >= 0) {
      issue_s();
      rescale();
      issue_pv();
      mma_wait<2>();
      while (rel < n - 2) warp_arrive(empty(rel++));
      keep(s);
      softmax(nxt * kBK);
      drain();
      split_p();
    } else {
      rescale();
      issue_pv();
      drain();
    }
    kt = nxt;
  }
  if (!slow) {
    bool bad = !tf32x3::finite(l[0]) || !tf32x3::finite(l[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) bad |= !tf32x3::finite(acc[i]);
    if (__syncthreads_or(bad)) return (int)n;
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * w + g + 8 * r;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // the row log-sum-exp, as flash_block writes it (NaN for a NaN
    // softmax row)
    if constexpr (kLse) {
      if (t == 0)
        lse[((long long)b * gridDim.y + h) * n_q + qi] = l[r] != l[r] ? l[r] : m[r] + logf(denom);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = j * 8 + 2 * t;
      if (d < vd)
        store2<T>(ob + qi * so.s + d, acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom,
                  d + 1 < vd);
    }
  }
  return -1;
}

// grid (query tiles, hq, batch), 256 threads: hd <= 64·NKC, vd <= 128;
// kLse: also the rows' log-sum-exp (a separate instantiation, so that
// serving runs the code it ran without it)
template <typename T, int NKC, bool kLse>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       Strides sq, Strides sk,
                       Strides sv, Strides so, int group, int n_q, int n_k, int hd, int vd,
                       float scale, int window, int num_meta) {
  constexpr int NS = wg::kUnits - NKC;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];  // full[NS], empty[NS], Q's
  unsigned char* tiles = smem + ((1024u - (wg::smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t bu = wg::smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= 2 * NS; ++i) wg::bar_init(bu + 8 * i, wg::kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the fast split's pass, then, for a block whose result holds an inf or
  // a NaN, the full split's, in one inlined body (a call out of line
  // would make ptxas serialize every wgmma of the kernel)
  uint32_t n0 = 0;
  for (uint32_t pass = 0;; ++pass) {
    const int n = flash_block_wgmma<T, NKC, kLse>(q, k, v, o, lse, sq, sk, sv, so, group, n_q,
                                                  n_k, hd, vd, scale, window, num_meta, tiles, bu,
                                                  pass, n0);
    if (n < 0) break;
    n0 = (uint32_t)n;
  }
}

// ---------------------------------------------------------------------------
// vd = hd in (64, 256] on Hopper's warpgroup products, the scores once per
// (query tile, key tile): flash_fwd_kernel_wgmma128 at 128 (two warpgroups
// on two 64-row halves of a 128-row query tile) and flash_fwd_kernel_wgmma256
// at 256 (two warpgroups on O's two 128-column halves of a 64-row tile; see
// the head of this file)
// ---------------------------------------------------------------------------
namespace wgh {

using namespace ::wgmma;

constexpr int kWorkers = 256;  // two consumer warpgroups

// The design at head width HD (128 or 256)
template <int HD>
struct Dims {
  // 128: warpgroup w owns rows 64w .. 64w + 63 of a 128-row query tile and
  // all of O's columns, and both read one ring; 256: warpgroup w owns O's
  // columns 128w .. 128w + 127 of a 64-row tile, each with its own ring
  static constexpr bool kRows = HD == 128;
  static constexpr int kNA = HD / 32;                  // atoms of a 64-row tile
  static constexpr int kBlockRows = kRows ? 128 : 64;  // query rows a block
  static constexpr int kQAtoms = kRows ? 2 * kNA : kNA;  // Q's hi atoms (as many lo)
  static constexpr int kR = kRows ? 6 : 2;             // ring slots: the shared ring's, or each one's
  static constexpr int kRingAt = 2 * kQAtoms * kAtom;  // after Q's hi and lo atoms
  static constexpr int kSwapAt = kRingAt + (kRows ? 1 : 2) * kR * kStage;  // after the ring(s)
  static constexpr int kSmem = kSwapAt + (kRows ? 0 : 2 * 64 * 64 * 4) + 1024;  // + the alignment
  // mbarriers: full[kR] and empty[kR] of each ring
  static constexpr int kBars = (kRows ? 2 : 4) * kR;
};

// the images of K (rows) and Vᵀ (transposed) per kv head: [B, Hkv, key
// tiles, HD / 32 stages of kStage bytes] each, K's first
template <int HD>
__device__ __forceinline__ const unsigned char* stage_of(const unsigned char* images, bool vt,
                                                         int batch, int hkv, int n_k, int b,
                                                         int hk, int kt, int s) {
  constexpr int kNA = HD / 32;
  const int n_kt = (n_k + kBK - 1) / kBK;
  const long long per = (long long)batch * hkv * n_kt * kNA * kStage;
  return images + (vt ? per : 0) + ((((long long)b * hkv + hk) * n_kt + kt) * kNA + s) * kStage;
}

// grid (key tiles, HD / 32 stages, B x 2 Hkv), 128 threads: stage s of one
// key tile of K's image (as stored) or Vᵀ's (32-key half s / (HD / 64),
// 64-column chunk s % (HD / 64), in the key order of P's A fragments), full
// split
template <typename T, int HD>
__device__ __forceinline__ void image_stage(const T* __restrict__ k, const T* __restrict__ v,
                                            Strides sk, Strides sv,
                                            unsigned char* __restrict__ images, int batch,
                                            int n_k, int hd) {
  const int hkv = gridDim.z / (2 * batch);
  const int b = blockIdx.z / (2 * hkv), j = blockIdx.z % (2 * hkv);
  const bool vt = j >= hkv;
  const int hk = j % hkv, kt = blockIdx.x, s = blockIdx.y;
  const Strides st = vt ? sv : sk;
  unsigned char* dst =
      const_cast<unsigned char*>(stage_of<HD>(images, vt, batch, hkv, n_k, b, hk, kt, s));
  put_image_stage<T, HD>(dst, (vt ? v : k) + b * st.b + hk * st.h, st.s, kt * kBK, n_k, hd, s,
                         vt, threadIdx.x);
}
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_image256(const T* __restrict__ k, const T* __restrict__ v, Strides sk,
                          Strides sv, unsigned char* __restrict__ images, int batch, int n_k,
                          int hd) {
  image_stage<T, 256>(k, v, sk, sv, images, batch, n_k, hd);
}
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_image128(const T* __restrict__ k, const T* __restrict__ v, Strides sk,
                          Strides sv, unsigned char* __restrict__ images, int batch, int n_k,
                          int hd) {
  image_stage<T, 128>(k, v, sk, sv, images, batch, n_k, hd);
}

}  // namespace wgh

// The block's work on wgmma at head width HD, two consumer warpgroups:
// - 128: a 128-row query tile, warpgroup w owning its rows 64w ..
//   64w + 63, all of O's columns and all of S's k8 steps; one ring of kR
//   16 KB slots that both read in the same order, its stages landed by
//   warpgroup 0's first thread (PairFeed);
// - 256: a 64-row query tile, warpgroup w owning O's columns 128w ..
//   128w + 127 and Q's k8 steps over them, each warpgroup with its own
//   ring filled by its first thread (WgFeed); S = Q·Kᵀ is two partials
//   summed through shared memory (p0 + p1 in both: the same bits), so both
//   run the same online softmax.
// Q stays resident, split by its consumers as they load it. The rings'
// stages come by bulk copies from K's and Vᵀ's images. O += P·V over the
// warpgroup's Vᵀ stages. pass 0 runs on the fast split: a result that holds
// an inf or a NaN is not stored, and it returns the ring's stage count,
// from which pass 1, on the full split (Q and P), goes on; else -1. m0: the
// ring's stage count at the start.
template <typename T, int HD, bool kLse, class Ring>
__device__ __forceinline__ int flash_block_wgmma_hd(
    const T* __restrict__ q, const unsigned char* __restrict__ images, T* __restrict__ o,
    float* __restrict__ lse, Strides sq, Strides so, int batch, int group, int n_q, int n_k,
    int hd, float scale, int window, int num_meta, unsigned char* smem, const Ring& ring,
    uint32_t pass, uint32_t m0) {
  using namespace wgh;
  using D = Dims<HD>;
  constexpr bool kRows = D::kRows;
  constexpr int kNA = D::kNA;
  const bool slow = pass == 1;
  constexpr bool kBf16 = sizeof(T) == 2;
  const uint32_t base = smem_u32(smem);

  const int n_qt = (n_q + D::kBlockRows - 1) / D::kBlockRows;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = gridDim.y / group;
  const int hk = h / group;
  const int qb0 = qt * D::kBlockRows;  // the block's first row
  const int q_last = min(qb0 + D::kBlockRows, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  auto next_tile = [&](int kt) {
    for (++kt; kt <= kt_last; ++kt) {
      const int k0 = kt * kBK;
      if (!(window > 0 && k0 >= num_meta && qb0 - (k0 + kBK - 1) >= window)) return kt;
    }
    return -1;
  };
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb0 + (kRows ? 64 * wg : 0);  // the warpgroup's first row
  // the warpgroup's Q atoms: hi atom i (i < 4) at qa + i, lo at qa + kNA + i
  // (its own 64 rows at 128; its 128 columns at 256)
  const int qa = kRows ? 2 * kNA * wg : 4 * wg;
  const int col0 = kRows ? 0 : 128 * wg;  // its first column of O

  // The warpgroup's stages, in the order it takes them: the 4 K stages of
  // the first visited tile that it reads, then for each visited tile those
  // of the next one and its own 4 Vᵀ stages (64-column chunk c by 32-key
  // half k % 2: image stage (HD / 64)(k % 2) + c, c = k / 2 at 128 and
  // 2 wg + k / 2 at 256). The lander's cursor: group `kind` (0: K, 1: Vᵀ)
  // of tile `tile`, stage `st` in it; `pend`: the tile whose Vᵀ follows a
  // next tile's K
  int visited = 0;
  for (int kt = next_tile(-1); kt >= 0; kt = next_tile(kt)) ++visited;
  const uint32_t m_end = m0 + (uint32_t)(8 * visited);
  int kind = 0, tile = next_tile(-1), pend = -1, st = 0;
  auto land = [&](uint32_t m) {
    ring.land(m,
              kind == 0 ? wgh::stage_of<HD>(images, false, batch, hkv, n_k, b, hk, tile,
                                            (kRows ? 0 : 4 * wg) + st)
                        : wgh::stage_of<HD>(images, true, batch, hkv, n_k, b, hk, tile,
                                            (HD / 64) * (st & 1) + (kRows ? 0 : 2 * wg) +
                                                (st >> 1)),
              nullptr, kStage);
    if (++st < 4) return;
    st = 0;
    if (kind == 0 && pend < 0) {  // the first tile's K: then the next's K, or its Vᵀ
      const int nxt = next_tile(tile);
      if (nxt >= 0) pend = tile, tile = nxt;
      else kind = 1;
    } else if (kind == 0) {       // a next tile's K: then the pending Vᵀ
      kind = 1, tile = pend, pend = -1;
    } else {                      // a Vᵀ: then the next tile's next's K, or its Vᵀ
      const int nt = next_tile(tile), nn = nt >= 0 ? next_tile(nt) : -1;
      if (nn >= 0) kind = 0, tile = nn, pend = nt;
      else tile = nt;
    }
  };
  // 128: warpgroup 0's first thread lands the shared ring's stages; 256:
  // each warpgroup's first thread its own ring's
  using Feed = std::conditional_t<kRows, PairFeed<D::kR, decltype(land)>,
                                  WgFeed<D::kR, decltype(land)>>;
  Feed feed{ring, land, m0, m_end, kRows ? threadIdx.x == 0 : tid == 0};
  feed.start();

  float* swap = reinterpret_cast<float*>(smem + D::kSwapAt);  // 256: [2][32 x 128]
  // the warpgroup's Q atoms: loaded and split by the warpgroup itself
  {
    const T* qb = q + b * sq.b + h * sq.h;
    const bool vq = aligned4(qb, sq.s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 x[4];
      const int c = kRows ? i : 4 * wg + i;  // its 32-column atom of Q
      unsigned char* hi = smem + (qa + i) * kAtom;
      unsigned char* lo = smem + (qa + kNA + i) * kAtom;
      get_rows<T>(x, qb, sq.s, q0, n_q, 32 * c, hd, vq, tid);
      if (slow) put_rows<T, true>(hi, lo, x, tid);
      else put_rows<T, false>(hi, lo, x, tid);
    }
    fence_proxy();
    named_sync(3 + wg, 128);
  }
  float acc[2][32], s[32];
  uint32_t ph[32], pl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[0][i] = acc[1][i] = 0.f;
    ph[i] = pl[i] = 0u;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  uint32_t n = m0, rel = m0;  // the next stage to take, to free
  auto drain = [&]() {
    mma_wait<0>();
    keep(acc[0]);
    keep(acc[1]);
    keep(s);
    keep(ph);
    keep(pl);
    while (rel < n) feed.release(rel++);
  };
  // S = Q·Kᵀ (at 256 this warpgroup's partial): its four Q atoms' k8
  // steps, each atom's stage freed one group later
  auto issue_s = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t sa = feed.take(n++);
      mma_fence();
      ss_atom<kBf16>(s, desc(base + (qa + i) * kAtom), desc(base + (qa + kNA + i) * kAtom),
                     desc(sa), desc(sa + kAtom));
      mma_commit();
      if (i > 0) {
        mma_wait<1>();
        feed.release(rel++);
      }
    }
  };
  // O += P·V over this warpgroup's two 64-column chunks, each by the
  // tile's two 32-key halves of Vᵀ: each stage's group committed, then the
  // ones before it waited for and their stages freed (the last S stage's
  // first), so that one group stays in flight
  auto issue_pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa = feed.take(n++);
      mma_fence();
      rs_atom<kBf16>(acc[kk >> 1], ph, pl, 4 * (kk & 1), desc(sa), desc(sa + kAtom));
      mma_commit();
      mma_wait<1>();
      while (rel < n - 1) feed.release(rel++);
    }
  };
  // 256: the two partials summed, p0 + p1 in both warpgroups
  auto exchange = [&]() {
    if constexpr (!kRows) {
#pragma unroll
      for (int i = 0; i < 32; ++i) swap[(wg * 32 + i) * 128 + tid] = s[i];
      named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += swap[((1 - wg) * 32 + i) * 128 + tid];
      named_sync(2, 256);  // both have read: the swap is free
    }
  };
  // mask, then the online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
  // of the warp's 16: s becomes P, corr the factor O is to be rescaled by
  auto softmax = [&](int k0) {
    const int r0 = q0 + 16 * w + g;
    const bool all = k0 + kBK - 1 <= q0 && k0 + kBK <= n_k &&
                     (window <= 0 || q0 + 63 - k0 < window || k0 + kBK <= num_meta);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = r0 + (c >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * t + (c & 1);
        const bool vis = all || (kj < n_k && kj <= qi &&
                                 (window <= 0 || qi - kj < window || kj < num_meta));
        float& x = s[4 * j + c];
        x = vis ? x * scale : kNegInf;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m_new[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = m_new[r];
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[c][4 * j] *= corr[0];
        acc[c][4 * j + 1] *= corr[0];
        acc[c][4 * j + 2] *= corr[1];
        acc[c][4 * j + 3] *= corr[1];
      }
  };

  int kt = next_tile(-1);
  if (kt >= 0) {
    issue_s();
    drain();
    exchange();
    softmax(kt * kBK);
    split_frags(s, ph, pl, slow);
  }
  // Tile kt's P is in ph/pl and its factor in corr: the next tile's S
  // goes to the tensor cores first, kt's P·V right behind it; the
  // exchange and the softmax run under P·V's last group. Each branch
  // issues and waits for its own groups.
  while (kt >= 0) {
    const int nxt = next_tile(kt);
    if (nxt >= 0) {
      issue_s();
      rescale();
      issue_pv();
      keep(s);
      exchange();
      softmax(nxt * kBK);
      drain();
      split_frags(s, ph, pl, slow);
    } else {
      rescale();
      issue_pv();
      drain();
    }
    kt = nxt;
  }
  if (!slow) {
    bool bad = !tf32x3::finite(l[0]) || !tf32x3::finite(l[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      bad |= !tf32x3::finite(acc[0][i]) || !tf32x3::finite(acc[1][i]);
    if (__syncthreads_or(bad)) return (int)m_end;
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * w + g + 8 * r;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if constexpr (kLse) {
      if ((kRows || wg == 0) && t == 0)
        lse[((long long)b * gridDim.y + h) * n_q + qi] = l[r] != l[r] ? l[r] : m[r] + logf(denom);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = col0 + 64 * c + j * 8 + 2 * t;
        if (d < hd)
          store2<T>(ob + qi * so.s + d, acc[c][4 * j + 2 * r] / denom,
                    acc[c][4 * j + 2 * r + 1] / denom, d + 1 < hd);
      }
  }
  return -1;
}

// The kernel's body at head width HD: the rings' mbarriers, then the fast
// split's pass and, for a block whose result holds an inf or a NaN, the
// full split's, in one inlined body (a call out of line would make ptxas
// serialize every wgmma of the kernel)
template <typename T, int HD, bool kLse>
__device__ __forceinline__ void fwd_wgmma_hd(const T* __restrict__ q,
                                             const unsigned char* __restrict__ images,
                                             T* __restrict__ o, float* __restrict__ lse,
                                             Strides sq, Strides so, int batch, int group,
                                             int n_q, int n_k, int hd, float scale, int window,
                                             int num_meta) {
  using namespace wgh;
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[D::kBars];
  unsigned char* tiles = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t bu = smem_u32(bars);
  // full barriers: one arrival (the lander's, with the copies' bytes);
  // empty ones: one a warp of the warpgroups that read the ring
  if (threadIdx.x == 0) {
    for (int i = 0; i < D::kBars; ++i)
      bar_init(bu + 8 * i, i % (2 * D::kR) < D::kR ? 1 : (D::kRows ? 2 : 1) * kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int ring_of = D::kRows ? 0 : wg;  // 128: one ring for both
  const WgRing<D::kR> ring{smem_u32(tiles) + D::kRingAt + ring_of * D::kR * kStage,
                           bu + 16 * D::kR * ring_of, kStage};
  uint32_t m0 = 0;
  for (uint32_t pass = 0;; ++pass) {
    const int n = flash_block_wgmma_hd<T, HD, kLse>(q, images, o, lse, sq, so, batch, group, n_q,
                                                    n_k, hd, scale, window, num_meta, tiles,
                                                    ring, pass, m0);
    if (n < 0) break;
    m0 = (uint32_t)n;
  }
}

// grid (query tiles, hq, batch), 256 threads; kLse: also the rows'
// log-sum-exp (a separate instantiation, so that serving runs the code it
// ran without it). vd = hd in (128, 256]: 64-row query tiles
template <typename T, bool kLse>
__global__ void __launch_bounds__(wgh::kWorkers, 1)
flash_fwd_kernel_wgmma256(const T* __restrict__ q, const unsigned char* __restrict__ images,
                          T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides so,
                          int batch, int group, int n_q, int n_k, int hd, float scale,
                          int window, int num_meta) {
  fwd_wgmma_hd<T, 256, kLse>(q, images, o, lse, sq, so, batch, group, n_q, n_k, hd, scale, window,
                             num_meta);
}
// vd = hd in (64, 128]: 128-row query tiles
template <typename T, bool kLse>
__global__ void __launch_bounds__(wgh::kWorkers, 1)
flash_fwd_kernel_wgmma128(const T* __restrict__ q, const unsigned char* __restrict__ images,
                          T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides so,
                          int batch, int group, int n_q, int n_k, int hd, float scale,
                          int window, int num_meta) {
  fwd_wgmma_hd<T, 128, kLse>(q, images, o, lse, sq, so, batch, group, n_q, n_k, hd, scale, window,
                             num_meta);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   Strides sq, Strides sk, Strides sv, Strides so, uint4* vflags, int batch,
                   int hq, int group, int n_q, int n_k, int hd, float scale, int window,
                   int num_meta, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD>();
  const auto kernel = lse != nullptr ? flash_fwd_kernel<T, HD, true>
                                     : flash_fwd_kernel<T, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (n_q + kBQ - 1) / kBQ;
  flash_fwd_kernel_vflags<T><<<dim3((n_k + kBK - 1) / kBK, hq / group, batch), kThreads, 0,
                               stream>>>((const T*)v, sv, vflags, n_k, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, hq, batch), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, sv, so, group, n_q, n_k, hd,
      scale, window, num_meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_nanfix<T><<<dim3(n_qt, hq / group, batch), kThreads, 0, stream>>>(
      vflags, (T*)o, so, group, n_q, n_k, hd, window, num_meta);
  return cudaGetLastError();
}

// vd > 128 or hd > 256: flash_fwd_kernel_wide between the same two
// launches, which run over V's vd columns
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, Strides sq,
                        Strides sk, Strides sv, Strides so, uint4* vflags,
                        int batch, int hq, int group, int n_q, int n_k, int hd, int vd,
                        float scale, int window, int num_meta, cudaStream_t stream) {
  const size_t bytes = sizeof(T) * ((size_t)pitch<T, kKC>() * 2 * (kBQ + kBK) +
                                    (size_t)pitch<T, kCW>() * kBK);
  const auto kernel = flash_fwd_kernel_wide<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int n_sl = (vd + kCW - 1) / kCW;
  flash_fwd_kernel_vflags<T><<<dim3((n_k + kBK - 1) / kBK, hq / group, batch), kThreads, 0,
                               stream>>>((const T*)v, sv, vflags, n_k, vd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, hq * n_sl, batch), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, group, n_q, n_k, hd, vd,
      scale, window, num_meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_nanfix<T><<<dim3(n_qt, hq / group, batch), kThreads, 0, stream>>>(
      vflags, (T*)o, so, group, n_q, n_k, vd, window, num_meta);
  return cudaGetLastError();
}

// vd != hd with vd <= 128 and hd <= 256: flash_fwd_kernel_wgmma between the
// same two launches, over V's vd columns
template <typename T, int NKC>
cudaError_t launch_wgmma_nkc(const void* q, const void* k, const void* v, void* o, float* lse,
                             Strides sq, Strides sk, Strides sv, Strides so, int batch, int hq,
                             int group, int n_q, int n_k, int hd, int vd, float scale,
                             int window, int num_meta, cudaStream_t stream) {
  // the log-sum-exp at hd <= 192, the backward's range (an instantiation
  // adds a minute to the build)
  constexpr bool kLseOk = NKC <= 3;
  if (!kLseOk && lse != nullptr) return cudaErrorInvalidValue;  // the wrapper raises before
  const auto kernel = lse != nullptr ? flash_fwd_kernel_wgmma<T, NKC, kLseOk>
                                     : flash_fwd_kernel_wgmma<T, NKC, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_q + kBQ - 1) / kBQ, hq, batch), wg::kThreads, wg::kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, sv, so, group, n_q, n_k, hd, vd,
      scale, window, num_meta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         Strides sq, Strides sk, Strides sv, Strides so, uint4* vflags, int batch,
                         int hq,
                         int group, int n_q, int n_k, int hd, int vd, float scale, int window,
                         int num_meta, cudaStream_t stream) {
  flash_fwd_kernel_vflags<T><<<dim3((n_k + kBK - 1) / kBK, hq / group, batch), kThreads, 0,
                               stream>>>((const T*)v, sv, vflags, n_k, vd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nkc = (hd + kKC - 1) / kKC;
  auto attention = nkc == 1   ? launch_wgmma_nkc<T, 1>
                   : nkc == 2 ? launch_wgmma_nkc<T, 2>
                   : nkc == 3 ? launch_wgmma_nkc<T, 3>
                              : launch_wgmma_nkc<T, 4>;
  err = attention(q, k, v, o, lse, sq, sk, sv, so, batch, hq, group, n_q, n_k, hd, vd, scale,
                  window, num_meta, stream);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel_nanfix<T><<<dim3((n_q + kBQ - 1) / kBQ, hq / group, batch), kThreads, 0,
                               stream>>>(vflags, (T*)o, so, group, n_q, n_k, vd, window,
                                         num_meta);
  return cudaGetLastError();
}

// vd = hd in (64, 256]: flash_fwd_kernel_wgmma128 (HD 128) or
// flash_fwd_kernel_wgmma256 (HD 256) between the same two launches, after
// K's and Vᵀ's images (flash_fwd_kernel_image128 or _image256)
template <typename T, int HD>
cudaError_t launch_wgmma_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                            Strides sq, Strides sk, Strides sv, Strides so, uint4* vflags,
                            unsigned char* images, int batch, int hq, int group, int n_q,
                            int n_k, int hd, float scale, int window, int num_meta,
                            cudaStream_t stream) {
  using D = wgh::Dims<HD>;
  const auto kernel =
      HD == 128 ? (lse != nullptr ? flash_fwd_kernel_wgmma128<T, true>
                                  : flash_fwd_kernel_wgmma128<T, false>)
                : (lse != nullptr ? flash_fwd_kernel_wgmma256<T, true>
                                  : flash_fwd_kernel_wgmma256<T, false>);
  const auto image = HD == 128 ? wgh::flash_fwd_kernel_image128<T>
                               : wgh::flash_fwd_kernel_image256<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         D::kSmem);
  if (err != cudaSuccess) return err;
  const int n_kt = (n_k + kBK - 1) / kBK;
  flash_fwd_kernel_vflags<T><<<dim3(n_kt, hq / group, batch), kThreads, 0, stream>>>(
      (const T*)v, sv, vflags, n_k, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  image<<<dim3(n_kt, D::kNA, batch * 2 * (hq / group)), kThreads, 0, stream>>>(
      (const T*)k, (const T*)v, sk, sv, images, batch, n_k, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kernel<<<dim3((n_q + D::kBlockRows - 1) / D::kBlockRows, hq, batch), wgh::kWorkers, D::kSmem,
           stream>>>((const T*)q, images, (T*)o, lse, sq, so, batch, group, n_q, n_k, hd, scale,
                     window, num_meta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_fwd_kernel_nanfix<T><<<dim3((n_q + kBQ - 1) / kBQ, hq / group, batch), kThreads, 0,
                               stream>>>(vflags, (T*)o, so, group, n_q, n_k, hd, window,
                                         num_meta);
  return cudaGetLastError();
}

// lse: written when not null at hd = vd and on the wgmma kernel at hd <=
// 192: the backward kernels' shapes
template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                      Strides sq, Strides sk, Strides sv, Strides so, uint4* vflags,
                      unsigned char* images, int batch, int hq, int group, int n_q, int n_k,
                      int hd, int vd, float scale, int window, int num_meta,
                      cudaStream_t stream) {
  if (vd != hd) {
    if (vd <= kCW && hd <= 4 * kKC)
      return launch_wgmma<T>(q, k, v, o, lse, sq, sk, sv, so, vflags, batch, hq, group, n_q, n_k,
                             hd, vd, scale, window, num_meta, stream);
    if (lse != nullptr) return cudaErrorInvalidValue;  // the wrapper raises before
    return launch_wide<T>(q, k, v, o, sq, sk, sv, so, vflags, batch, hq, group, n_q,
                          n_k, hd, vd, scale, window, num_meta, stream);
  }
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lse, sq, sk, sv, so, vflags, batch, hq, group, n_q, n_k,
                         hd, scale, window, num_meta, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, sq, sk, sv, so, vflags, batch, hq, group, n_q, n_k,
                         hd, scale, window, num_meta, stream);
  if (hd <= 128)
    return launch_wgmma_hd<T, 128>(q, k, v, o, lse, sq, sk, sv, so, vflags, images, batch, hq,
                                   group, n_q, n_k, hd, scale, window, num_meta, stream);
  if (hd <= 256)
    return launch_wgmma_hd<T, 256>(q, k, v, o, lse, sq, sk, sv, so, vflags, images, batch, hq,
                                   group, n_q, n_k, hd, scale, window, num_meta, stream);
  if (lse != nullptr) return cudaErrorInvalidValue;  // the wrapper raises before
  return launch_wide<T>(q, k, v, o, sq, sk, sv, so, vflags, batch, hq, group, n_q, n_k,
                        hd, hd, scale, window, num_meta, stream);
}

}  // namespace

// One translation unit by default; built as two (KERNEL_PART 0: the f32
// kernels and the entry point, 1: the bf16 kernels), compiled at once and
// linked into one library, each half instantiates its dtype's templates
// only: the longest nvcc of the kernels' build, halved.
#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif

#define FLASH_ARGS                                                                       \
  const void *q, const void *k, const void *v, void *o, const long long *strides,        \
      void *vflags, void *images, float *lse, int batch, int hq, int group, int n_q,     \
      int n_k, int hd, int vd, float scale, int window, int num_meta, void *stream
#define FLASH_CALL(T)                                                                    \
  launch_hd<T>(q, k, v, o, lse, Strides{strides[0], strides[1], strides[2]},             \
               Strides{strides[3], strides[4], strides[5]},                              \
               Strides{strides[6], strides[7], strides[8]},                              \
               Strides{strides[9], strides[10], strides[11]}, (uint4*)vflags,            \
               (unsigned char*)images, batch, hq, group, n_q, n_k, hd, vd, scale, window, \
               num_meta, (cudaStream_t)stream)

extern "C" {

#if KERNEL_PART != 1
int flash_attention_launch_f32(FLASH_ARGS) { return (int)FLASH_CALL(float); }
#endif
#if KERNEL_PART != 0
int flash_attention_launch_bf16(FLASH_ARGS) { return (int)FLASH_CALL(__nv_bfloat16); }
#else
int flash_attention_launch_bf16(FLASH_ARGS);
#endif

#if KERNEL_PART != 1
// q [batch, hq, n_q, hd], k [batch, hq/group, n_k, hd], v [batch,
// hq/group, n_k, vd], o [batch, hq, n_q, vd]; each given by its (batch,
// head, row) element strides, the head_dim stride 1; f32 when is_bf16 ==
// 0, else bf16; any hd, vd >= 1. vflags: a workspace of batch x hq/group x
// ceil(n_k / 64) x ceil(vd / 128) entries of 16 bytes, 16-byte aligned.
// images: at vd = hd in (64, 256], a workspace of 2 x batch x hq/group x
// ceil(n_k / 64) x W / 32 stages of 16 KB (W = 128 up to hd 128, else 256),
// 16-byte aligned (K's and Vᵀ's images), else unused. lse: null, or (hd =
// vd <= 256, or vd != hd with vd <= 128 and hd <= 192) [batch, hq, n_q]
// f32 that receives each row's log-sum-exp of the scaled scores for the
// backward.
// Three launches on `stream` (V's flags, the attention, the NaN of skipped
// tiles; four at vd = hd in (64, 256], the images before the attention);
// returns the first failure of cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides,  // 12: q, k, v, o x (b, h, s)
                           void* vflags, void* images, float* lse, int batch, int hq,
                           int group, int n_q, int n_k, int hd, int vd, float scale, int window,
                           int num_meta, int is_bf16, void* stream) {
  return (is_bf16 ? flash_attention_launch_bf16 : flash_attention_launch_f32)(
      q, k, v, o, strides, vflags, images, lse, batch, hq, group, n_q, n_k, hd, vd, scale,
      window, num_meta, stream);
}
#endif

}  // extern "C"
