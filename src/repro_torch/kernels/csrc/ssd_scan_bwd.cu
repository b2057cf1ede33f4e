// ssd_scan_bwd — the backward of ssd_scan.cu (the Mamba-2 chunked SSD),
// hand-written for Hopper (sm_90a).
//
// Per (b, h) and chunk c of q rows, with a = the inclusive cumsum of dt·A
// over the chunk and xd = x·dt, the forward computes
//
//   y_l        = Σ_{s<=l} (C_l·B_s) e^{a_l - a_s} xd_s  +  e^{a_l} C_l·S_in[c]
//   st[c]      = Σ_s e^{a_last - a_s} xd_s ⊗ B_s
//   S_in[c+1]  = e^{a_last} S_in[c] + st[c],   S_in[0] = the initial state,
//
// and the final state is S_in[nc]. Given dY [b, S, h, p] and the final
// state's cotangent (or none), this writes dx, d(dt), dA, dB, dC and the
// initial state's cotangent. With W = dY·xdᵀ, G = C·Bᵀ, L = e^{a_l - a_s}
// (s <= l, else 0), D_s = e^{a_last - a_s} and dst[c] = dS_in[c+1]:
//
//   d(xd)_s = Σ_{l>=s} (G∘L)_ls dY_l + D_s dst·B_s
//   dC_l    = Σ_{s<=l} dcb_ls B_s + e^{a_l} dY_l·S_in,  dcb = Σ_h W∘L
//   dB_s    = Σ_{l>=s} dcb_ls C_l + D_s dstᵀ·xd_s
//   da_l    = Σ_s (W G L)_ls - Σ_l' (W G L)_l'l + e^{a_l} C_l·(dY_l·S_in)
//             - D_l (B_l·dstᵀ)·xd_l + [l last] (Σ_s D_s (B_s·dstᵀ)·xd_s
//             + e^{a_last} Σ dS_in[c+1] ∘ S_in[c])
//
// where dS_in[c] = e^{a_last} dS_in[c+1] + Σ_l e^{a_l} dY_l ⊗ C_l. Then
// d(dt·A) is the reverse cumsum of da, dx = d(xd)·dt, d(dt) = Σ_p
// d(xd)·x + d(dt·A)·A and dA = Σ d(dt·A)·dt. Every decay is exp with
// subnormal results flushed to 0, as in the forward; the gradient through
// a flushed decay is g · 0, 0 for a finite g and NaN otherwise.
//
// Replaces: no Pallas kernel. The JAX package differentiates its jnp
// ssd_chunked (src/repro/models/ssm.py:104) by autodiff; this is the same
// gradient, computed chunk by chunk from the forward's saved incoming
// states (ssd_scan.cu's workspace after its carry pass), and it gives inf
// and NaN where that autodiff (and the port's plain version under
// autograd, whose products follow XLA's contraction order) does. That
// fixes two things about the order of the products: B and C are shared by
// the heads, so their gradient through C·Bᵀ takes the head sum dcb = Σ_h
// W∘L first and multiplies B or C after (with an inf in B, Σ_h (W∘L)·inf
// would be NaN where (Σ_h W∘L)·inf is ±inf); and the chunk state's
// products are (D∘xd)ᵀ·B and (C∘e^a)·S_inᵀ.
//
// What bounds it on the card: the bytes of x, dt, B, C and dY read and dx,
// d(dt), dB, dC written once at Hymba's shape (h 50, p 64, n 16, chunk
// 128), the operations at mamba2-130m's (h 24, p 64, n 128, chunk 256):
// per chunk and head the causal halves of W and (G∘L)ᵀ·dY and four
// products with the [p, n] states (Σ e^a dY⊗C, dY·S_in, B·dstᵀ, xd·dst; da's
// state terms reuse the second and third), and per chunk G, dcb·B and
// dcbᵀ·C, every one split-f32 on the TF32 tensor cores (tf32x3.cuh).
//
// What the design does about it. Eight launches; every product is
// mma.sync.m16n8k8 on split-f32 operands, warp w of a block's four owning
// rows 16w.. of the product; exp, the mask and the decays stay on the CUDA
// cores. A block runs on the fast split and, where a product's result holds
// an inf or NaN, again on the full split, whose products follow IEEE.
// 1. ssd_bwd_kernel_state, a block per (chunk, group of state columns, h,
//    b): the chunk's a (the forward's scan order),
//    Σ_l e^{a_l} dY_l ⊗ C_l as dYᵀ·(e^a ∘ C) over the chunk's rows, which
//    stream through two cp.async buffers; and the masks of non-finite
//    values the later passes need for the tiles they skip (below), every
//    word of them written, zero or not.
// 2. ssd_bwd_kernel_carry, a thread per (b, h, state entry): the reverse
//    recurrence over the chunks from the final state's cotangent, each
//    chunk's dst, the blocks' parts of the cotangent of its decay
//    e^{a_last}, and the initial state's cotangent.
// 3. ssd_bwd_kernel_g, a block per (tile pair at or below the diagonal,
//    chunk, b): G = C·Bᵀ, which every head shares, stored row-major: the
//    rows pass reads it in its fragment order and the cols pass as Gᵀ,
//    both with every 32-byte sector whole. The diagonal pairs' blocks also
//    OR pass 1's row flags over the heads, one flag per row.
// 4. ssd_bwd_kernel_rows, a block per (64-row tile, chunk, h, b): the
//    incoming state's terms of dC and da (da's from dC's product), then
//    for each source tile at or below the diagonal W = dY·xdᵀ, G, L, the
//    row sums of W∘G∘L (da) and their column sums (a per-tile partial of
//    da for the source rows, from the same fragments), and W∘L, stored in
//    fragment order.
// 5. ssd_bwd_kernel_cols, a block per (64-source tile, chunk, h, b): the
//    chunk state's terms (d(xd), the head's part of dB, da), then for each
//    row tile at or above the diagonal Gᵀ (G read transposed), L, and
//    d(xd) += (G∘L)ᵀ·dY with the C fragment of Gᵀ∘Lᵀ as its A fragment
//    (A's columns t and t + 4 stand for rows 2t and 2t + 1, which dY's B
//    fragment reads row-major, as flash_attention.cu reads V).
// 6. ssd_bwd_kernel_dcb, a block per (tile pair, chunk, b): dcb = Σ_h W∘L
//    over the heads in order, then dcb·B and dcbᵀ·C for the pair.
// 7. ssd_bwd_kernel_chain, a block per (chunk, h, b): da, its reverse
//    cumsum (a warp scan in a fixed order), dx, d(dt) and the chunk's part
//    of dA.
// 8. ssd_bwd_kernel_reduce: dB and dC over the heads' and the tile pairs'
//    parts, dA over the batch and the chunks, each in a fixed order.
// No float atomics: the same bits every run.
//
// Non-finite values above the diagonal. The reference takes whole chunks:
// L is 0 above the diagonal, and 0 times an inf or NaN is NaN there. The
// tile pairs passes 4-6 skip (the source tile above the row tile) hold
// only such masked pairs, and pass 1, which reads every row, summarizes
// them: per (b, h, chunk, 64-row tile) the columns of dY that hold an inf
// or NaN, per (b, chunk, tile) those of B and of C, and per row and head
// whether dY or x·dt holds one (pass 3 ORs these over the heads). From
// these, NaN goes where the masked products put it: d(xd)_s where an
// earlier tile's C, or that column of its dY, or B_s is not finite; dC_l
// where a later tile's x·dt, or that column of its B, or dY_l is not
// finite; dB_s where an earlier tile's dY, or that column of its C, or
// x_s·dt_s is not finite.
// Inside the tiles a pass visits, the masked pairs are computed as 0 · x.
// Limits: the forward's, p <= 64, n <= 256, chunk <= 1024, f32 only.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr int kR = 64;           // rows per tile (output rows, sources)
constexpr int kP = 64;           // head_dim, padded
constexpr int kPG = kP + 4;      // pitch of [row][p] tiles read as (g, t) or (2t, g)
constexpr int kPT = kP + 8;      // pitch of [row][p] tiles read as (t, g)
constexpr int kMaxChunk = 1024;
constexpr int kCarryThreads = 256;
constexpr int kChainThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kFrag = kR * kR;   // floats of a W∘L tile

// pitches (floats, multiples of 4) that put a warp's fragment reads on
// distinct banks: (row g, column t) and (row 2t, column g) at 4 mod 32,
// (row t, column g) at 8 mod 32
__host__ __device__ constexpr int pitch_g(int w) { return w + (36 - w % 32) % 32; }
__host__ __device__ constexpr int pitch_t(int w) { return w + (40 - w % 32) % 32; }

struct Args {
  const float* x;       // [b, S, h, p] strided
  const float* dt;      // [b, S, h] strided
  const float* A;       // [h]
  const float* B;       // [b, S, n] strided
  const float* C;       // [b, S, n] strided
  const float* dy;      // [b, S, h, p] strided
  const float* dfinal;  // [b, h, p, n] or null (zero)
  const float* ws;      // [b, h, nc, p, n]: the forward's incoming states
  float* acum;          // [b, h, S]: a within each chunk
  float* dst;           // [b, h, nc, p, n]: Σ_l e^{a_l} dY_l ⊗ C_l, then dst
  float* dalast;        // [b, h, nc, carry blocks]: parts of Σ dS_in[c+1] ∘ S_in[c]
  float* dinit;         // [b, h, p, n] or null
  float* dx;            // [b, S, h, p] contiguous: d(xd), then dx
  float* ddt;           // [b, S, h] contiguous
  float* dAp;           // [b, h, nc]: each chunk's part of dA
  float* dBp;           // [b, h, S, n]: each head's part of dB (the chunk state's)
  float* dCp;           // [b, h, S, n]: each head's part of dC (the incoming state's)
  float* da_row;        // [b, h, S]
  float* colsum;        // [b, h, tiles, S]: -Σ_l (W G L)_ls per row tile
  float* ddd;           // [b, h, S]: D_s B_s·dstᵀ·xd_s
  float* wl;            // [b, h, nc, pairs, 64 x 64]: W∘L per tile pair, fragment order
  float* gf;            // [b, nc, pairs, 64 x 64]: G = C·Bᵀ per tile pair, row-major
  float* dBq;           // [b, tiles, S, n]: dcbᵀ·C per row tile
  float* dCq;           // [b, tiles, S, n]: dcb·B per source tile
  unsigned long long* fl_dy;  // [b, h, nc, tiles]: dY's non-finite p columns
  unsigned long long* fl_B;   // [b, nc, tiles, 4]: B's non-finite n columns
  unsigned long long* fl_C;   // [b, nc, tiles, 4]: C's
  uint8_t* rowbits;     // [b, S, h]: bit 0 dY, bit 1 x·dt hold an inf or NaN
  int* rowflag;         // [b, S]: rowbits ORed over the heads
  float* dA;            // [h]
  float* dB;            // [b, S, n] contiguous
  float* dC;            // [b, S, n] contiguous
  long long xs_b, xs_s, xs_h, ds_b, ds_s, ds_h, bs_b, bs_s, cs_b, cs_s, ys_b, ys_s, ys_h;
  int batch, seq, heads, p, n, chunk, nc, tiles, pairs;
  int n_pad;     // n in whole groups of state columns
  int ngroups;   // groups of 8·NJ state columns
  int nbuf;      // passes 3 and 4: tile buffers (1 or 2)
};

// exp with subnormal results flushed to 0 (ssd_scan.cu's exp_ftz)
__device__ __forceinline__ float exp_ftz(float z) {
  const float e = expf(z);
  return e < 1.17549435e-38f ? 0.f : e;  // FLT_MIN; a NaN stays NaN
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum over a lane quad (the four lanes of one fragment row)
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// Stage rows [0, rows) of a [*, cols_pad] f32 tile with pitch `pitch` from
// `src` (row r at src + r * stride), cp.async per 16-byte chunk; rows past
// `rows_valid` and columns past `cols_valid` load zeros.
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src, long long stride,
                                      int rows, int rows_valid, int cols_pad, int cols_valid) {
  const int cpr = cols_pad / 4;
  for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * 4;
    const int nbytes = r < rows_valid && c < cols_valid ? min(4, cols_valid - c) * 4 : 0;
    cp_async::chunk16(dst + r * pitch + c, nbytes ? src + r * stride + c : src, nbytes);
  }
}

// acc[j] += A·B over `ksteps` k8 steps: fa(row, k) gives A for the warp's
// 16 rows (row 0..15), fb(k, col) B for columns 8j + g
template <bool kFull, int NJ, class FA, class FB>
__device__ __forceinline__ void mma_ab(float (&acc)[NJ][4], int ksteps, int g, int t, FA fa,
                                       FB fb) {
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 8 + t;
    uint32_t ah[4], al[4];
    tf32x3::split_as<kFull>(fa(g, k0), ah[0], al[0]);
    tf32x3::split_as<kFull>(fa(g + 8, k0), ah[1], al[1]);
    tf32x3::split_as<kFull>(fa(g, k0 + 4), ah[2], al[2]);
    tf32x3::split_as<kFull>(fa(g + 8, k0 + 4), ah[3], al[3]);
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      tf32x3::split_as<kFull>(fb(k0, j * 8 + g), bh[j][0], bl[j][0]);
      tf32x3::split_as<kFull>(fb(k0 + 4, j * 8 + g), bh[j][1], bl[j][1]);
    }
    tf32x3::mma_split<NJ, false, false>(acc, ah, al, bh, bl);
  }
}

// acc[j] += M·B over k = 0..63, M the warp's 16 x 64 matrix whose C
// fragments the caller holds (m[kk]: columns 8kk + 2t, + 1 of rows g,
// g + 8): A's columns t and t + 4 stand for 2t and 2t + 1, so M's C
// fragment is its A fragment; fb(k, col) gives B for columns 8j + g
template <bool kFull, int NJ, class FB>
__device__ __forceinline__ void mma_mb(float (&acc)[NJ][4], const float (&m)[8][4], int g, int t,
                                       FB fb) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    tf32x3::split_as<kFull>(m[kk][0], ah[0], al[0]);
    tf32x3::split_as<kFull>(m[kk][2], ah[1], al[1]);
    tf32x3::split_as<kFull>(m[kk][1], ah[2], al[2]);
    tf32x3::split_as<kFull>(m[kk][3], ah[3], al[3]);
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      tf32x3::split_as<kFull>(fb(kk * 8 + 2 * t, j * 8 + g), bh[j][0], bl[j][0]);
      tf32x3::split_as<kFull>(fb(kk * 8 + 2 * t + 1, j * 8 + g), bh[j][1], bl[j][1]);
    }
    tf32x3::mma_split<NJ, false, false>(acc, ah, al, bh, bl);
  }
}

// The chunk's dt (dtv) and inclusive cumsum of dt·A (a_cum): ssd_scan.cu's
// chunk_scan (each lane of warp 0 scans a run, then a warp scan of the
// runs), except that a run's offset is the previous lane's inclusive sum,
// not this lane's inclusive sum minus its run: where a run holds an inf,
// inf - inf would make its rows NaN where the reference's cumsum is ±inf
// (the forward's outputs are NaN there either way; its gradients are not).
// Starts and ends with a barrier.
__device__ __forceinline__ void chunk_scan(float* a_cum, float* dtv, const float* dtc,
                                           long long ds_s, float A, int q) {
  const int tid = threadIdx.x;
  for (int i = tid; i < q; i += kThreads) {
    const float d = dtc[i * ds_s];
    dtv[i] = d;
    a_cum[i] = d * A;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (q + 31) / 32;
    const int lo = min(tid * per, q), hi = min(lo + per, q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += a_cum[i];
      a_cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
    const float before = tid > 0 ? prev : 0.f;
    for (int i = lo; i < hi; ++i) a_cum[i] += before;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. a, Σ_l e^{a_l} dY_l ⊗ C_l per chunk, and the masks of non-finite values
// ---------------------------------------------------------------------------

template <int NJ>
constexpr size_t state_smem() {
  return sizeof(float) * (3 * kMaxChunk + 2 * kR * (kPT + pitch_t(8 * NJ)));
}

template <int NJ, bool kSlow>
__device__ __forceinline__ bool state_block(const Args& a) {
  constexpr int GW = 8 * NJ;             // the group's state columns
  constexpr int PC = pitch_t(GW);
  extern __shared__ __align__(16) float smem[];
  float* a_cum = smem;                   // [kMaxChunk]
  float* dtv = a_cum + kMaxChunk;        // [kMaxChunk]
  float* sdv = dtv + kMaxChunk;          // [kMaxChunk]: e^{a_l}
  float* bufs = sdv + kMaxChunk;         // 2 x ([kR][kPT] dY, [kR][PC] C)
  constexpr int kBuf = kR * (kPT + PC);
  __shared__ unsigned long long mask_s;

  const int Q = a.chunk, P = a.p, N = a.n;
  const int c = blockIdx.x / a.ngroups, grp = blockIdx.x % a.ngroups;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.heads + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pr = warp * 16;
  const long long row_c = (long long)c * Q;
  const float* dyc = a.dy + b * a.ys_b + row_c * a.ys_s + h * a.ys_h;
  const float* Cc = a.C + b * a.cs_b + row_c * a.cs_s + grp * GW;
  const int n_valid = min(GW, N - grp * GW);
  auto issue = [&](int lt) {
    float* buf = bufs + (lt & 1) * kBuf;
    const int l0 = lt * kR;
    stage(buf, kPT, dyc + l0 * a.ys_s, a.ys_s, kR, Q - l0, kP, P);
    stage(buf + kR * kPT, PC, Cc + l0 * a.cs_s, a.cs_s, kR, Q - l0, GW, n_valid);
  };
  issue(0);
  cp_async::commit();

  chunk_scan(a_cum, dtv, a.dt + b * a.ds_b + row_c * a.ds_s + h * a.ds_h, a.ds_s, a.A[h], Q);
  for (int i = tid; i < Q; i += kThreads) {
    sdv[i] = exp_ftz(a_cum[i]);
    if (grp == 0 && !kSlow) a.acum[bh * a.seq + row_c + i] = a_cum[i];
  }

  float acc[NJ][4];
  zero(acc);
  for (int lt = 0; lt < a.tiles; ++lt) {
    cp_async::wait<0>();
    __syncthreads();  // tile lt staged (and sdv written); all warps done with lt - 1
    if (lt + 1 < a.tiles) issue(lt + 1);
    cp_async::commit();
    const float* dys = bufs + (lt & 1) * kBuf;
    const float* cs = dys + kR * kPT;
    const int l0 = lt * kR, rows = min(kR, Q - l0);
    // acc += dYᵀ·(e^a ∘ C): state rows p (pr + r), k the tile's rows; the
    // tile's product rounds into acc at the add
    float tile[NJ][4];
    zero(tile);
    mma_ab<kSlow, NJ>(
        tile, kR / 8, g, t, [&](int r, int k) { return dys[k * kPT + pr + r]; },
        [&](int k, int col) { return k < rows ? cs[k * PC + col] * sdv[l0 + k] : 0.f; });
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += tile[j][e];
    if constexpr (!kSlow) {
      // the masks (they do not depend on the split): dY's columns and rows,
      // x·dt's rows (group 0), B's and C's columns (head 0)
      const long long grow = row_c + l0;  // the tile's first row in S
      if (grp == 0) {
        if (tid == 0) mask_s = 0ull;
        __syncthreads();
        if (tid < P) {
          bool bad = false;
          for (int r = 0; r < rows; ++r) bad |= !tf32x3::finite(dys[r * kPT + tid]);
          if (bad) atomicOr(&mask_s, 1ull << tid);
        }
        // a thread per (row, half of the columns), its loads independent
        {
          const int r = tid >> 1, half = tid & 1;
          bool bad_y = false, bad_x = false;
          if (r < rows) {
            const float* xr = a.x + b * a.xs_b + (grow + r) * a.xs_s + h * a.xs_h;
            const float dtr = dtv[l0 + r];
#pragma unroll 8
            for (int k = 0; k < kP / 2; ++k) {
              const int pp = half * (kP / 2) + k;
              if (pp < P) {
                bad_y |= !tf32x3::finite(dys[r * kPT + pp]);
                bad_x |= !tf32x3::finite(xr[pp] * dtr);
              }
            }
          }
          bad_y |= __shfl_xor_sync(0xffffffffu, (int)bad_y, 1) != 0;
          bad_x |= __shfl_xor_sync(0xffffffffu, (int)bad_x, 1) != 0;
          const int bits = (bad_y ? 1 : 0) | (bad_x ? 2 : 0);
          if (half == 0 && r < rows)
            a.rowbits[((long long)b * a.seq + grow + r) * a.heads + h] = (uint8_t)bits;
        }
        __syncthreads();
        if (tid == 0) a.fl_dy[(bh * a.nc + c) * a.tiles + lt] = mask_s;
      }
      if (h == 0) {
        // group grp owns word (grp·GW) / 64 of the 256 column bits (GW < 64
        // only where one group covers n); group 0 also zeroes the words no
        // group owns
        const int word = (grp * GW) / 64, bit0 = (grp * GW) % 64;
        const long long fi = (((long long)b * a.nc + c) * a.tiles + lt) * 4 + word;
        if (grp == 0 && tid >= a.ngroups && tid < 4) {
          a.fl_B[fi + tid] = 0ull;
          a.fl_C[fi + tid] = 0ull;
        }
        for (int which = 0; which < 2; ++which) {
          __syncthreads();
          if (tid == 0) mask_s = 0ull;
          __syncthreads();
          if (tid < n_valid) {
            bool bad = false;
            if (which == 0) {
              for (int r = 0; r < rows; ++r) bad |= !tf32x3::finite(cs[r * PC + tid]);
            } else {
              const float* Bc = a.B + b * a.bs_b + grow * a.bs_s + grp * GW + tid;
              for (int r = 0; r < rows; ++r) bad |= !tf32x3::finite(Bc[r * a.bs_s]);
            }
            if (bad) atomicOr(&mask_s, 1ull << (bit0 + tid));
          }
          __syncthreads();
          if (tid == 0) (which == 0 ? a.fl_C : a.fl_B)[fi] = mask_s;
        }
      }
    }
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    if (__syncthreads_or(!all_finite(acc))) return true;  // all warps done with the buffers
  }
  float* out = a.dst + (bh * a.nc + c) * (long long)P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pp = pr + g + 8 * half;
    if (pp >= P) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nn = grp * GW + j * 8 + 2 * t;
      if (nn < N) out[pp * N + nn] = acc[j][2 * half];
      if (nn + 1 < N) out[pp * N + nn + 1] = acc[j][2 * half + 1];
    }
  }
  return false;
}

template <int NJ>
__device__ __noinline__ void state_block_full(const Args& a) {
  state_block<NJ, true>(a);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_state(const __grid_constant__ Args a) {
  if (state_block<NJ, false>(a)) state_block_full<NJ>(a);
}

// ---------------------------------------------------------------------------
// 2. the reverse recurrence over the chunks
// ---------------------------------------------------------------------------

// One thread per (b, h, state entry), the chunks in reverse with kAhead
// chunks' loads in flight; each block writes its part of Σ dS_in[c+1] ∘
// S_in[c] per chunk, which the chain pass sums in block order.
__global__ void __launch_bounds__(kCarryThreads) ssd_bwd_kernel_carry(const __grid_constant__ Args a) {
  constexpr int kAhead = 8;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk;
  const long long pn = (long long)a.p * a.n;
  const long long bh = (long long)b * a.heads + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e = (long long)blockIdx.x * kCarryThreads + tid;
  const bool live = e < pn;
  __shared__ float red[kCarryThreads / 32][kAhead];
  float g = (live && a.dfinal != nullptr) ? a.dfinal[bh * pn + e] : 0.f;  // dS_in[c + 1]
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= kAhead) {
    float local[kAhead], st[kAhead], decay[kAhead], part[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = c0 - i;
      const long long slot = (bh * a.nc + c) * pn + e;
      local[i] = c >= 0 && live ? a.dst[slot] : 0.f;
      st[i] = c >= 0 && live ? a.ws[slot] : 0.f;
      decay[i] = c >= 0 ? exp_ftz(a.acum[bh * a.seq + (long long)c * Q + Q - 1]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = c0 - i;
      part[i] = 0.f;
      if (c < 0) continue;
      part[i] = g * st[i];
      if (live) a.dst[(bh * a.nc + c) * pn + e] = g;
      g = fmaf(decay[i], g, local[i]);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float v = sum32(part[i]);
      if (lane == 0) red[warp][i] = v;
    }
    __syncthreads();
    if (tid < kAhead && c0 - tid >= 0) {
      float sum = 0.f;
      for (int w = 0; w < kCarryThreads / 32; ++w) sum += red[w][tid];
      a.dalast[(bh * a.nc + c0 - tid) * gridDim.x + blockIdx.x] = sum;
    }
    __syncthreads();  // red is rewritten by the next group
  }
  if (a.dinit != nullptr && live) a.dinit[bh * pn + e] = g;
}

// ---------------------------------------------------------------------------
// 3. per tile pair: G = C·Bᵀ, the same for every head; per row the flags
//    of every head
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t g_smem(int n_pad) {
  return sizeof(float) * 2 * (size_t)kR * pitch_g(n_pad);
}

template <bool kSlow>
__device__ __forceinline__ bool g_block(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int PG = pitch_g(a.n_pad);
  float* Cl = smem;                 // [kR][PG]: C of the row tile
  float* Bs = Cl + kR * PG;         // [kR][PG]: B of the source tile
  const int Q = a.chunk, N = a.n;
  const int pair = blockIdx.x % a.pairs, c = blockIdx.x / a.pairs;
  const int b = blockIdx.y;
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= pair) ++lt;
  const int st = pair - lt * (lt + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int l0 = lt * kR, s0 = st * kR;
  stage(Cl, PG, a.C + b * a.cs_b + ((long long)c * Q + l0) * a.cs_s, a.cs_s, kR,
        min(kR, Q - l0), a.n_pad, N);
  stage(Bs, PG, a.B + b * a.bs_b + ((long long)c * Q + s0) * a.bs_s, a.bs_s, kR,
        min(kR, Q - s0), a.n_pad, N);
  cp_async::commit();
  cp_async::wait<0>();
  __syncthreads();
  const int nks = a.n_pad / 8;
  float gg[8][4];
  zero(gg);
  mma_ab<kSlow, 8>(
      gg, nks, g, t, [&](int r, int k) { return Cl[(wr + r) * PG + k]; },
      [&](int k, int col) { return Bs[col * PG + k]; });
  if constexpr (!kSlow) {
    if (__syncthreads_or(!all_finite(gg))) return true;
  }
  float* go = a.gf + (((long long)b * a.nc + c) * a.pairs + pair) * kFrag;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(go + (wr + g + 8 * r) * kR + j * 8 + 2 * t) =
          make_float2(gg[j][2 * r], gg[j][2 * r + 1]);
  return false;
}

__device__ __noinline__ void g_block_full(const Args& a) { g_block<true>(a); }

__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_g(const __grid_constant__ Args a) {
  const int pair = blockIdx.x % a.pairs;
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= pair) ++lt;
  if (pair == lt * (lt + 1) / 2 + lt && threadIdx.x < kR) {
    // the diagonal pair's rows: pass 1's flags ORed over the heads
    const int c = blockIdx.x / a.pairs, b = blockIdx.y;
    const int l = lt * kR + threadIdx.x;
    if (l < a.chunk) {
      const long long row = (long long)b * a.seq + (long long)c * a.chunk + l;
      const uint8_t* rb = a.rowbits + row * a.heads;
      int bits = 0;
      for (int hh = 0; hh < a.heads; ++hh) bits |= rb[hh];
      a.rowflag[row] = bits;
    }
  }
  if (g_block<false>(a)) g_block_full(a);
}

// ---------------------------------------------------------------------------
// 4. per row tile: the incoming state's terms, W∘L and da's row and column
//    sums for the source tiles at or below it
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t rows_smem(int n_pad, int nbuf) {
  const int PG = pitch_g(n_pad);
  const size_t bufs = (size_t)nbuf * (kR * kPG + 2 * kR);
  return sizeof(float) * ((size_t)kR * (PG + kPG) + 5 * kR +
                          (bufs > (size_t)kP * PG ? bufs : (size_t)kP * PG));
}

template <int NJ, bool kSlow>
__device__ __forceinline__ bool rows_block(const Args& a) {
  constexpr int GW = 8 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int PG = pitch_g(a.n_pad);
  float* Cl = smem;                 // [kR][PG]: C of the row tile
  float* dYl = Cl + kR * PG;        // [kR][kPG]: dY of the row tile
  float* al = dYl + kR * kPG;       // [kR]
  float* red = al + kR;             // [4][kR]: the warps' column sums
  float* bufs = red + 4 * kR;       // nbuf x ([kR][kPG] x, [kR] dt, [kR] a)
  const int kBuf = kR * kPG + 2 * kR;
  float* Sin = bufs;                // [kP][PG]: S_in, before the source tiles

  const int Q = a.chunk, P = a.p, N = a.n;
  const int c = blockIdx.x / a.tiles, lt = blockIdx.x % a.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.heads + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int l0 = lt * kR, rows = min(kR, Q - l0);
  const long long row0 = (long long)c * Q + l0;  // in S

  stage(Cl, PG, a.C + b * a.cs_b + row0 * a.cs_s, a.cs_s, kR, rows, a.n_pad, N);
  stage(dYl, kPG, a.dy + b * a.ys_b + row0 * a.ys_s + h * a.ys_h, a.ys_s, kR, rows, kP, P);
  stage(Sin, PG, a.ws + (bh * a.nc + c) * (long long)P * N, N, kP, P, a.n_pad, N);
  cp_async::commit();
  if (tid < kR) al[tid] = tid < rows ? a.acum[bh * a.seq + row0 + tid] : 0.f;
  cp_async::wait<0>();
  __syncthreads();

  bool bad = false;
  // the incoming state's terms: F = dY·S_in, dC = e^{a_l} F (this head's
  // part) and da = e^{a_l} Σ_n F ∘ C, the reference's order (its y takes
  // (C ∘ e^a)·S_inᵀ)
  float el[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wr + g + 8 * r;
    el[r] = lr < rows ? exp_ftz(al[lr]) : 0.f;
  }
  auto fa_dy = [&](int r, int k) { return dYl[(wr + r) * kPG + k]; };
  float da_y[2] = {0.f, 0.f}, da_w[2] = {0.f, 0.f};
  for (int grp = 0; grp < a.ngroups; ++grp) {
    float f[NJ][4];
    zero(f);
    mma_ab<kSlow, NJ>(f, kP / 8, g, t, fa_dy,
                      [&](int k, int col) { return Sin[k * PG + grp * GW + col]; });
    if constexpr (!kSlow) bad |= !all_finite(f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = wr + g + 8 * r;
      if (lr >= rows) continue;
      float* out = a.dCp + (bh * a.seq + row0 + lr) * N;
      const float* cr = Cl + lr * PG;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nn = grp * GW + j * 8 + 2 * t;
        if (nn < N) {
          out[nn] = f[j][2 * r] * el[r];
          da_y[r] += f[j][2 * r] * cr[nn];
        }
        if (nn + 1 < N) {
          out[nn + 1] = f[j][2 * r + 1] * el[r];
          da_y[r] += f[j][2 * r + 1] * cr[nn + 1];
        }
      }
    }
  }
  __syncthreads();  // S_in consumed: the buffers take the source tiles

  auto issue = [&](int st) {
    float* buf = bufs + (a.nbuf == 2 ? (st & 1) : 0) * kBuf;
    const int s0 = st * kR, srows = min(kR, Q - s0);
    const long long srow0 = (long long)c * Q + s0;
    stage(buf, kPG, a.x + b * a.xs_b + srow0 * a.xs_s + h * a.xs_h, a.xs_s, kR, srows, kP, P);
    if (tid < kR) {
      buf[kR * kPG + tid] =
          tid < srows ? a.dt[b * a.ds_b + (srow0 + tid) * a.ds_s + h * a.ds_h] : 0.f;
      buf[kR * kPG + kR + tid] = tid < srows ? a.acum[bh * a.seq + srow0 + tid] : 0.f;
    }
  };
  issue(0);
  cp_async::commit();
  const int pair0 = lt * (lt + 1) / 2;
  for (int st = 0; st <= lt; ++st) {
    cp_async::wait<0>();
    __syncthreads();  // tile st staged; all warps done with the other buffer
    if (a.nbuf == 2 && st < lt) issue(st + 1);
    cp_async::commit();
    const float* xs = bufs + (a.nbuf == 2 ? (st & 1) : 0) * kBuf;
    const float* dts = xs + kR * kPG;
    const float* as = dts + kR;
    const int s0 = st * kR, srows = min(kR, Q - s0);

    // W = dY·xdᵀ: the warp's 16 rows x 64 sources; G = C·Bᵀ from pass 3
    // (the same for every head), read in the same fragment order
    float w[8][4], gg[8][4];
    zero(w);
    mma_ab<kSlow, 8>(w, kP / 8, g, t, fa_dy,
                     [&](int k, int col) { return xs[col * kPG + k] * dts[col]; });
    if constexpr (!kSlow) bad |= !all_finite(w);
    {
      const float* gsrc = a.gf + (((long long)b * a.nc + c) * a.pairs + pair0 + st) * kFrag;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v =
              *reinterpret_cast<const float2*>(gsrc + (wr + g + 8 * r) * kR + j * 8 + 2 * t);
          gg[j][2 * r] = v.x;
          gg[j][2 * r + 1] = v.y;
        }
    }
    float cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wr + g + 8 * (e >> 1), sr = j * 8 + 2 * t + (e & 1);
        const int l = l0 + lr, s = s0 + sr;
        const bool vis = s <= l && l < Q;
        const float L = vis ? exp_ftz(al[lr] - as[sr]) : 0.f;
        const float wl = w[j][e] * L;
        // da's terms: exactly 0 at masked pairs, as the reference's masked
        // segment sums get no gradient
        const float v = vis ? wl * gg[j][e] : 0.f;
        da_w[e >> 1] += v;
        if (e < 2) cs[j][e] = v;
        else cs[j][e - 2] += v;
        w[j][e] = wl;
      }
    }
    // W∘L in fragment order: lane (warp, lane) holds 32 floats
    float4* wlo = reinterpret_cast<float4*>(
        a.wl + ((bh * a.nc + c) * a.pairs + pair0 + st) * kFrag + (warp * 32 + lane) * 32);
#pragma unroll
    for (int j = 0; j < 8; ++j) wlo[j] = make_float4(w[j][0], w[j][1], w[j][2], w[j][3]);
    // the column sums: over g in the warp, then over the warps in order
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp * kR + j * 8 + 2 * t + e] = v;
      }
    __syncthreads();
    if (tid < srows)
      a.colsum[(bh * a.tiles + lt) * a.seq + (long long)c * Q + s0 + tid] =
          -(((red[tid] + red[kR + tid]) + red[2 * kR + tid]) + red[3 * kR + tid]);
    if (a.nbuf == 1 && st < lt) {
      __syncthreads();  // all warps done with the buffer (and red)
      issue(st + 1);
    }
    if (a.nbuf == 1) cp_async::commit();
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    if (__syncthreads_or(bad)) return true;  // all warps done with the buffers
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float d = sum4(da_y[r]) * el[r] + sum4(da_w[r]);
    const int lr = wr + g + 8 * r;
    if (t == 0 && lr < rows) a.da_row[bh * a.seq + row0 + lr] = d;
  }
  return false;
}

template <int NJ>
__device__ __noinline__ void rows_block_full(const Args& a) {
  rows_block<NJ, true>(a);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_rows(const __grid_constant__ Args a) {
  if (rows_block<NJ, false>(a)) rows_block_full<NJ>(a);
}

// ---------------------------------------------------------------------------
// 5. per source tile: the chunk state's terms and d(xd) for the row tiles at
//    or above it
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t cols_smem(int n_pad, int nbuf) {
  const int PG = pitch_g(n_pad);
  const size_t bufs = (size_t)nbuf * (kR * kPG + kR);
  return sizeof(float) * ((size_t)kR * (PG + kPG) + 3 * kR +
                          (bufs > (size_t)kP * PG ? bufs : (size_t)kP * PG));
}

template <int NJ, bool kSlow>
__device__ __forceinline__ bool cols_block(const Args& a) {
  constexpr int GW = 8 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int PG = pitch_g(a.n_pad);
  float* Bs = smem;                    // [kR][PG]: B of the source tile
  float* xs = Bs + kR * PG;            // [kR][kPG]: x of the source tile
  float* dts = xs + kR * kPG;          // [kR]
  float* as = dts + kR;                // [kR]
  int* badB = reinterpret_cast<int*>(as + kR);  // [kR]: B_s holds an inf or NaN
  float* bufs = as + 2 * kR;           // nbuf x ([kR][kPG] dY, [kR] a)
  const int kBuf = kR * kPG + kR;
  float* dsts = bufs;                  // [kP][PG]: dst, before the row tiles

  const int Q = a.chunk, P = a.p, N = a.n;
  const int c = blockIdx.x / a.tiles, st = blockIdx.x % a.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.heads + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int s0 = st * kR, srows = min(kR, Q - s0);
  const long long srow0 = (long long)c * Q + s0;
  const int nks = a.n_pad / 8;

  stage(Bs, PG, a.B + b * a.bs_b + srow0 * a.bs_s, a.bs_s, kR, srows, a.n_pad, N);
  stage(xs, kPG, a.x + b * a.xs_b + srow0 * a.xs_s + h * a.xs_h, a.xs_s, kR, srows, kP, P);
  stage(dsts, PG, a.dst + (bh * a.nc + c) * (long long)P * N, N, kP, P, a.n_pad, N);
  cp_async::commit();
  if (tid < kR) {
    dts[tid] = tid < srows ? a.dt[b * a.ds_b + (srow0 + tid) * a.ds_s + h * a.ds_h] : 0.f;
    as[tid] = tid < srows ? a.acum[bh * a.seq + srow0 + tid] : 0.f;
  }
  const float a_last = a.acum[bh * a.seq + (long long)c * Q + Q - 1];
  cp_async::wait<0>();
  __syncthreads();
  if (tid < kR) {
    bool bad_b = false;
    for (int nn = 0; nn < N; ++nn) bad_b |= !tf32x3::finite(Bs[tid * PG + nn]);
    badB[tid] = tid < srows && bad_b;
  }

  bool bad = false;
  float D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sr = wr + g + 8 * r;
    D[r] = sr < srows ? exp_ftz(a_last - as[sr]) : 0.f;
  }
  auto fa_b = [&](int r, int k) { return Bs[(wr + r) * PG + k]; };
  auto fa_xd = [&](int r, int k) { return xs[(wr + r) * kPG + k] * dts[wr + r]; };
  // the chunk state's terms: E = B·dstᵀ, d(xd) = D E, dd = Σ_p E ∘ xd, and
  // this head's part of dB, (D ∘ xd)·dst
  float accX[8][4];
  zero(accX);
  mma_ab<kSlow, 8>(accX, nks, g, t, fa_b, [&](int k, int col) { return dsts[col * PG + k]; });
  if constexpr (!kSlow) bad |= !all_finite(accX);
  float dd[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sr = wr + g + 8 * (e >> 1), pp = j * 8 + 2 * t + (e & 1);
      dd[e >> 1] += accX[j][e] * (xs[sr * kPG + pp] * dts[sr]);
      accX[j][e] *= D[e >> 1];
    }
  for (int grp = 0; grp < a.ngroups; ++grp) {
    float f[NJ][4];
    zero(f);
    mma_ab<kSlow, NJ>(f, kP / 8, g, t, fa_xd,
                      [&](int k, int col) { return dsts[k * PG + grp * GW + col]; });
    if constexpr (!kSlow) bad |= !all_finite(f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sr = wr + g + 8 * r;
      if (sr >= srows) continue;
      float* out = a.dBp + (bh * a.seq + srow0 + sr) * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nn = grp * GW + j * 8 + 2 * t;
        if (nn < N) out[nn] = f[j][2 * r] * D[r];
        if (nn + 1 < N) out[nn + 1] = f[j][2 * r + 1] * D[r];
      }
    }
  }
  __syncthreads();  // dst consumed: the buffers take the row tiles

  auto issue = [&](int lt) {
    float* buf = bufs + (a.nbuf == 2 ? (lt & 1) : 0) * kBuf;
    const int l0 = lt * kR, rows = min(kR, Q - l0);
    const long long row0 = (long long)c * Q + l0;
    stage(buf, kPG, a.dy + b * a.ys_b + row0 * a.ys_s + h * a.ys_h, a.ys_s, kR, rows, kP, P);
    if (tid < kR) buf[kR * kPG + tid] = tid < rows ? a.acum[bh * a.seq + row0 + tid] : 0.f;
  };
  issue(st);
  cp_async::commit();
  for (int lt = st; lt < a.tiles; ++lt) {
    cp_async::wait<0>();
    __syncthreads();  // tile lt staged; all warps done with the other buffer
    if (a.nbuf == 2 && lt + 1 < a.tiles) issue(lt + 1);
    cp_async::commit();
    const float* dYl = bufs + (a.nbuf == 2 ? (lt & 1) : 0) * kBuf;
    const float* al = dYl + kR * kPG;
    const int l0 = lt * kR;

    // Gᵀ: pass 3's G read transposed (the warp's 16 sources x 64 rows in
    // C-fragment order: a lane quad reads 8 consecutive sources of a row),
    // then Gᵀ ∘ Lᵀ in place
    float m[8][4];
    {
      const float* gsrc =
          a.gf + (((long long)b * a.nc + c) * a.pairs + lt * (lt + 1) / 2 + st) * kFrag;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[j][e] = gsrc[(j * 8 + 2 * t + (e & 1)) * kR + wr + g + 8 * (e >> 1)];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sr = wr + g + 8 * (e >> 1), lr = j * 8 + 2 * t + (e & 1);
        const int s = s0 + sr, l = l0 + lr;
        m[j][e] *= (s <= l && l < Q) ? exp_ftz(al[lr] - as[sr]) : 0.f;
      }
    // d(xd) += (G∘L)ᵀ·dY: the tile's product rounds into accX at the add
    // (the tensor cores' f32 accumulation is not rounded to nearest)
    float tile[8][4];
    zero(tile);
    mma_mb<kSlow, 8>(tile, m, g, t, [&](int k, int col) { return dYl[k * kPG + col]; });
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accX[j][e] += tile[j][e];
    if (a.nbuf == 1 && lt + 1 < a.tiles) {
      __syncthreads();  // all warps done with the buffer
      issue(lt + 1);
    }
    if (a.nbuf == 1) cp_async::commit();
  }
  cp_async::wait<0>();
  if constexpr (!kSlow) {
    if (__syncthreads_or(bad || !all_finite(accX))) return true;
  }

  // the row tiles skipped (above this source tile: every pair masked):
  // (C·Bᵀ)·0·dY is NaN where an earlier C row or B_s holds an inf or NaN
  // (every column), or that column of an earlier dY row does
  bool all_p = false;
  unsigned long long pmask = 0ull;
  for (int tt = 0; tt < st; ++tt) {
    const unsigned long long* fc = a.fl_C + (((long long)b * a.nc + c) * a.tiles + tt) * 4;
    all_p |= (fc[0] | fc[1] | fc[2] | fc[3]) != 0ull;
    pmask |= a.fl_dy[(bh * a.nc + c) * a.tiles + tt];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sr = wr + g + 8 * r;
    if (sr >= srows) continue;
    const bool row_nan = st > 0 && (all_p || badB[sr]);
    float* dxr = a.dx + (((long long)b * a.seq + srow0 + sr) * a.heads + h) * P;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pp = j * 8 + 2 * t + e;
        if (pp < P)
          dxr[pp] = (row_nan || ((pmask >> pp) & 1ull)) ? nan_f32() : accX[j][2 * r + e];
      }
    const float ddD = sum4(dd[r]) * D[r];
    if (t == 0) a.ddd[bh * a.seq + srow0 + sr] = ddD;
  }
  return false;
}

template <int NJ>
__device__ __noinline__ void cols_block_full(const Args& a) {
  cols_block<NJ, true>(a);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_cols(const __grid_constant__ Args a) {
  if (cols_block<NJ, false>(a)) cols_block_full<NJ>(a);
}

// ---------------------------------------------------------------------------
// 6. per tile pair: dcb = Σ_h W∘L, then dcb·B and dcbᵀ·C
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t dcb_smem(int n_pad) {
  return sizeof(float) * ((size_t)kR * kPT + (size_t)kR * pitch_g(n_pad) +
                          (size_t)kR * pitch_t(n_pad));
}

template <int NJ, bool kSlow>
__device__ __forceinline__ bool dcb_block(const Args& a) {
  constexpr int GW = 8 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int PG = pitch_g(a.n_pad), PT = pitch_t(a.n_pad);
  float* Ds = smem;                 // [kR][kPT]: dcb [row][source]
  float* Bs = Ds + kR * kPT;        // [kR][PG]: B of the source tile, read as (2t, g)
  float* Cl = Bs + kR * PG;         // [kR][PT]: C of the row tile, read as (t, g)

  const int Q = a.chunk, N = a.n;
  const int pair = blockIdx.x % a.pairs, c = blockIdx.x / a.pairs;
  const int b = blockIdx.y;
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= pair) ++lt;
  const int st = pair - lt * (lt + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int l0 = lt * kR, rows = min(kR, Q - l0);
  const int s0 = st * kR, srows = min(kR, Q - s0);
  const long long row0 = (long long)c * Q + l0, srow0 = (long long)c * Q + s0;

  stage(Bs, PG, a.B + b * a.bs_b + srow0 * a.bs_s, a.bs_s, kR, srows, a.n_pad, N);
  stage(Cl, PT, a.C + b * a.cs_b + row0 * a.cs_s, a.cs_s, kR, rows, a.n_pad, N);
  cp_async::commit();

  // the head sum, in head order, in W∘L's fragment order
  float m[8][4];
  zero(m);
  const long long hstride = (long long)a.nc * a.pairs * kFrag;
  const float4* src = reinterpret_cast<const float4*>(
      a.wl + (((long long)b * a.heads * a.nc + c) * a.pairs + pair) * kFrag +
      (warp * 32 + lane) * 32);
  for (int hh = 0; hh < a.heads; ++hh) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = src[hh * (hstride / 4) + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[j][0] += v[j].x;
      m[j][1] += v[j].y;
      m[j][2] += v[j].z;
      m[j][3] += v[j].w;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Ds[(wr + g + 8 * (e >> 1)) * kPT + j * 8 + 2 * t + (e & 1)] = m[j][e];
  cp_async::wait<0>();
  __syncthreads();

  // the pairs the passes skip, summarized for the diagonal pair: dC's rows
  // see later sources (x·dt of any head, B's columns) and their own dY; dB's
  // sources see earlier rows (dY of any head, C's columns) and their own x·dt
  const bool diag = lt == st;
  const bool later = diag && l0 + kR < Q, earlier = diag && s0 > 0;
  unsigned long long bmask[4] = {0ull, 0ull, 0ull, 0ull}, cmask[4] = {0ull, 0ull, 0ull, 0ull};
  bool xany = false, dyany = false;
  if (diag) {
    const int* rf = a.rowflag + (long long)b * a.seq + (long long)c * Q;
    bool x_part = false, y_part = false;
    for (int i = l0 + kR + tid; i < Q; i += kThreads) x_part |= (rf[i] & 2) != 0;
    for (int i = tid; i < s0; i += kThreads) y_part |= (rf[i] & 1) != 0;
    xany = __syncthreads_or(x_part);
    dyany = __syncthreads_or(y_part);
    const long long fb = ((long long)b * a.nc + c) * a.tiles * 4;
    for (int tt = 0; tt < a.tiles; ++tt)
      for (int w = 0; w < 4; ++w) {
        if (tt > lt) bmask[w] |= a.fl_B[fb + tt * 4 + w];
        if (tt < st) cmask[w] |= a.fl_C[fb + tt * 4 + w];
      }
  }

  bool bad = false;
  // dC (rows of the row tile) += dcb·B
  for (int grp = 0; grp < a.ngroups; ++grp) {
    float f[NJ][4];
    zero(f);
    mma_mb<kSlow, NJ>(f, m, g, t, [&](int k, int col) { return Bs[k * PG + grp * GW + col]; });
    if constexpr (!kSlow) bad |= !all_finite(f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = wr + g + 8 * r;
      if (lr >= rows) continue;
      const bool row_nan =
          later && (xany || (a.rowflag[(long long)b * a.seq + row0 + lr] & 1));
      float* out = a.dCq + (((long long)b * a.tiles + st) * a.seq + row0 + lr) * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = grp * GW + j * 8 + 2 * t + e;
          if (nn < N)
            out[nn] = (row_nan || (later && ((bmask[nn >> 6] >> (nn & 63)) & 1ull)))
                          ? nan_f32() : f[j][2 * r + e];
        }
    }
  }
  // dB (sources of the source tile) += dcbᵀ·C: the warp's 16 sources
  for (int grp = 0; grp < a.ngroups; ++grp) {
    float f[NJ][4];
    zero(f);
    mma_ab<kSlow, NJ>(
        f, kR / 8, g, t, [&](int r, int k) { return Ds[k * kPT + wr + r]; },
        [&](int k, int col) { return Cl[k * PT + grp * GW + col]; });
    if constexpr (!kSlow) bad |= !all_finite(f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sr = wr + g + 8 * r;
      if (sr >= srows) continue;
      const bool row_nan =
          earlier && (dyany || (a.rowflag[(long long)b * a.seq + srow0 + sr] & 2));
      float* out = a.dBq + (((long long)b * a.tiles + lt) * a.seq + srow0 + sr) * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = grp * GW + j * 8 + 2 * t + e;
          if (nn < N)
            out[nn] = (row_nan || (earlier && ((cmask[nn >> 6] >> (nn & 63)) & 1ull)))
                          ? nan_f32() : f[j][2 * r + e];
        }
    }
  }
  if constexpr (!kSlow) {
    if (__syncthreads_or(bad)) return true;
  }
  return false;
}

template <int NJ>
__device__ __noinline__ void dcb_block_full(const Args& a) {
  dcb_block<NJ, true>(a);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_dcb(const __grid_constant__ Args a) {
  if (dcb_block<NJ, false>(a)) dcb_block_full<NJ>(a);
}

// ---------------------------------------------------------------------------
// 7. da -> d(dt·A) (reverse cumsum) -> dx, d(dt), the chunk's part of dA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kChainThreads) ssd_bwd_kernel_chain(const __grid_constant__ Args a) {
  __shared__ float g[kMaxChunk];      // da, then d(dt·A)
  __shared__ float dtv[kMaxChunk];
  __shared__ float rowdA[kMaxChunk];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk, P = a.p;
  const long long bh = (long long)b * a.heads + h;
  const long long base = bh * a.seq + (long long)c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Q; i += kChainThreads) {
    // the column sums of the row tiles at or below row i's tile, in order
    float col = 0.f;
    for (int lt = i / kR; lt < a.tiles; ++lt)
      col += a.colsum[(bh * a.tiles + lt) * a.seq + (long long)c * Q + i];
    g[i] = a.da_row[base + i] + (col - a.ddd[base + i]);
    dtv[i] = a.dt[b * a.ds_b + ((long long)c * Q + i) * a.ds_s + h * a.ds_h];
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int i = lane; i < Q; i += 32) t += a.ddd[base + i];
    t = sum32(t);
    if (lane == 0) {
      // the cotangent of the decay e^{a_last} times it: the carry blocks'
      // parts of Σ dS_in[c+1] ∘ S_in[c], in block order
      const int nb = (a.p * a.n + kCarryThreads - 1) / kCarryThreads;
      float dl = 0.f;
      for (int i = 0; i < nb; ++i) dl += a.dalast[(bh * a.nc + c) * nb + i];
      g[Q - 1] += t + dl * exp_ftz(a.acum[base + Q - 1]);
    }
    __syncwarp();
    // suffix sums: each lane a run, then a warp scan of the runs from the
    // top; a run's offset is the next lane's inclusive sum (not this lane's
    // minus its run, which is NaN where the run holds an inf)
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    float run = 0.f;
    for (int i = hi - 1; i >= lo; --i) {
      run += g[i];
      g[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += down;
    }
    const float next = __shfl_down_sync(0xffffffffu, incl, 1);
    const float after = lane < 31 ? next : 0.f;
    for (int i = lo; i < hi; ++i) g[i] += after;
  }
  __syncthreads();
  const float A = a.A[h];
  // dx and d(dt), four rows a warp in flight (p <= 64: two columns a lane)
  constexpr int kWarps = kChainThreads / 32, kRows = 4;
  for (int m0 = warp; m0 < Q; m0 += kWarps * kRows) {
    float dxd[kRows][2], xv[kRows][2];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int m = m0 + u * kWarps;
      const long long s = (long long)c * Q + m;
      const float* dxr = a.dx + ((b * a.seq + s) * a.heads + h) * P;
      const float* xr = a.x + b * a.xs_b + s * a.xs_s + h * a.xs_h;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int pp = lane + 32 * k;
        const bool in = m < Q && pp < P;
        dxd[u][k] = in ? dxr[pp] : 0.f;
        xv[u][k] = in ? xr[pp] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int m = m0 + u * kWarps;
      const float part = sum32(fmaf(dxd[u][1], xv[u][1], dxd[u][0] * xv[u][0]));
      if (m >= Q) continue;
      const long long s = (long long)c * Q + m;
      float* dxr = a.dx + ((b * a.seq + s) * a.heads + h) * P;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int pp = lane + 32 * k;
        if (pp < P) dxr[pp] = dxd[u][k] * dtv[m];
      }
      if (lane == 0) {
        a.ddt[(b * a.seq + s) * a.heads + h] = fmaf(g[m], A, part);
        rowdA[m] = g[m] * dtv[m];
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int i = lane; i < Q; i += 32) t += rowdA[i];
    t = sum32(t);
    if (lane == 0) a.dAp[bh * a.nc + c] = t;
  }
}

// ---------------------------------------------------------------------------
// 8. dB, dC over the heads and the tile pairs; dA over the batch and the
//    chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kReduceThreads) ssd_bwd_kernel_reduce(const __grid_constant__ Args a) {
  const long long idx = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const long long per_b = (long long)a.seq * a.n;
  if (idx < a.batch * per_b) {
    const long long b = idx / per_b, rem = idx - b * per_b;
    const int tile = (int)((rem / a.n) % a.chunk) / kR;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < a.heads; ++h) {
      const long long off = (b * a.heads + h) * per_b + rem;
      sb += a.dBp[off];
      sc += a.dCp[off];
    }
    for (int tt = 0; tt < a.tiles; ++tt) {
      const long long off = (b * a.tiles + tt) * per_b + rem;
      if (tt >= tile) sb += a.dBq[off];   // row tiles at or after the source's
      if (tt <= tile) sc += a.dCq[off];   // source tiles at or before the row's
    }
    a.dB[idx] = sb;
    a.dC[idx] = sc;
  }
  if (idx < a.heads) {
    float s = 0.f;
    for (int b = 0; b < a.batch; ++b)
      for (int c = 0; c < a.nc; ++c) s += a.dAp[((long long)b * a.heads + idx) * a.nc + c];
    a.dA[idx] = s;
  }
}

template <int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = state_smem<NJ>(), s3 = rows_smem(a.n_pad, a.nbuf),
               s4 = cols_smem(a.n_pad, a.nbuf), s5 = dcb_smem(a.n_pad);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_state<NJ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1)))
    return err;
  const size_t s3a = g_smem(a.n_pad);
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_g, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s3a)))
    return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_rows<NJ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3)))
    return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_cols<NJ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s4)))
    return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_dcb<NJ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s5)))
    return err;
  ssd_bwd_kernel_state<NJ><<<dim3(a.nc * a.ngroups, a.heads, a.batch), kThreads, s1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_carry<<<dim3((a.p * a.n + kCarryThreads - 1) / kCarryThreads, a.heads, a.batch),
                         kCarryThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_g<<<dim3(a.pairs * a.nc, a.batch), kThreads, s3a, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 tile_grid(a.tiles * a.nc, a.heads, a.batch);
  ssd_bwd_kernel_rows<NJ><<<tile_grid, kThreads, s3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_cols<NJ><<<tile_grid, kThreads, s4, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_dcb<NJ><<<dim3(a.pairs * a.nc, a.batch), kThreads, s5, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_chain<<<dim3(a.nc, a.heads, a.batch), kChainThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)a.batch * a.seq * a.n;
  const long long work = total > a.heads ? total : (long long)a.heads;
  ssd_bwd_kernel_reduce<<<(unsigned)((work + kReduceThreads - 1) / kReduceThreads),
                          kReduceThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs (32, in Args order): x, dt, A, B, C, dy, dfinal (or null), ws, then
// the workspaces acum, dst, dalast, dinit (or null), dx, ddt, dAp, dBp,
// dCp, da_row, colsum, ddd, wl, gf, dBq, dCq, fl_dy, fl_B, fl_C, rowbits,
// rowflag (none needs zeroing), and the outputs dA, dB, dC (the wrapper
// allocates all of them; see ssd_scan.py). strides (13): x (b, s, h), dt
// (b, s, h), B (b, s), C (b, s), dy (b, s, h); the last stride of x, B, C
// and dy is 1. f32 only. Eight launches on `stream`; returns the first
// failure of cudaGetLastError().
int ssd_scan_bwd_launch(void* const* ptrs, const long long* strides, int batch, int seq,
                        int heads, int p, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seq % chunk || p < 1 || p > kP || n < 1 || n > 256)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)ptrs[0];
  a.dt = (const float*)ptrs[1];
  a.A = (const float*)ptrs[2];
  a.B = (const float*)ptrs[3];
  a.C = (const float*)ptrs[4];
  a.dy = (const float*)ptrs[5];
  a.dfinal = (const float*)ptrs[6];
  a.ws = (const float*)ptrs[7];
  a.acum = (float*)ptrs[8];
  a.dst = (float*)ptrs[9];
  a.dalast = (float*)ptrs[10];
  a.dinit = (float*)ptrs[11];
  a.dx = (float*)ptrs[12];
  a.ddt = (float*)ptrs[13];
  a.dAp = (float*)ptrs[14];
  a.dBp = (float*)ptrs[15];
  a.dCp = (float*)ptrs[16];
  a.da_row = (float*)ptrs[17];
  a.colsum = (float*)ptrs[18];
  a.ddd = (float*)ptrs[19];
  a.wl = (float*)ptrs[20];
  a.gf = (float*)ptrs[21];
  a.dBq = (float*)ptrs[22];
  a.dCq = (float*)ptrs[23];
  a.fl_dy = (unsigned long long*)ptrs[24];
  a.fl_B = (unsigned long long*)ptrs[25];
  a.fl_C = (unsigned long long*)ptrs[26];
  a.rowbits = (uint8_t*)ptrs[27];
  a.rowflag = (int*)ptrs[28];
  a.dA = (float*)ptrs[29];
  a.dB = (float*)ptrs[30];
  a.dC = (float*)ptrs[31];
  a.xs_b = strides[0]; a.xs_s = strides[1]; a.xs_h = strides[2];
  a.ds_b = strides[3]; a.ds_s = strides[4]; a.ds_h = strides[5];
  a.bs_b = strides[6]; a.bs_s = strides[7];
  a.cs_b = strides[8]; a.cs_s = strides[9];
  a.ys_b = strides[10]; a.ys_s = strides[11]; a.ys_h = strides[12];
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.p = p;
  a.n = n;
  a.chunk = chunk;
  a.nc = seq / chunk;
  a.tiles = (chunk + kR - 1) / kR;
  a.pairs = a.tiles * (a.tiles + 1) / 2;
  const int nj = n <= 16 ? 2 : n <= 32 ? 4 : 8;
  a.ngroups = (n + 8 * nj - 1) / (8 * nj);
  a.n_pad = a.ngroups * 8 * nj;
  // two tile buffers where both passes' shared memory allows it
  const size_t limit = 227 * 1024;
  a.nbuf = rows_smem(a.n_pad, 2) <= limit && cols_smem(a.n_pad, 2) <= limit ? 2 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (nj == 2) return (int)launch<2>(a, s);
  if (nj == 4) return (int)launch<4>(a, s);
  return (int)launch<8>(a, s);
}

}  // extern "C"
