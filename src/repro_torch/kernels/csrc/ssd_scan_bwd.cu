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
// (s <= l, else 0) and D_s = e^{a_last - a_s}:
//
//   d(xd)_s = Σ_{l>=s} G L dY_l + D_s dst·B_s
//   dC_l    = Σ_{s<=l} W L B_s + e^{a_l} dY_l·S_in
//   dB_s    = Σ_{l>=s} W L C_l + D_s dstᵀ·xd_s
//   da_l    = Σ_s (W G L)_ls - Σ_l' (W G L)_l'l + e^{a_l} dY_l·(C_l·S_inᵀ)
//             - D_l (B_l·dstᵀ·xd_l) + [l last] (Σ_s D_s B_s·dstᵀ·xd_s
//             + e^{a_last} Σ dS_in[c+1] ∘ S_in[c])
//
// where dst[c] = dS_in[c+1] and dS_in[c] = e^{a_last} dS_in[c+1] + Σ_l
// e^{a_l} dY_l ⊗ C_l. Then d(dt·A) is the reverse cumsum of da, dx =
// d(xd)·dt, d(dt) = Σ_p d(xd)·x + d(dt·A)·A and dA = Σ d(dt·A)·dt. Every
// decay is exp with subnormal results flushed to 0, as in the forward: a
// gradient through a flushed decay is 0.
//
// Replaces: no Pallas kernel. The JAX package differentiates its jnp
// ssd_chunked (src/repro/models/ssm.py:104) by autodiff; this is the same
// gradient, computed chunk by chunk from the forward's saved incoming
// states (ssd_scan.cu's workspace after its carry pass).
//
// What bounds it on the card: operations, at the shapes the models use
// (Hymba: h 50, p 64, n 16, chunk 128; mamba2-130m: h 24, p 64, n 128,
// chunk 256): per chunk the causal halves of W and G, three products with
// the masked [q, q] matrices, and the state's products, against bytes of
// x, dt, B, C and dY read and dx, d(dt), dB, dC written once.
//
// What the design does about it (a first, simple version on the CUDA
// cores' FFMA; a tensor-core version is later work). Six launches:
// 1. ssd_bwd_kernel_state, one block per (chunk, h, b): the chunk's a (the
//    forward's scan, so both see the same values; written out for the
//    later passes) and Σ_l e^{a_l} dY_l ⊗ C_l.
// 2. ssd_bwd_kernel_carry, one block per (h, b), a thread per few state
//    entries: the reverse recurrence over the chunks from the final
//    state's cotangent, giving each chunk's dst (in place of pass 1's
//    output), the cotangent of its decay e^{a_last} (a block reduction in
//    a fixed order) and the initial state's cotangent.
// 3. ssd_bwd_kernel_rows, one block per (64-row tile, chunk, h, b): what is
//    indexed by the row l (dC, the row sums of W G L, the incoming state's
//    terms), walking the source tiles at or below its own.
// 4. ssd_bwd_kernel_cols, one block per (64-source tile, chunk, h, b): what
//    is indexed by the source s (d(xd), dB, the column sums of W G L, the
//    chunk state's terms), walking the row tiles at or above its own.
//    W, G and L are recomputed in both, as the two passes of a
//    FlashAttention-2 backward recompute P; neither needs atomics.
// 5. ssd_bwd_kernel_chain, one block per (chunk, h, b): da, its reverse
//    cumsum (a warp scan in a fixed order), dx, d(dt) and the chunk's part
//    of dA.
// 6. ssd_bwd_kernel_reduce: dB and dC summed over the heads, dA over the
//    batch and the chunks, each in a fixed order.
// Each thread of passes 1, 3 and 4 owns a 4 x (n / 16) or 4 x 4 patch
// (rows ty + 16r, columns tx + 16c) of its products; shared tiles are f32
// [row][column] with odd pitches, so that a warp's reads of a column are on
// distinct banks. Limits: the forward's, p <= 64, n <= 256, chunk <= 1024,
// f32 only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kR = 64;           // rows per tile (output rows, sources)
constexpr int kP = 64;           // head_dim, padded
constexpr int kPP = kP + 1;      // pitch of [row][p] tiles
constexpr int kPT = kR + 1;      // pitch of [row][source] tiles
constexpr int kMaxChunk = 1024;
constexpr int kCarryThreads = 1024;
constexpr int kCarryE = 16;      // state entries a carry thread owns: 64 x 256 / 1024

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
  float* dalast;        // [b, h, nc]: the cotangent of a_last from the recurrence
  float* dinit;         // [b, h, p, n] or null
  float* dx;            // [b, S, h, p] contiguous: d(xd), then dx
  float* ddt;           // [b, S, h] contiguous
  float* dAp;           // [b, h, nc]: each chunk's part of dA
  float* dBp;           // [b, h, S, n]: each head's part of dB
  float* dCp;           // [b, h, S, n]: each head's part of dC
  float* da_row;        // [b, h, S]
  float* da_col;        // [b, h, S]
  float* ddd;           // [b, h, S]: D_s B_s·dstᵀ·xd_s, for the last row
  float* dA;            // [h]
  float* dB;            // [b, S, n] contiguous
  float* dC;            // [b, S, n] contiguous
  long long xs_b, xs_s, xs_h, ds_b, ds_s, ds_h, bs_b, bs_s, cs_b, cs_s, ys_b, ys_s, ys_h;
  int batch, seq, heads, p, n, chunk, nc, tiles;
};

// exp with subnormal results flushed to 0 (ssd_scan.cu's exp_ftz)
__device__ __forceinline__ float exp_ftz(float z) {
  const float e = expf(z);
  return e < 1.17549435e-38f ? 0.f : e;  // FLT_MIN; a NaN stays NaN
}

__device__ __forceinline__ float sum16(float v) {  // over the 16 lanes of a half warp
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ssd_scan.cu's chunk_scan: the chunk's dt (dtv) and inclusive cumsum of
// dt·A (a_cum) in the forward's order. Starts and ends with a barrier.
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
    const float before = incl - run;
    for (int i = lo; i < hi; ++i) a_cum[i] += before;
  }
  __syncthreads();
}

// rows row0 .. row0 + 63 of a [*, n] operand into dst[64][pitch], zero
// past `rows` (of the chunk) and past `cols`
__device__ __forceinline__ void stage_n(float* dst, int pitch, int np, const float* src,
                                        long long stride, int rows, int cols) {
  for (int e = threadIdx.x; e < kR * np; e += kThreads) {
    const int r = e / np, c = e - r * np;
    dst[r * pitch + c] = (r < rows && c < cols) ? src[r * stride + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1. a, and Σ_l e^{a_l} dY_l ⊗ C_l per chunk
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_state(Args a) {
  constexpr int NP = 16 * NT, PN = NP + 1;
  extern __shared__ float smem[];
  float* a_cum = smem;                 // [kMaxChunk]
  float* dtv = a_cum + kMaxChunk;      // [kMaxChunk]
  float* eY = dtv + kMaxChunk;         // [64][kPP]: e^{a_l} dY
  float* Ct = eY + kR * kPP;           // [64][PN]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk, P = a.p, N = a.n;
  const long long bh = (long long)b * a.heads + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  chunk_scan(a_cum, dtv, a.dt + b * a.ds_b + (long long)c * Q * a.ds_s + h * a.ds_h, a.ds_s,
             a.A[h], Q);
  for (int i = threadIdx.x; i < Q; i += kThreads) a.acum[bh * a.seq + c * Q + i] = a_cum[i];

  float acc[4][NT];  // p ty + 16r, n tx + 16cc
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) acc[r][cc] = 0.f;
  for (int l0 = 0; l0 < Q; l0 += kR) {
    const int row0 = c * Q + l0, rows = min(kR, Q - l0);
    __syncthreads();
    for (int e = threadIdx.x; e < kR * kP; e += kThreads) {
      const int r = e / kP, col = e % kP;
      eY[r * kPP + col] =
          (r < rows && col < P)
              ? exp_ftz(a_cum[l0 + r]) *
                    a.dy[b * a.ys_b + (long long)(row0 + r) * a.ys_s + h * a.ys_h + col]
              : 0.f;
    }
    stage_n(Ct, PN, NP, a.C + b * a.cs_b + (long long)row0 * a.cs_s, a.cs_s, rows, N);
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kR; ++l) {
      float yr[4], cv[NT];
#pragma unroll
      for (int r = 0; r < 4; ++r) yr[r] = eY[l * kPP + ty + 16 * r];
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) cv[cc] = Ct[l * PN + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NT; ++cc) acc[r][cc] = fmaf(yr[r], cv[cc], acc[r][cc]);
    }
  }
  float* out = a.dst + (bh * a.nc + c) * (long long)P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pp = ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) {
      const int nn = tx + 16 * cc;
      if (pp < P && nn < N) out[pp * N + nn] = acc[r][cc];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse recurrence over the chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCarryThreads) ssd_bwd_kernel_carry(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int Q = a.chunk, pn = a.p * a.n;
  const long long bh = (long long)b * a.heads + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float red[kCarryThreads / 32];
  float g[kCarryE];  // dS_in[c + 1] of this thread's entries
#pragma unroll
  for (int e = 0; e < kCarryE; ++e) {
    const int idx = tid + e * kCarryThreads;
    g[e] = (idx < pn && a.dfinal != nullptr) ? a.dfinal[bh * pn + idx] : 0.f;
  }
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long base = (bh * a.nc + c) * pn;
    const float decay = exp_ftz(a.acum[bh * a.seq + (long long)c * Q + Q - 1]);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < kCarryE; ++e) {
      const int idx = tid + e * kCarryThreads;
      if (idx < pn) {
        part = fmaf(g[e], a.ws[base + idx], part);
        const float local = a.dst[base + idx];
        a.dst[base + idx] = g[e];
        g[e] = fmaf(decay, g[e], local);
      }
    }
    part = sum32(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kCarryThreads / 32; ++w) s += red[w];
      a.dalast[bh * a.nc + c] = s * decay;
    }
    __syncthreads();
  }
  if (a.dinit != nullptr) {
#pragma unroll
    for (int e = 0; e < kCarryE; ++e) {
      const int idx = tid + e * kCarryThreads;
      if (idx < pn) a.dinit[bh * pn + idx] = g[e];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. per row tile: dC, and da's row terms
// ---------------------------------------------------------------------------

template <int NT>
constexpr size_t rows_smem() {
  return sizeof(float) * (2 * kR * (16 * NT + 1) + 2 * kR * kPP + kR * kPT + 2 * kR);
}

template <int NT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_rows(Args a) {
  constexpr int NP = 16 * NT, PN = NP + 1;
  extern __shared__ float smem[];
  float* Cl = smem;              // [64][PN]: C of the row tile
  float* Bs = Cl + kR * PN;      // [64][PN]: S_in [p][n], then B of a source tile
  float* dYl = Bs + kR * PN;     // [64][kPP]: dY of the row tile
  float* xds = dYl + kR * kPP;   // [64][kPP]: x·dt of a source tile
  float* WL = xds + kR * kPP;    // [64][kPT]: W ∘ L
  float* al = WL + kR * kPT;     // [64]
  float* as = al + kR;           // [64]
  const int c = blockIdx.x / a.tiles, lt = blockIdx.x % a.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk, P = a.p, N = a.n;
  const long long bh = (long long)b * a.heads + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int l0 = lt * kR, row0 = c * Q + l0, rows = min(kR, Q - l0);

  stage_n(Cl, PN, NP, a.C + b * a.cs_b + (long long)row0 * a.cs_s, a.cs_s, rows, N);
  for (int e = threadIdx.x; e < kR * kP; e += kThreads) {
    const int r = e / kP, col = e % kP;
    dYl[r * kPP + col] =
        (r < rows && col < P) ? a.dy[b * a.ys_b + (long long)(row0 + r) * a.ys_s + h * a.ys_h + col]
                              : 0.f;
  }
  stage_n(Bs, PN, NP, a.ws + (bh * a.nc + c) * (long long)P * N, N, P, N);
  if (threadIdx.x < kR)
    al[threadIdx.x] = threadIdx.x < rows ? a.acum[bh * a.seq + row0 + threadIdx.x] : 0.f;
  __syncthreads();

  // the incoming state's terms: dC = e^{a_l} dY·S_in, da = e^{a_l} Σ_p dY ∘ (C·S_inᵀ)
  float acc[4][NT];  // rows ty + 16r, n tx + 16cc
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) acc[r][cc] = 0.f;
#pragma unroll 4
  for (int pp = 0; pp < kP; ++pp) {
    float yr[4], sv[NT];
#pragma unroll
    for (int r = 0; r < 4; ++r) yr[r] = dYl[(ty + 16 * r) * kPP + pp];
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) sv[cc] = Bs[pp * PN + tx + 16 * cc];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) acc[r][cc] = fmaf(yr[r], sv[cc], acc[r][cc]);
  }
  float z[4][4];  // C·S_inᵀ: rows ty + 16r, p tx + 16cc
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) z[r][cc] = 0.f;
#pragma unroll 4
  for (int nn = 0; nn < NP; ++nn) {
    float cr[4], sv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cr[r] = Cl[(ty + 16 * r) * PN + nn];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) sv[cc] = Bs[(tx + 16 * cc) * PN + nn];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) z[r][cc] = fmaf(cr[r], sv[cc], z[r][cc]);
  }
  float da[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float el = ty + 16 * r < rows ? exp_ftz(al[ty + 16 * r]) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s = fmaf(dYl[(ty + 16 * r) * kPP + tx + 16 * cc], z[r][cc], s);
    da[r] = s * el;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) acc[r][cc] *= el;
  }

  // the source tiles at or below the row tile
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kR, srow0 = c * Q + s0, srows = min(kR, Q - s0);
    __syncthreads();  // S_in or the previous source tile, and WL, consumed
    stage_n(Bs, PN, NP, a.B + b * a.bs_b + (long long)srow0 * a.bs_s, a.bs_s, srows, N);
    for (int e = threadIdx.x; e < kR * kP; e += kThreads) {
      const int r = e / kP, col = e % kP;
      float v = 0.f;
      if (r < srows && col < P) {
        const long long s = srow0 + r;
        v = a.x[b * a.xs_b + s * a.xs_s + h * a.xs_h + col] *
            a.dt[b * a.ds_b + s * a.ds_s + h * a.ds_h];
      }
      xds[r * kPP + col] = v;
    }
    if (threadIdx.x < kR)
      as[threadIdx.x] = threadIdx.x < srows ? a.acum[bh * a.seq + srow0 + threadIdx.x] : 0.f;
    __syncthreads();

    // W = dY·xdᵀ, G = C·Bᵀ: rows ty + 16r, sources tx + 16cc
    float w[4][4], g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) w[r][cc] = g[r][cc] = 0.f;
#pragma unroll 4
    for (int pp = 0; pp < kP; ++pp) {
      float yr[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yr[r] = dYl[(ty + 16 * r) * kPP + pp];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) xv[cc] = xds[(tx + 16 * cc) * kPP + pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) w[r][cc] = fmaf(yr[r], xv[cc], w[r][cc]);
    }
#pragma unroll 4
    for (int nn = 0; nn < NP; ++nn) {
      float cr[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cr[r] = Cl[(ty + 16 * r) * PN + nn];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[(tx + 16 * cc) * PN + nn];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) g[r][cc] = fmaf(cr[r], bv[cc], g[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int l = l0 + ty + 16 * r, s = s0 + tx + 16 * cc;
        const float L = (s <= l && l < Q) ? exp_ftz(al[ty + 16 * r] - as[tx + 16 * cc]) : 0.f;
        const float wl = w[r][cc] * L;
        WL[(ty + 16 * r) * kPT + tx + 16 * cc] = wl;
        da[r] = fmaf(wl, g[r][cc], da[r]);
      }
    __syncthreads();
    // dC += (W ∘ L)·B
#pragma unroll 4
    for (int s = 0; s < kR; ++s) {
      float wr[4], bv[NT];
#pragma unroll
      for (int r = 0; r < 4; ++r) wr[r] = WL[(ty + 16 * r) * kPT + s];
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) bv[cc] = Bs[s * PN + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NT; ++cc) acc[r][cc] = fmaf(wr[r], bv[cc], acc[r][cc]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float d = sum16(da[r]);
    const int l = ty + 16 * r;
    if (l >= rows) continue;
    const long long row = bh * a.seq + row0 + l;
    if (tx == 0) a.da_row[row] = d;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) {
      const int nn = tx + 16 * cc;
      if (nn < N) a.dCp[row * N + nn] = acc[r][cc];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. per source tile: d(xd), dB, and da's column terms
// ---------------------------------------------------------------------------

template <int NT>
constexpr size_t cols_smem() {
  return sizeof(float) * (2 * kR * (16 * NT + 1) + 2 * kR * kPP + 2 * kR * kPT + 2 * kR);
}

template <int NT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_cols(Args a) {
  constexpr int NP = 16 * NT, PN = NP + 1;
  extern __shared__ float smem[];
  float* Bs = smem;              // [64][PN]: B of the source tile
  float* Cl = Bs + kR * PN;      // [64][PN]: dst [p][n], then C of a row tile
  float* xds = Cl + kR * PN;     // [64][kPP]: x·dt of the source tile
  float* dYl = xds + kR * kPP;   // [64][kPP]: dY of a row tile
  float* MT = dYl + kR * kPP;    // [64][kPT]: (G ∘ L)ᵀ
  float* WLT = MT + kR * kPT;    // [64][kPT]: (W ∘ L)ᵀ
  float* as = WLT + kR * kPT;    // [64]
  float* al = as + kR;           // [64]
  const int c = blockIdx.x / a.tiles, st = blockIdx.x % a.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk, P = a.p, N = a.n;
  const long long bh = (long long)b * a.heads + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int s0 = st * kR, srow0 = c * Q + s0, srows = min(kR, Q - s0);

  stage_n(Bs, PN, NP, a.B + b * a.bs_b + (long long)srow0 * a.bs_s, a.bs_s, srows, N);
  for (int e = threadIdx.x; e < kR * kP; e += kThreads) {
    const int r = e / kP, col = e % kP;
    float v = 0.f;
    if (r < srows && col < P) {
      const long long s = srow0 + r;
      v = a.x[b * a.xs_b + s * a.xs_s + h * a.xs_h + col] *
          a.dt[b * a.ds_b + s * a.ds_s + h * a.ds_h];
    }
    xds[r * kPP + col] = v;
  }
  stage_n(Cl, PN, NP, a.dst + (bh * a.nc + c) * (long long)P * N, N, P, N);
  if (threadIdx.x < kR)
    as[threadIdx.x] = threadIdx.x < srows ? a.acum[bh * a.seq + srow0 + threadIdx.x] : 0.f;
  const float a_last = a.acum[bh * a.seq + (long long)c * Q + Q - 1];
  __syncthreads();

  // the chunk state's terms: E = xd·dst, dB = D E, dD = Σ_n B ∘ E,
  // d(xd) = D B·dstᵀ; sources ty + 16r
  float accB[4][NT];  // n tx + 16cc
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) accB[r][cc] = 0.f;
#pragma unroll 4
  for (int pp = 0; pp < kP; ++pp) {
    float xr[4], dv[NT];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = xds[(ty + 16 * r) * kPP + pp];
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) dv[cc] = Cl[pp * PN + tx + 16 * cc];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) accB[r][cc] = fmaf(xr[r], dv[cc], accB[r][cc]);
  }
  float accX[4][4];  // p tx + 16cc
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) accX[r][cc] = 0.f;
#pragma unroll 4
  for (int nn = 0; nn < NP; ++nn) {
    float br[4], dv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) br[r] = Bs[(ty + 16 * r) * PN + nn];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) dv[cc] = Cl[(tx + 16 * cc) * PN + nn];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) accX[r][cc] = fmaf(br[r], dv[cc], accX[r][cc]);
  }
  float dd[4], D[4], dcol[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    D[r] = ty + 16 * r < srows ? exp_ftz(a_last - as[ty + 16 * r]) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) s = fmaf(Bs[(ty + 16 * r) * PN + tx + 16 * cc], accB[r][cc], s);
    dd[r] = s;
    dcol[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) accB[r][cc] *= D[r];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) accX[r][cc] *= D[r];
  }

  // the row tiles at or above the source tile
  for (int lt = st; lt < a.tiles; ++lt) {
    const int l0 = lt * kR, row0 = c * Q + l0, rows = min(kR, Q - l0);
    __syncthreads();  // dst or the previous row tile, MT and WLT, consumed
    stage_n(Cl, PN, NP, a.C + b * a.cs_b + (long long)row0 * a.cs_s, a.cs_s, rows, N);
    for (int e = threadIdx.x; e < kR * kP; e += kThreads) {
      const int r = e / kP, col = e % kP;
      dYl[r * kPP + col] =
          (r < rows && col < P)
              ? a.dy[b * a.ys_b + (long long)(row0 + r) * a.ys_s + h * a.ys_h + col]
              : 0.f;
    }
    if (threadIdx.x < kR)
      al[threadIdx.x] = threadIdx.x < rows ? a.acum[bh * a.seq + row0 + threadIdx.x] : 0.f;
    __syncthreads();

    // Wᵀ = xd·dYᵀ, Gᵀ = B·Cᵀ: sources ty + 16r, rows tx + 16cc
    float w[4][4], g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) w[r][cc] = g[r][cc] = 0.f;
#pragma unroll 4
    for (int pp = 0; pp < kP; ++pp) {
      float xr[4], yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xr[r] = xds[(ty + 16 * r) * kPP + pp];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yv[cc] = dYl[(tx + 16 * cc) * kPP + pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) w[r][cc] = fmaf(yv[cc], xr[r], w[r][cc]);
    }
#pragma unroll 4
    for (int nn = 0; nn < NP; ++nn) {
      float br[4], cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) br[r] = Bs[(ty + 16 * r) * PN + nn];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) cv[cc] = Cl[(tx + 16 * cc) * PN + nn];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) g[r][cc] = fmaf(cv[cc], br[r], g[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int s = s0 + ty + 16 * r, l = l0 + tx + 16 * cc;
        const float L = (s <= l && l < Q) ? exp_ftz(al[tx + 16 * cc] - as[ty + 16 * r]) : 0.f;
        const float wl = w[r][cc] * L;
        MT[(ty + 16 * r) * kPT + tx + 16 * cc] = g[r][cc] * L;
        WLT[(ty + 16 * r) * kPT + tx + 16 * cc] = wl;
        dcol[r] = fmaf(-wl, g[r][cc], dcol[r]);
      }
    __syncthreads();
    // d(xd) += (G ∘ L)ᵀ·dY, dB += (W ∘ L)ᵀ·C
#pragma unroll 4
    for (int l = 0; l < kR; ++l) {
      float mr[4], wr[4], yv[4], cv[NT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mr[r] = MT[(ty + 16 * r) * kPT + l];
        wr[r] = WLT[(ty + 16 * r) * kPT + l];
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yv[cc] = dYl[l * kPP + tx + 16 * cc];
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) cv[cc] = Cl[l * PN + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) accX[r][cc] = fmaf(mr[r], yv[cc], accX[r][cc]);
#pragma unroll
        for (int cc = 0; cc < NT; ++cc) accB[r][cc] = fmaf(wr[r], cv[cc], accB[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float ddD = sum16(dd[r]) * D[r];
    const float dc = sum16(dcol[r]);
    const int s = ty + 16 * r;
    if (s >= srows) continue;
    const long long row = bh * a.seq + srow0 + s;
    if (tx == 0) {
      a.da_col[row] = dc - ddD;
      a.ddd[row] = ddD;
    }
    float* dxr = a.dx + (((long long)b * a.seq + srow0 + s) * a.heads + h) * P;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int pp = tx + 16 * cc;
      if (pp < P) dxr[pp] = accX[r][cc];
    }
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) {
      const int nn = tx + 16 * cc;
      if (nn < N) a.dBp[row * N + nn] = accB[r][cc];
    }
  }
}

// ---------------------------------------------------------------------------
// 5. da -> d(dt·A) (reverse cumsum) -> dx, d(dt), the chunk's part of dA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_chain(Args a) {
  __shared__ float g[kMaxChunk];      // da, then d(dt·A)
  __shared__ float dtv[kMaxChunk];
  __shared__ float rowdA[kMaxChunk];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.chunk, P = a.p;
  const long long bh = (long long)b * a.heads + h;
  const long long base = bh * a.seq + (long long)c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Q; i += kThreads) {
    g[i] = a.da_row[base + i] + a.da_col[base + i];
    dtv[i] = a.dt[b * a.ds_b + ((long long)c * Q + i) * a.ds_s + h * a.ds_h];
  }
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int i = lane; i < Q; i += 32) t += a.ddd[base + i];
    t = sum32(t);
    if (lane == 0) g[Q - 1] += t + a.dalast[bh * a.nc + c];
    __syncwarp();
    // suffix sums: each lane a run, then a warp scan of the runs from the top
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
    const float after = incl - run;
    for (int i = lo; i < hi; ++i) g[i] += after;
  }
  __syncthreads();
  const float A = a.A[h];
  for (int m = warp; m < Q; m += kThreads / 32) {
    const long long s = (long long)c * Q + m;
    float* dxr = a.dx + ((b * a.seq + s) * a.heads + h) * P;
    const float* xr = a.x + b * a.xs_b + s * a.xs_s + h * a.xs_h;
    float part = 0.f;
    for (int pp = lane; pp < P; pp += 32) {
      const float dxd = dxr[pp];
      part = fmaf(dxd, xr[pp], part);
      dxr[pp] = dxd * dtv[m];
    }
    part = sum32(part);
    if (lane == 0) {
      a.ddt[(b * a.seq + s) * a.heads + h] = fmaf(g[m], A, part);
      rowdA[m] = g[m] * dtv[m];
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
// 6. dB, dC over the heads; dA over the batch and the chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel_reduce(Args a) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long per_b = (long long)a.seq * a.n;
  if (idx < a.batch * per_b) {
    const long long b = idx / per_b, rem = idx - b * per_b;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < a.heads; ++h) {
      const long long off = (b * a.heads + h) * per_b + rem;
      sb += a.dBp[off];
      sc += a.dCp[off];
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

template <int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t state_bytes =
      sizeof(float) * (2 * kMaxChunk + kR * kPP + kR * (16 * NT + 1));
  cudaError_t err;
  err = cudaFuncSetAttribute(ssd_bwd_kernel_state<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_kernel_rows<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem<NT>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_kernel_cols<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cols_smem<NT>());
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel_state<NT><<<dim3(a.nc, a.heads, a.batch), kThreads, state_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_carry<<<dim3(a.heads, a.batch), kCarryThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 tile_grid(a.tiles * a.nc, a.heads, a.batch);
  ssd_bwd_kernel_rows<NT><<<tile_grid, kThreads, rows_smem<NT>(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_cols<NT><<<tile_grid, kThreads, cols_smem<NT>(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_kernel_chain<<<dim3(a.nc, a.heads, a.batch), kThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)a.batch * a.seq * a.n;
  const long long work = total > a.heads ? total : (long long)a.heads;
  const long long blocks = (work + kThreads - 1) / kThreads;
  ssd_bwd_kernel_reduce<<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs (23, in Args order): x, dt, A, B, C, dy, dfinal (or null), ws, then
// the workspaces acum, dst, dalast, dinit (or null), dx, ddt, dAp, dBp,
// dCp, da_row, da_col, ddd, and the outputs dA, dB, dC (the wrapper
// allocates all of them; see ssd_scan.py). strides (13): x (b, s, h), dt
// (b, s, h), B (b, s), C (b, s), dy (b, s, h); the last stride of x, B, C
// and dy is 1. f32 only. Six launches on `stream`; returns the first
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
  a.da_col = (float*)ptrs[18];
  a.ddd = (float*)ptrs[19];
  a.dA = (float*)ptrs[20];
  a.dB = (float*)ptrs[21];
  a.dC = (float*)ptrs[22];
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
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 16) return (int)launch<1>(a, s);
  if (n <= 32) return (int)launch<2>(a, s);
  if (n <= 64) return (int)launch<4>(a, s);
  if (n <= 128) return (int)launch<8>(a, s);
  return (int)launch<16>(a, s);
}

}  // extern "C"
