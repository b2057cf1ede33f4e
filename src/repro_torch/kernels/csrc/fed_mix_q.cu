// fed_mix_q — the dense mixing kernel of the int8 wire, hand-written for
// Hopper (sm_90a).
//
//   out = M_new @ dequant(Q, scales) + M_old @ X_old
//   dequant(Q, scales)[k, j] = float(Q[k, j]) * scales[k, j / chunk]
//
// with M_new/M_old the [D, D] f32 client-mixing matrices, Q the int8
// [D, Pq] wire record of the new client buffer (Pq a multiple of chunk,
// one f32 absmax scale per chunk of a row), and X_old the [D, P <= Pq]
// round-start buffer (f32 or bf16); accumulated in f32 and stored in the
// requested output dtype (f32 or bf16). Only the first P columns are
// computed: Q's padding columns never reach the output.
//
// Replaces: src/repro/kernels/fed_mix_q.py · fed_mix_q (Pallas
// _fed_mix_q_kernel: the int8 tile is dequantized in VMEM inside the MXU
// K loop, so no full-precision copy of Q exists anywhere).
//
// What bounds it on the card: bytes. It is one [D, 2D] @ [2D, P] product,
// 4·D²·P flops; at the engine's shape (D = 100, P = 246,590,
// Pq = 246,784) that is ≈ 9.9 GFLOP on ≈ 222 MB (Q 24.7 MB, scales
// 0.39 MB, X_old 98.6 MB, out 98.6 MB): 0.066 ms of bytes at 3.35 TB/s.
// The products run on the TF32 tensor cores as split-f32 (tf32x3.cuh),
// at most 3 x 9.9 GFLOP at 495 TFLOP/s = 0.060 ms.
//
// What the design does about it: fed_mix.cu's structure, with Q read as
// int8.
// - Persistent blocks of 16 warps as 2 x 8, one per SM for each row block,
//   walking 256-column tiles of P; [M_new | M_old] resident in shared
//   memory (K chunks reloaded per column tile only where it does not fit);
//   one kernel per m16-tile count and route, so a warp row runs
//   straight-line products.
// - K = 2D runs as two halves, Q's rows then X_old's, each padded to whole
//   k8 steps (zeros add exactly 0), so no stage mixes two element types.
//   Both stream through one 3-stage cp.async ring whose slots hold an f32
//   [40, 256] tile. A Q stage is staged as int8: up to 136 rows and their
//   scales fill one slot, so at D = 100 all of Q's 104 rows are one stage
//   (13 k8 steps between barriers) and X_old's take three (40, 40, 24),
//   four stages a column tile against fed_mix's five. The int8 values are
//   widened exactly in the fragment load (added to the bits of 1.5·2^23).
//   Each 16-byte chunk takes the widest copy its address allows
//   (cp_async.cuh): an int8 record viewed at any byte offset, an f32 X_old
//   row 8 bytes off alignment.
// - Q's products take one of two routes, chosen by the chunk:
//   * chunk a multiple of 32 (the codec's 256): a warp's 32 columns lie in
//     one scale chunk c, so the scale folds into the A operand,
//     A'[i, k] = M_new[i, k] · s[k, c], split as the warp reads it; each
//     warp column's scales are staged with the stage. B = float(q) is
//     exact in TF32 and the Q half takes two products, not three. (M·s)·q
//     rounds differently from JAX's M·(q·s) by an f32 ulp.
//   * any other chunk: the B-fragment load dequantizes, float(q) · s[k, j
//     / chunk] (the lane's columns' chunk indices worked out once per
//     column tile, the scales read through L1), and splits; three products.
//   X_old's half is fed_mix.cu's: three products, two for bf16.
// - Non-finite values as in fed_mix.cu: the fast split's inf or NaN result
//   flags the warp's tile, and quant_mix_kernel_redo takes it again from
//   device memory on the full split (Q dequantized, three products).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int NW = 4;                     // n8 tiles per warp
constexpr int kWarpCols = kWarps / 2;     // warps as 2 rows x 8 columns
constexpr int BN = kWarpCols * NW * 8;    // output columns per tile (256)
constexpr int BK = 40;                    // K rows per ring stage, at most
constexpr int kStages = 3;                // ring depth
constexpr int kMaxMT = 8;                 // m16 tiles per row block (128 rows)
constexpr int kStageBytes = BK * (BN + 8) * 4;
// rows of a Q stage where all of M stays in shared memory: an int8 stage
// with its scales fills what one f32 stage of X_old takes
constexpr int kBKQ = 136;
constexpr int QP = BN + 16;               // int8 stage pitch (bytes): 17 mod 32 words

// shared pitch, in elements, of an X_old stage row: BN + 8 f32 (8 mod 32
// banks), BN + 16 bf16 (8 mod 32 words)
template <typename T> __host__ __device__ constexpr int x_pitch() {
  return sizeof(T) == 4 ? BN + 8 : BN + 16;
}

__device__ __forceinline__ void store2(float* dst, float v0, float v1, bool both) {
  if (both && ((uintptr_t)dst & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (both) dst[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1, bool both) {
  if (both && ((uintptr_t)dst & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (both) dst[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// B fragment element of an X_old stage as a TF32 hi/lo pair, on the fast
// split (a bf16 is exact: its value in both slots, tf32x3.cuh)
__device__ __forceinline__ void b_elem(const float* xs, int idx, uint32_t& hi, uint32_t& lo) {
  tf32x3::split_fast(xs[idx], hi, lo);
}
__device__ __forceinline__ void b_elem(const __nv_bfloat16* xs, int idx, uint32_t& hi,
                                       uint32_t& lo) {
  hi = lo = tf32x3::bf16_bits(reinterpret_cast<const uint16_t*>(xs)[idx]);
}

// an int8 of a Q stage widened exactly, at full rate: q added to the bits
// of 1.5·2^23 lands in its low mantissa bits, and 1.5·2^23 comes off again
__device__ __forceinline__ float q_elem(const int8_t* q8, int idx) {
  return __int_as_float(0x4b400000 + (int)q8[idx]) - 12582912.f;
}

// M's pitch for kc columns (a multiple of 8): 4 mod 16 words, so the A
// fragment reads (rows g, columns t) fall on distinct banks
inline int m_pitch(int kc) { return kc + 4; }

// What a stage holds and how its products run.
enum Mode { kXOld = 0, kQFold = 1, kQDequant = 2 };

// Q's scales for one product stage: the stage's first Q row, the scale
// row pitch (Pq / chunk) and the lane's columns' chunks (dequantize), or
// the fold's scales staged with the stage (row r at ss[r · kWarpCols])
struct QScales {
  const float* s;
  long long nch;
  int row0, d;
  int c_lane[NW];
  const float* ss;
  __device__ __forceinline__ float at(int k, int c) const {
    return k < d ? __ldg(s + (long long)k * nch + c) : 0.f;
  }
};

// acc += M[:, kl0 : kl0 + 8·nks] · (one stage) for the warp's NJ m16 tiles
// (wr, wr + 2, ...) and its NW n8 tiles, term by term over the
// accumulators (tf32x3::mma_split), on the fast split.
template <int NJ, int kMode, typename T>
__device__ __forceinline__ void stage_products(float (&acc)[4][NW][4], const float* Ms, int kp,
                                               const unsigned char* stage, int kl0, int nks,
                                               int wr, int n0, int g, int t,
                                               const QScales& qs) {
  constexpr bool kExactB = kMode == kQFold || (kMode == kXOld && sizeof(T) == 2);
  constexpr int XPT = x_pitch<T>();
  const T* xs = reinterpret_cast<const T*>(stage);
  const int8_t* q8 = reinterpret_cast<const int8_t*>(stage);
#pragma unroll
  for (int ks = 0; ks < (kMode == kXOld ? BK : kBKQ) / 8; ++ks) {
    if (ks >= nks) break;
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const int n = n0 + nt * 8 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = ks * 8 + t + 4 * h;
        if constexpr (kMode == kXOld) {
          b_elem(xs, kr * XPT + n, bh[nt][h], bl[nt][h]);
        } else if constexpr (kMode == kQFold) {  // float(q): exact and finite
          bh[nt][h] = bl[nt][h] = __float_as_uint(q_elem(q8, kr * QP + n));
        } else {
          tf32x3::split_fast(q_elem(q8, kr * QP + n) * qs.at(qs.row0 + kr, qs.c_lane[nt]),
                             bh[nt][h], bl[nt][h]);
        }
      }
    }
    float s_t = 0.f, s_t4 = 0.f;
    if constexpr (kMode == kQFold) {
      s_t = qs.ss[(ks * 8 + t) * kWarpCols];
      s_t4 = qs.ss[(ks * 8 + t + 4) * kWarpCols];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* a = Ms + ((wr + 2 * j) * 16 + g) * kp + kl0 + ks * 8 + t;
      float av[4] = {a[0], a[8 * kp], a[4], a[8 * kp + 4]};
      if constexpr (kMode == kQFold) {
        av[0] *= s_t;
        av[1] *= s_t;
        av[2] *= s_t4;
        av[3] *= s_t4;
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32x3::split_fast(av[i], ah[i], al[i]);
      tf32x3::mma_split<NW, false, kExactB>(acc[j], ah, al, bh, bl);
    }
  }
}

// the stage's products for the warp's row of m16 tiles: warp row 0 takes
// (MT + 1) / 2 of them, warp row 1 MT / 2
template <int MT, int kMode, typename T>
__device__ __forceinline__ void products(int wr, float (&acc)[4][NW][4], const float* Ms,
                                         int kp, const unsigned char* stage, int kl0, int nks,
                                         int n0, int g, int t, const QScales& qs) {
  if (wr == 0)
    stage_products<(MT + 1) / 2, kMode, T>(acc, Ms, kp, stage, kl0, nks, wr, n0, g, t, qs);
  else
    stage_products<MT / 2, kMode, T>(acc, Ms, kp, stage, kl0, nks, wr, n0, g, t, qs);
}

struct Args {
  const float* m_new;
  const float* m_old;
  const int8_t* q;
  const float* scales;
  const void* x_old;
  void* out;
  unsigned char* redo;   // per warp of every (row block, column tile)
  long long p, pq, nch;  // X_old / out columns, Q columns, scale columns
  int d, chunk, mt, kc, kp, ktpc, bkq, n_col_tiles, fold, out_bf16;
};

// The warp's outputs of one column tile (m16 tiles wr, wr + 2, ... of the
// row block; columns c0 .. c0 + 31) taken again from device memory with
// the full split (Q dequantized, float(q)·s, three products), and stored:
// for a tile whose fast-split result held an inf or a NaN (tf32x3.cuh).
// Rare, so plain: no staging.
template <typename TX>
__device__ __forceinline__ void tile_full(const float* m_new, const float* m_old, const int8_t* q,
                                       const float* scales, const TX* x_old, void* out,
                                       long long p, long long pq, long long nch, int d,
                                       int chunk, int out_bf16, int row0, int wr, int nj,
                                       long long c0, int g, int t) {
  const int k_total = 2 * d;
  for (int j = 0; j < nj; ++j) {
    float acc[NW][4] = {};
    const int i0 = row0 + (wr + 2 * j) * 16 + g;
    for (int k0 = 0; k0 < k_total; k0 += 8) {
      uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
      for (int nt = 0; nt < NW; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + t + 4 * h;
          const long long c = c0 + nt * 8 + g;
          float v = 0.f;
          if (k < d && c < p)
            v = (float)q[(long long)k * pq + c] * scales[(long long)k * nch + c / chunk];
          else if (k >= d && k < k_total && c < p)
            v = to_f32(x_old[(long long)(k - d) * p + c]);
          tf32x3::split(v, bh[nt][h], bl[nt][h]);  // a bf16 value: lo = 0
        }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e & 1), k = k0 + t + 4 * (e >> 1);
        float m = 0.f;
        if (i < d && k < k_total)
          m = k < d ? m_new[(long long)i * d + k] : m_old[(long long)i * d + (k - d)];
        tf32x3::split(m, ah[e], al[e]);
      }
      tf32x3::mma_split<NW, false, false>(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + 8 * half;
      if (i >= d) continue;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const long long c = c0 + nt * 8 + 2 * t;
        if (c >= p) continue;
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        if (out_bf16)
          store2(reinterpret_cast<__nv_bfloat16*>(out) + (long long)i * p + c, v0, v1,
                 c + 1 < p);
        else
          store2(reinterpret_cast<float*>(out) + (long long)i * p + c, v0, v1, c + 1 < p);
      }
    }
  }
}

// MT: m16 tiles in a row block; TX: X_old's element type; kFold: the
// chunk is a multiple of 32 (the fold route), else the dequantizing one.
// One block per SM (and row block), 16 warps.
template <int MT, typename TX, bool kFold>
__global__ void __launch_bounds__(kThreads, 1) quant_mix_kernel(Args a) {
  constexpr int XPT = x_pitch<TX>();
  constexpr int XEPC = 16 / (int)sizeof(TX);  // X_old elements per 16-byte chunk
  constexpr int XCPR = BN / XEPC;             // chunks per X_old stage row
  constexpr int QCPR = BN / 16;               // chunks per Q stage row
  extern __shared__ __align__(16) unsigned char smem[];

  const int d = a.d;
  const long long p = a.p, pq = a.pq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (tid >> 5) / kWarpCols;  // its m16 tiles: wr, wr + 2, ...
  const int nj = wr == 0 ? (MT + 1) / 2 : MT / 2;
  const int n0 = (tid >> 5) % kWarpCols * NW * 8;
  constexpr int rm = MT * 16;
  const int row0 = blockIdx.y * rm;
  const int kp = a.kp;                      // M pitch: 4 mod 16 words
  const int dk = (d + 7) / 8 * 8;           // a half of K, in whole k8 steps
  const int bkq = a.bkq;                    // rows of a Q stage
  const int nkq = (dk + bkq - 1) / bkq;     // Q stages
  const int nkt = nkq + (dk + BK - 1) / BK; // stages a column tile
  const int bx = blockIdx.x, gx = gridDim.x;
  const int nmine = bx < a.n_col_tiles ? (a.n_col_tiles - bx + gx - 1) / gx : 0;
  const int nitems = nmine * nkt;           // (column tile, stage) pairs
  const TX* x_old = reinterpret_cast<const TX*>(a.x_old);

  float* Ms = reinterpret_cast<float*>(smem);                 // [rm][kp]
  unsigned char* ring = smem + (size_t)rm * kp * sizeof(float);

  // compact K position of stage kt's first row: Q's rows at [0, dk),
  // X_old's at [dk, 2 dk)
  auto kstart = [&](int kt) { return kt < nkq ? kt * bkq : dk + (kt - nkq) * BK; };
  // rows of stage kt (a multiple of 8)
  auto rows_of = [&](int kt) {
    return kt < nkq ? min(bkq, dk - kt * bkq) : min(BK, 2 * dk - kstart(kt));
  };

  // [M_new | M_old] rows row0.., compact K columns cs.. (the stages of M
  // chunk `chunk`); zeros in the padding. Eight loads before their stores.
  auto load_m = [&](int chunk) {
    const int cs = kstart(chunk * a.ktpc), n = rm * a.kc;
    for (int e0 = tid; e0 < n; e0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / a.kc, k = cs + e - r * a.kc, i = row0 + r;
        const int half = k >= dk, kk = k - half * dk;
        v[u] = 0.f;
        if (e < n && i < d && k < 2 * dk && kk < d)
          v[u] = half ? a.m_old[(long long)i * d + kk] : a.m_new[(long long)i * d + kk];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / a.kc;
        if (e < n) Ms[r * kp + (e - r * a.kc)] = v[u];
      }
    }
  };

  // stage item w: the rows of stage kt of column tile j, Q as int8 or
  // X_old as TX; rows past D and columns past the buffer load zeros
  auto load_item = [&](int w) {
    const int j = w / nkt, kt = w - j * nkt;
    const long long col0 = (long long)(bx + j * gx) * BN;
    const int kr0 = kstart(kt) - (kt < nkq ? 0 : dk), rows = rows_of(kt);
    unsigned char* st = ring + (w % kStages) * kStageBytes;
    if (kt < nkq) {
      for (int e = tid; e < rows * QCPR; e += kThreads) {
        const int r = e / QCPR, c = e - r * QCPR, gk = kr0 + r;
        const long long gc = col0 + (long long)c * 16;
        const int nbytes = gk < d && gc < pq ? (int)min(16LL, pq - gc) : 0;
        cp_async::chunk16(st + r * QP + c * 16, nbytes ? a.q + (long long)gk * pq + gc : a.q,
                          nbytes);
      }
      if constexpr (kFold) {  // each warp column's scale of every row, after the rows
        float* ss = reinterpret_cast<float*>(st + bkq * QP);
        for (int e = tid; e < rows * kWarpCols; e += kThreads) {
          const int r = e / kWarpCols, gk = kr0 + r;
          const long long c = min((col0 + (e - r * kWarpCols) * 32) / a.chunk, a.nch - 1);
          cp_async::ca4(ss + e, gk < d ? a.scales + (long long)gk * a.nch + c : a.scales,
                        gk < d ? 4 : 0);
        }
      }
    } else {
      TX* xs = reinterpret_cast<TX*>(st);
      for (int e = tid; e < rows * XCPR; e += kThreads) {
        const int r = e / XCPR, c = e - r * XCPR, gk = kr0 + r;
        const long long gc = col0 + (long long)c * XEPC;
        const int nbytes =
            gk < d && gc < p ? (int)min((long long)XEPC, p - gc) * (int)sizeof(TX) : 0;
        cp_async::chunk16(xs + r * XPT + c * XEPC, nbytes ? x_old + (long long)gk * p + gc : x_old,
                          nbytes);
      }
    }
  };

  float acc[4][NW][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nitems) load_item(s);
    cp_async::commit();
  }
  const int nkc = (nkt + a.ktpc - 1) / a.ktpc;
  if (nkc == 1) load_m(0);  // once for all column tiles, while the ring fills

  QScales qs{a.scales, a.nch, 0, d, {0, 0, 0, 0}, nullptr};
  for (int w = 0; w < nitems; ++w) {
    cp_async::wait<kStages - 2>();
    __syncthreads();  // item w staged; every warp is done with item w - 1
    if (w + kStages - 1 < nitems) load_item(w + kStages - 1);
    cp_async::commit();
    const int kt = w % nkt;
    const int chunk = kt / a.ktpc;
    if (nkc > 1 && kt == chunk * a.ktpc) {
      load_m(chunk);
      __syncthreads();
    }
    const long long col0 = (long long)(bx + (w / nkt) * gx) * BN;
    if (!kFold && kt == 0) {  // a new column tile: its scale chunks (clamped past Pq)
      const long long last = a.nch - 1;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt)
        qs.c_lane[nt] = (int)min((col0 + n0 + nt * 8 + g) / a.chunk, last);
    }
    {
      const unsigned char* st = ring + (w % kStages) * kStageBytes;
      const int kl0 = kstart(kt) - kstart(chunk * a.ktpc);
      const int nks = rows_of(kt) / 8;
      if (kt >= nkq) {
        products<MT, kXOld, TX>(wr, acc, Ms, kp, st, kl0, nks, n0, g, t, qs);
      } else {
        qs.row0 = kt * bkq;
        if constexpr (kFold) {
          qs.ss = reinterpret_cast<const float*>(st + bkq * QP) + n0 / 32;
          products<MT, kQFold, TX>(wr, acc, Ms, kp, st, kl0, nks, n0, g, t, qs);
        } else {
          products<MT, kQDequant, TX>(wr, acc, Ms, kp, st, kl0, nks, n0, g, t, qs);
        }
      }
    }

    if (kt == nkt - 1) {  // the column tile is done: store and restart
      bool bad = false;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) bad |= !tf32x3::finite(acc[j][nt][c]);
      // an inf or NaN: the warp's part of the tile is taken again on the
      // full split (quant_mix_kernel_redo); every warp writes its flag
      const bool any_bad = __any_sync(0xffffffffu, bad);
      if (lane == 0)
        a.redo[((size_t)blockIdx.y * a.n_col_tiles + bx + (w / nkt) * gx) * kWarps +
               (tid >> 5)] = any_bad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = row0 + (wr + 2 * j) * 16 + g + 8 * half;
          if (i >= d) continue;
#pragma unroll
          for (int nt = 0; nt < NW; ++nt) {
            const long long c = col0 + n0 + nt * 8 + 2 * t;
            if (c >= p) continue;
            const float v0 = acc[j][nt][2 * half], v1 = acc[j][nt][2 * half + 1];
            if (a.out_bf16)
              store2(reinterpret_cast<__nv_bfloat16*>(a.out) + (long long)i * p + c, v0, v1,
                     c + 1 < p);
            else
              store2(reinterpret_cast<float*>(a.out) + (long long)i * p + c, v0, v1, c + 1 < p);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][nt][c] = 0.f;
    }
  }
  cp_async::wait<0>();
}

// The redo pass, launched after every quant_mix_kernel on the same grid:
// a warp whose flag its quant_mix_kernel warp set takes its part of the
// column tile again on the full split (tile_full); a call whose result
// held no inf or NaN reads its flags and exits.
template <typename TX>
__global__ void __launch_bounds__(kThreads) quant_mix_kernel_redo(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / kWarpCols;
  const int nj = wr == 0 ? (a.mt + 1) / 2 : a.mt / 2;
  const int n0 = warp % kWarpCols * NW * 8;
  for (int tile = blockIdx.x; tile < a.n_col_tiles; tile += gridDim.x)
    if (a.redo[((size_t)blockIdx.y * a.n_col_tiles + tile) * kWarps + warp])
      tile_full<TX>(a.m_new, a.m_old, a.q, a.scales, reinterpret_cast<const TX*>(a.x_old),
                    a.out, a.p, a.pq, a.nch, a.d, a.chunk, a.out_bf16, blockIdx.y * a.mt * 16,
                    wr, nj, (long long)tile * BN + n0, lane >> 2, lane & 3);
}

template <int MT, typename TX, bool kFold>
cudaError_t launch_mt(const Args& a, dim3 grid, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(quant_mix_kernel<MT, TX, kFold>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  quant_mix_kernel<MT, TX, kFold><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(Args a, cudaStream_t stream) {
  int dev = 0, nsm = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int mt_total = (a.d + 15) / 16;
  const int nrb = (mt_total + kMaxMT - 1) / kMaxMT;  // row blocks
  a.mt = (mt_total + nrb - 1) / nrb;                 // m16 tiles per row block
  const int ring = kStages * kStageBytes;
  const int dk = (a.d + 7) / 8 * 8;
  const int nkx = (dk + BK - 1) / BK;
  // all of [M_new | M_old] beside the ring where it fits, else chunks of
  // whole stages
  const int kfit = (smem_max - ring) / (16 * a.mt * 4);
  const int kc_max = kfit - 31;
  if (m_pitch(2 * dk) <= kfit) {  // Q's half in stages of up to kBKQ rows
    a.bkq = kBKQ;
    a.kc = 2 * dk;
    a.ktpc = (dk + kBKQ - 1) / kBKQ + nkx;
  } else {  // chunks of M of whole 40-row stages
    a.bkq = BK;
    a.ktpc = kc_max / BK;
    if (a.ktpc < 1) return cudaErrorInvalidConfiguration;
    a.kc = a.ktpc * BK;
  }
  a.kp = m_pitch(a.kc);
  const size_t bytes = (size_t)16 * a.mt * a.kp * sizeof(float) + ring;
  const long long ncol = (a.p + BN - 1) / BN;
  long long gx = nsm / nrb;
  gx = gx < 1 ? 1 : (gx > ncol ? ncol : gx);
  a.n_col_tiles = (int)ncol;
  a.fold = a.chunk % 32 == 0;
  const dim3 grid((unsigned)gx, (unsigned)nrb);
#define FED_MIX_Q_MT(N)                                                                    \
  case N:                                                                                  \
    err = a.fold ? launch_mt<N, TX, true>(a, grid, bytes, stream)                          \
                 : launch_mt<N, TX, false>(a, grid, bytes, stream);                        \
    break;
  switch (a.mt) {
    FED_MIX_Q_MT(1)
    FED_MIX_Q_MT(2)
    FED_MIX_Q_MT(3)
    FED_MIX_Q_MT(4)
    FED_MIX_Q_MT(5)
    FED_MIX_Q_MT(6)
    FED_MIX_Q_MT(7)
    default:
      err = a.fold ? launch_mt<8, TX, true>(a, grid, bytes, stream)
                   : launch_mt<8, TX, false>(a, grid, bytes, stream);
  }
#undef FED_MIX_Q_MT
  if (err != cudaSuccess) return err;
  quant_mix_kernel_redo<TX><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One translation unit by default; built as two (KERNEL_PART 0: the f32
// x_old kernels and the entry points, 1: the bf16 x_old kernels),
// compiled at once and linked into one library, each half instantiating
// its dtype's templates only.
#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif

extern "C" {

#if KERNEL_PART != 1
int fed_mix_q_launch_f32(const void* a, void* stream) {  // a: Args
  return (int)launch<float>(*(const Args*)a, (cudaStream_t)stream);
}
#endif
#if KERNEL_PART != 0
int fed_mix_q_launch_bf16(const void* a, void* stream) {  // a: Args
  return (int)launch<__nv_bfloat16>(*(const Args*)a, (cudaStream_t)stream);
}
#else
int fed_mix_q_launch_bf16(const void* a, void* stream);
#endif

#if KERNEL_PART != 1
// Bytes of the redo flags fed_mix_q_launch needs at (D, P): one per warp
// of every (row block, column tile).
long long fed_mix_q_redo_bytes(int d, long long p) {
  const int mt_total = (d + 15) / 16;
  return (long long)((mt_total + kMaxMT - 1) / kMaxMT) * ((p + BN - 1) / BN) * kWarps;
}

// m_new/m_old [D, D] f32, q [D, Pq] int8 (any byte alignment), scales
// [D, Pq / chunk] f32, x_old [D, P] (f32 when x_bf16 == 0, else bf16),
// out [D, P] (f32 when out_bf16 == 0, else bf16), all contiguous;
// Pq % chunk == 0, P <= Pq; redo: fed_mix_q_redo_bytes(d, p) bytes of
// scratch. Two launches on `stream` (the product, the redo pass); returns
// the first failure of cudaGetLastError().
int fed_mix_q_launch(const void* m_new, const void* m_old, const void* q,
                     const void* scales, const void* x_old, void* out, void* redo, int d,
                     long long p, long long pq, int chunk, int x_bf16, int out_bf16,
                     void* stream) {
  Args a{(const float*)m_new, (const float*)m_old, (const int8_t*)q, (const float*)scales,
         x_old, out, (unsigned char*)redo, p, pq, pq / chunk, d, chunk, 0, 0, 0, 0, 0, 0, 0,
         out_bf16};
  return x_bf16 ? fed_mix_q_launch_bf16(&a, stream) : fed_mix_q_launch_f32(&a, stream);
}
#endif

}  // extern "C"
