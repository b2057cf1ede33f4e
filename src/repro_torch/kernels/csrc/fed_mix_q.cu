// fed_mix_q — the dense mixing kernel of the int8 wire, hand-written for
// Hopper (sm_90a).
//
//   out = M_new @ dequant(Q, scales) + M_old @ X_old
//   dequant(Q, scales)[k, j] = float(Q[k, j]) * scales[k, j / chunk]
//
// with M_new/M_old the [D, D] f32 client-mixing matrices, Q the int8
// [D, Pq] wire record of the new client buffer (Pq a multiple of chunk,
// one f32 absmax scale per chunk of a row), and X_old the [D, P <= Pq]
// round-start buffer (f32 or bf16); accumulated in full f32 and stored in
// the requested output dtype (f32 or bf16). Only the first P columns are
// computed: Q's padding columns never reach the output.
//
// Replaces: src/repro/kernels/fed_mix_q.py · fed_mix_q (Pallas
// _fed_mix_q_kernel: the int8 tile is dequantized in VMEM inside the MXU
// K loop, so no full-precision copy of Q exists anywhere).
//
// What bounds it on the card: operations. It is one [D, 2D] @ [2D, P]
// product, 4·D²·P flops; at the engine's shape (D = 100, P = 246,590,
// Pq = 246,784) that is ≈ 9.9 GFLOP on ≈ 222 MB (Q 24.7 MB, scales
// 0.39 MB, X_old 98.6 MB, out 98.6 MB). Full f32 rules out the tensor
// cores, so the ceiling is the CUDA cores' f32 rate.
//
// What the design does about it: fed_mix.cu's register-blocked SGEMM on
// CUDA cores (128 x 128 output tile, 256 threads, 8 x 8 accumulators per
// thread, 8-deep K tiles in shared memory, FFMA in full f32, no TF32).
// The K loop runs over [M_new | M_old] against [dequant(Q) ; X_old], both
// read in place. For the first D rows of K the B-tile loader reads Q as
// int8, four columns per 32-bit load (one byte at a time when Q's rows are
// not 4-byte aligned), and multiplies each by its row's chunk scale: the
// dequantized values live only in the shared-memory tile and registers,
// and nothing of Q is ever written back as f32. A thread loads the same
// columns in every K tile, so it works out their chunk indices once. Any
// chunk works; a 128-column tile spans two chunks of 64, one of 128 or
// half of 256. What it leaves on the table is fed_mix.cu's: no
// asynchronous staging of the tiles, and a 128-row tile that D = 100
// fills to 78 %.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // output rows per block
constexpr int BN = 128;   // output columns per block
constexpr int BK = 8;     // K depth per shared-memory tile
constexpr int TM = 8;     // rows per thread
constexpr int TN = 8;     // columns per thread: two runs of 4, BN/2 apart
constexpr int TR = BM / TM;            // 16 thread rows
constexpr int TC = BN / TN;            // 16 thread columns
constexpr int NT = TR * TC;            // 256 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// QV int8 columns of one row of Q per load: 4 (one 32-bit load) or 1.
template <int QV> struct QLoad;
template <> struct QLoad<4> {
  static __device__ __forceinline__ void run(const int8_t* q, float* f) {
    const char4 v = *reinterpret_cast<const char4*>(q);
    f[0] = (float)v.x; f[1] = (float)v.y; f[2] = (float)v.z; f[3] = (float)v.w;
  }
};
template <> struct QLoad<1> {
  static __device__ __forceinline__ void run(const int8_t* q, float* f) { f[0] = (float)*q; }
};

template <typename TX, typename TO, int QV>
__global__ void __launch_bounds__(NT, 2)
quant_mix_kernel(const float* __restrict__ m_new, const float* __restrict__ m_old,
                 const int8_t* __restrict__ q, const float* __restrict__ scales,
                 const TX* __restrict__ x_old, TO* __restrict__ out, int d, int64_t p,
                 int64_t pq, int chunk) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  constexpr int QGROUPS = BK * BN / QV;          // QV-column groups per B tile
  constexpr int QPER = QGROUPS / NT;             // groups per thread

  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  const int row0 = blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int k_total = 2 * d;
  const int64_t n_chunks = pq / chunk;

  // this thread's Q columns are the same in every K tile (QGROUPS is a
  // multiple of NT and of BN / QV): their chunk indices, worked out once
  const int qc = (tid % (BN / QV)) * QV;
  const int64_t qcol = col0 + qc;
  int sc_col[QV];
#pragma unroll
  for (int v = 0; v < QV; ++v) sc_col[v] = (int)((qcol + v) / chunk);

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    // A tile [BM, BK]: thread e -> (row e / BK, k e % BK), stored As[k][row]
#pragma unroll
    for (int j = 0; j < BM * BK / NT; ++j) {
      const int e = tid + j * NT;
      const int r = e / BK, kk = e % BK;
      const int gi = row0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gi < d && gk < k_total)
        v = gk < d ? m_new[(int64_t)gi * d + gk] : m_old[(int64_t)gi * d + (gk - d)];
      As[kk][r] = v;
    }
    // B tile rows of dequant(Q): QV int8 columns a load, times the scale
#pragma unroll
    for (int j = 0; j < QPER; ++j) {
      const int kk = (tid + j * NT) / (BN / QV);
      const int gk = k0 + kk;
      if (gk >= d) continue;
      float f[QV];
      if (qcol < pq) {
        QLoad<QV>::run(q + (int64_t)gk * pq + qcol, f);
        const float* sc_row = scales + (int64_t)gk * n_chunks;
#pragma unroll
        for (int v = 0; v < QV; ++v) f[v] = __fmul_rn(f[v], sc_row[sc_col[v]]);
      } else {
#pragma unroll
        for (int v = 0; v < QV; ++v) f[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < QV; ++v) Bs[kk][qc + v] = f[v];
    }
    // B tile rows of X_old (and zero padding past 2D): consecutive
    // threads on consecutive columns
#pragma unroll
    for (int j = 0; j < BK * BN / NT; ++j) {
      const int e = tid + j * NT;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk;
      if (gk < d) continue;
      const int64_t gj = col0 + c;
      float v = 0.f;
      if (gk < k_total && gj < p) v = to_f32(x_old[(int64_t)(gk - d) * p + gj]);
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tr * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4 + BN / 2]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int gi = row0 + tr * 4 + (m & 3) + (m >> 2) * (BM / 2);
    if (gi >= d) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int64_t gj = col0 + tc * 4 + (n & 3) + (n >> 2) * (BN / 2);
      if (gj < p) out[(int64_t)gi * p + gj] = from_f32<TO>(acc[m][n]);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* m_new, const void* m_old, const void* q, const void* scales,
                   const void* x_old, void* out, int d, int64_t p, int64_t pq, int chunk,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((p + BN - 1) / BN), (unsigned)((d + BM - 1) / BM));
  const bool vec = pq % 4 == 0 && (uintptr_t)q % 4 == 0;   // 32-bit loads stay aligned
  if (vec)
    quant_mix_kernel<TX, TO, 4><<<grid, NT, 0, stream>>>(
        (const float*)m_new, (const float*)m_old, (const int8_t*)q, (const float*)scales,
        (const TX*)x_old, (TO*)out, d, p, pq, chunk);
  else
    quant_mix_kernel<TX, TO, 1><<<grid, NT, 0, stream>>>(
        (const float*)m_new, (const float*)m_old, (const int8_t*)q, (const float*)scales,
        (const TX*)x_old, (TO*)out, d, p, pq, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m_new/m_old [D, D] f32, q [D, Pq] int8, scales [D, Pq / chunk] f32,
// x_old [D, P] (f32 when x_bf16 == 0, else bf16), out [D, P] (f32 when
// out_bf16 == 0, else bf16), all contiguous; Pq % chunk == 0, P <= Pq.
// Launches on `stream` and returns cudaGetLastError().
int fed_mix_q_launch(const void* m_new, const void* m_old, const void* q,
                     const void* scales, const void* x_old, void* out, int d, long long p,
                     long long pq, int chunk, int x_bf16, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16 && out_bf16)
    return (int)launch<bf16, bf16>(m_new, m_old, q, scales, x_old, out, d, p, pq, chunk, s);
  if (x_bf16)
    return (int)launch<bf16, float>(m_new, m_old, q, scales, x_old, out, d, p, pq, chunk, s);
  if (out_bf16)
    return (int)launch<float, bf16>(m_new, m_old, q, scales, x_old, out, d, p, pq, chunk, s);
  return (int)launch<float, float>(m_new, m_old, q, scales, x_old, out, d, p, pq, chunk, s);
}

}  // extern "C"
