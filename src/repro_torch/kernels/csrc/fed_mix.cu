// fed_mix — the dense mixing kernel, hand-written for Hopper (sm_90a).
//
//   out = M_new @ X_new + M_old @ X_old
//
// with M_new/M_old the [D, D] f32 client-mixing matrices and X_new/X_old
// the packed [D, P] client buffers (f32 or bf16), accumulated in full f32
// and stored in X_new's dtype.
//
// Replaces: src/repro/kernels/fed_mix.py · fed_mix (Pallas
// _fed_mix_kernel: two MXU contractions per K step into an f32 VMEM
// accumulator, f32 throughout via preferred_element_type).
//
// What bounds it on the card: operations. It is one [D, 2D] @ [2D, P]
// product, 4·D²·P flops; at the main path's shape (D = 100, P = 246,590)
// that is ≈ 9.9 GFLOP on ≈ 296 MB, about 33 flops per byte. Full f32 rules
// out the tensor cores (TF32 keeps ~3 decimal digits), so the ceiling is
// the CUDA cores' f32 rate, and at that rate the flops take longer than
// the bytes.
//
// What the design does about it: a register-blocked SGEMM on CUDA cores,
// FFMA in full f32 (no TF32, no library GEMM). The concatenated operand
// [M_new | M_old] @ [X_new ; X_old] is read in place: the K loop runs over
// 2D and each K index picks its matrix, so no concatenation copy is made.
// A block computes a 128 x 128 output tile with 256 threads; each thread
// holds an 8 x 8 accumulator in registers, so each value it reads from
// shared memory feeds eight FFMAs, and it reads them as 16-byte vectors
// (two runs of four rows and of four columns, half a tile apart, which
// keeps the warp's shared-memory reads free of bank conflicts). K steps
// through 8-deep tiles of both operands staged in shared memory; X tiles
// are loaded with consecutive threads on consecutive columns (coalesced),
// bf16 widened to f32 on load; ragged D and P edges load zeros and are
// masked on store. What it leaves on the table: each tile's loads are
// waited for before its FFMAs (no asynchronous staging), and with D = 100
// the 128-row tile is 78 % full. Later work: cp.async / TMA double
// buffering, and a row tile fitted to D.
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

template <typename T>
__global__ void __launch_bounds__(NT, 2)
dense_mix_kernel(const float* __restrict__ m_new, const float* __restrict__ m_old,
                 const T* __restrict__ x_new, const T* __restrict__ x_old,
                 T* __restrict__ out, int d, int64_t p) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  const int row0 = blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int k_total = 2 * d;

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
    // B tile [BK, BN]: consecutive threads on consecutive columns
#pragma unroll
    for (int j = 0; j < BK * BN / NT; ++j) {
      const int e = tid + j * NT;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk;
      const int64_t gj = col0 + c;
      float v = 0.f;
      if (gk < k_total && gj < p)
        v = gk < d ? to_f32(x_new[(int64_t)gk * p + gj])
                   : to_f32(x_old[(int64_t)(gk - d) * p + gj]);
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
      if (gj < p) out[(int64_t)gi * p + gj] = from_f32<T>(acc[m][n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* m_new, const void* m_old, const void* x_new,
                   const void* x_old, void* out, int d, int64_t p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p + BN - 1) / BN), (unsigned)((d + BM - 1) / BM));
  dense_mix_kernel<T><<<grid, NT, 0, stream>>>(
      (const float*)m_new, (const float*)m_old, (const T*)x_new, (const T*)x_old,
      (T*)out, d, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m_new/m_old [D, D] f32, x_new/x_old/out [D, P] contiguous (f32 when
// is_bf16 == 0, else bf16). Launches on `stream` and returns
// cudaGetLastError().
int fed_mix_launch(const void* m_new, const void* m_old, const void* x_new,
                   const void* x_old, void* out, int d, long long p, int is_bf16,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(m_new, m_old, x_new, x_old, out, d, p, s);
  return (int)launch<float>(m_new, m_old, x_new, x_old, out, d, p, s);
}

}  // extern "C"
