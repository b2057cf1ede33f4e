// fed_aggregate — the paper's Aggregate(·) operator, hand-written for
// Hopper (sm_90a).
//
//   out[j] = sum_n w[n] * x[n, j]
//
// over N stacked client (or cluster) replicas of a packed [N, D] parameter
// buffer (f32 or bf16), accumulated in f32 and stored in x's dtype.
//
// Replaces: src/repro/kernels/fed_aggregate.py · fed_aggregate (Pallas
// _fed_aggregate_kernel: one [1, N] x [N, block_d] MXU pass per parameter
// tile).
//
// What bounds it on the card: memory. Two flops per element read; at
// N = 100, D = 246,590, f32 one launch must move N·D·4 + D·4 ≈ 99.6 MB.
//
// What the design does about it: all the parallelism lies along D. A
// thread owns V adjacent columns (2 for f32, 4 for bf16: one 8-byte load
// per row; one column when D is not a multiple of V or a buffer is not
// aligned) and walks the N rows in order with f32 fused multiply-adds,
// issuing the loads of eight rows before their adds. Each row load of a
// warp is one coalesced line, x is read once and out written once, and
// every column's sum is taken in the same fixed order: deterministic, no
// atomics, no second pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 8;

// V adjacent elements of one row as one load, and their conversion to and
// from V floats (bf16 rounds to nearest even)
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };

__device__ __forceinline__ void unpack(float v, float* f) { f[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* f) { f[0] = v.x; f[1] = v.y; }
__device__ __forceinline__ void unpack(__nv_bfloat16 v, float* f) { f[0] = __bfloat162float(v); }
__device__ __forceinline__ void unpack(uint2 v, float* f) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(lo); f[1] = __high2float(lo);
  f[2] = __low2float(hi); f[3] = __high2float(hi);
}
template <typename VT> __device__ __forceinline__ VT pack(const float* f);
template <> __device__ __forceinline__ float pack<float>(const float* f) { return f[0]; }
template <> __device__ __forceinline__ float2 pack<float2>(const float* f) {
  return make_float2(f[0], f[1]);
}
template <> __device__ __forceinline__ __nv_bfloat16 pack<__nv_bfloat16>(const float* f) {
  return __float2bfloat16_rn(f[0]);
}
template <> __device__ __forceinline__ uint2 pack<uint2>(const float* f) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                 int n, int64_t d) {
  using VT = typename Vec<T, V>::type;
  const int64_t col = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= d) return;
  const VT* xv = reinterpret_cast<const VT*>(x + col);
  const int64_t dv = d / V;  // row stride in vectors (V divides d)
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int i0 = 0; i0 < n; i0 += kRowsInFlight) {
    VT rows[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (i0 + u < n) rows[u] = xv[(int64_t)(i0 + u) * dv];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (i0 + u >= n) break;
      float f[V];
      unpack(rows[u], f);
      const float wi = w[i0 + u];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(wi, f[v], acc[v]);
    }
  }
  *reinterpret_cast<VT*>(out + col) = pack<VT>(acc);
}

template <typename T, int V>
cudaError_t launch_v(const void* x, const void* w, void* out, int n, int64_t d,
                     cudaStream_t stream) {
  const int64_t threads = (d + V - 1) / V;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  aggregate_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)w, (T*)out, n, d);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* w, void* out, int n, int64_t d,
                   cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)out;
  if (d % V == 0 && addr % (V * sizeof(T)) == 0)  // vectors stay aligned
    return launch_v<T, V>(x, w, out, n, d, stream);
  return launch_v<T, 1>(x, w, out, n, d, stream);
}

}  // namespace

extern "C" {

// x [N, D] contiguous (f32 when is_bf16 == 0, else bf16), w [N] f32,
// out [D] of x's dtype. Launches on `stream` and returns
// cudaGetLastError().
int fed_aggregate_launch(const void* x, const void* w, void* out, int n, long long d,
                         int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)launch<__nv_bfloat16, 4>(x, w, out, n, d, s);
  return (int)launch<float, 2>(x, w, out, n, d, s);
}

}  // extern "C"
