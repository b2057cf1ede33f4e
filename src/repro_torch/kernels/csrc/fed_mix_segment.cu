// fed_mix_segment — the cluster-segment mixing kernel, hand-written for
// Hopper (sm_90a).
//
//   out[i, :] = sum_{j : c(j) = c(i)} (w_new[j] * x_new[j, :] + w_old[j] * x_old[j, :])
//
// on the packed [D clients, P params] buffers, accumulated in f32 and
// stored in x_new's dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/fed_mix_sparse.py · fed_mix_segment, whose
// two Pallas calls are _segment_reduce_kernel (per-segment sums [Lp, P]
// through one-hot MXU contractions, L padded to 128 lanes) and
// _gather_broadcast_kernel (segment sums back to member rows).
//
// What bounds it on the card: memory. Per output element it does four
// flops against eight bytes read and four written (f32), so it is three
// orders of magnitude below the card's flop/byte balance. At the main
// path's shape (D = 100, P = 246,590, f32) one launch must move
// 2·D·P·4 + D·P·4 ≈ 296 MB.
//
// What the design does about it: all the parallelism lies along P, so each
// thread owns two adjacent columns of the [D, P] buffers (one 8-byte load
// per row; one column when P is odd or a buffer is not 8-byte aligned) and
// a block owns a tile of consecutive columns. The thread walks the D rows
// in order and adds each row's weighted pair into its columns' slots for
// that row's segment, then writes every row's segment sum back. Each row
// load and store of a warp is one coalesced line; x_new and x_old are read
// once and out is written once, with no intermediate in device memory (the
// TPU version's [Lp, P] round trip is gone, and so is its one-hot padding
// of L). The per-segment sums live in shared memory, [L, 2 x tile]: every
// slot belongs to one thread, so there are no atomics and no barriers, and
// each sum is taken in row order with round-to-nearest adds, which makes
// the result deterministic. Loads of eight rows are issued before their
// adds, so each thread keeps sixteen loads in flight. When [L, 2 x 32]
// floats do not fit in shared memory (L > 908), the same kernel keeps the
// sums in an [L, P] f32 scratch buffer in device memory instead (the
// two-pass layout, still one launch).
//
// Bad cluster ids: a row whose id lies outside [0, L) adds nothing to any
// segment, its output row is NaN, and the kernel sets *bad_ids to 1. The
// host reads that flag at its next synchronisation, not at every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsInFlight = 8;
constexpr int kMaxVec = 2;  // columns per thread on the aligned, even-P path
constexpr int kMaxTile = 256;
constexpr int kMinTile = 32;
// shared memory a block aims to stay under, so several blocks share an SM
constexpr size_t kSmemTarget = 48 * 1024;

// V adjacent columns of one row as one load: the vector type, and its
// conversion to and from V floats (bf16 rounds to nearest even)
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <> struct Vec<__nv_bfloat16, 2> { using type = __nv_bfloat162; };

__device__ __forceinline__ void unpack(float v, float* f) { f[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* f) { f[0] = v.x; f[1] = v.y; }
__device__ __forceinline__ void unpack(__nv_bfloat16 v, float* f) { f[0] = __bfloat162float(v); }
__device__ __forceinline__ void unpack(__nv_bfloat162 v, float* f) {
  f[0] = __low2float(v); f[1] = __high2float(v);
}
template <typename VT> __device__ __forceinline__ VT pack(const float* f);
template <> __device__ __forceinline__ float pack<float>(const float* f) { return f[0]; }
template <> __device__ __forceinline__ float2 pack<float2>(const float* f) { return make_float2(f[0], f[1]); }
template <> __device__ __forceinline__ __nv_bfloat16 pack<__nv_bfloat16>(const float* f) {
  return __float2bfloat16_rn(f[0]);
}
template <> __device__ __forceinline__ __nv_bfloat162 pack<__nv_bfloat162>(const float* f) {
  return __floats2bfloat162_rn(f[0], f[1]);
}

// Thread t owns V consecutive columns. gseg == nullptr: sums in dynamic
// shared memory, slot (l, v) of thread t at (l * V + v) * blockDim.x + t.
// gseg != nullptr: sums in the [L, P] scratch buffer at l * p + col + v.
template <typename T, int V>
__global__ void segment_mix_kernel(const int32_t* __restrict__ ids,
                                   const float* __restrict__ w_new,
                                   const float* __restrict__ w_old,
                                   const T* __restrict__ x_new,
                                   const T* __restrict__ x_old,
                                   T* __restrict__ out,
                                   float* __restrict__ gseg,
                                   int* __restrict__ bad_ids,
                                   int d, int64_t p, int num_segments) {
  using VT = typename Vec<T, V>::type;
  extern __shared__ float sseg[];
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= p) return;
  float* seg;
  int64_t stride, vstride;
  if (gseg != nullptr) {
    seg = gseg + col;
    stride = p;
    vstride = 1;
  } else {
    seg = sseg + threadIdx.x;
    stride = (int64_t)blockDim.x * V;
    vstride = blockDim.x;
  }
  for (int l = 0; l < num_segments; ++l)
#pragma unroll
    for (int v = 0; v < V; ++v) seg[l * stride + v * vstride] = 0.f;
  const VT* xn = reinterpret_cast<const VT*>(x_new + col);
  const VT* xo = reinterpret_cast<const VT*>(x_old + col);
  const int64_t pv = p / V;  // row stride in vectors (V divides p)

  for (int i0 = 0; i0 < d; i0 += kRowsInFlight) {
    float y[kRowsInFlight][V];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u;
      if (i < d) {
        float a[V], b[V];
        unpack(xn[(int64_t)i * pv], a);
        unpack(xo[(int64_t)i * pv], b);
#pragma unroll
        for (int v = 0; v < V; ++v)
          y[u][v] = __fadd_rn(__fmul_rn(w_new[i], a[v]), __fmul_rn(w_old[i], b[v]));
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u;
      if (i < d) {
        const int c = ids[i];
        if ((unsigned)c >= (unsigned)num_segments) {
          if (col == 0) *bad_ids = 1;
          continue;
        }
        float* slot = seg + c * stride;
#pragma unroll
        for (int v = 0; v < V; ++v)
          slot[v * vstride] = __fadd_rn(slot[v * vstride], y[u][v]);
      }
    }
  }
  VT* o = reinterpret_cast<VT*>(out + col);
  for (int i = 0; i < d; ++i) {
    const int c = ids[i];
    float f[V];
    if ((unsigned)c < (unsigned)num_segments) {
      const float* slot = seg + c * stride;
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = slot[v * vstride];
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = __int_as_float(0x7fc00000);  // NaN
    }
    o[(int64_t)i * pv] = pack<VT>(f);
  }
}

size_t max_smem_per_block() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// Widest power-of-two tile (32..256 threads) whose [slots, tile] sums stay
// under kSmemTarget; 0 when even [slots, 32] exceeds the block's shared-
// memory limit. slots = L x columns per thread.
int tile_for(int slots) {
  int tile = kMaxTile;
  while (tile > kMinTile && (size_t)slots * tile * sizeof(float) > kSmemTarget) tile /= 2;
  if ((size_t)slots * tile * sizeof(float) > max_smem_per_block()) return 0;
  return tile;
}

template <typename T, int V>
cudaError_t launch_v(const void* ids, const void* w_new, const void* w_old,
                     const void* x_new, const void* x_old, void* out, void* scratch,
                     void* bad_ids, int d, int64_t p, int num_segments,
                     cudaStream_t stream) {
  int tile = tile_for(num_segments * V);
  size_t smem = 0;
  if (scratch == nullptr) {
    if (tile == 0) return cudaErrorInvalidValue;
    smem = (size_t)num_segments * tile * V * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          segment_mix_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
  } else {
    tile = kMaxTile;
  }
  const int64_t threads = (p + V - 1) / V;
  const int64_t blocks = (threads + tile - 1) / tile;
  segment_mix_kernel<T, V><<<(unsigned)blocks, tile, smem, stream>>>(
      (const int32_t*)ids, (const float*)w_new, (const float*)w_old,
      (const T*)x_new, (const T*)x_old, (T*)out, (float*)scratch, (int*)bad_ids, d,
      p, num_segments);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* ids, const void* w_new, const void* w_old,
                   const void* x_new, const void* x_old, void* out, void* scratch,
                   void* bad_ids, int d, int64_t p, int num_segments,
                   cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)x_new | (uintptr_t)x_old | (uintptr_t)out;
  if (p % kMaxVec == 0 && addr % (kMaxVec * sizeof(T)) == 0)  // vectors stay aligned
    return launch_v<T, kMaxVec>(ids, w_new, w_old, x_new, x_old, out, scratch, bad_ids,
                                d, p, num_segments, stream);
  return launch_v<T, 1>(ids, w_new, w_old, x_new, x_old, out, scratch, bad_ids, d, p,
                        num_segments, stream);
}

}  // namespace

extern "C" {

// 1 when the [L, 2 x 32] sums do not fit in shared memory and the caller
// must pass an [L, P] f32 scratch buffer, else 0.
int fed_mix_segment_needs_scratch(int num_segments) {
  return tile_for(kMaxVec * num_segments) == 0 ? 1 : 0;
}

// ids [D] int32, w_new/w_old [D] f32, x_new/x_old/out [D, P] contiguous
// (f32 when is_bf16 == 0, else bf16); scratch null or [L, P] f32; bad_ids
// one int the kernel sets to 1 when an id lies outside [0, L).
// Launches on `stream` and returns cudaGetLastError().
int fed_mix_segment_launch(const void* ids, const void* w_new, const void* w_old,
                           const void* x_new, const void* x_old, void* out,
                           void* scratch, void* bad_ids, int d, long long p,
                           int num_segments, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(ids, w_new, w_old, x_new, x_old, out, scratch,
                                      bad_ids, d, p, num_segments, s);
  return (int)launch<float>(ids, w_new, w_old, x_new, x_old, out, scratch, bad_ids, d,
                            p, num_segments, s);
}

}  // extern "C"
