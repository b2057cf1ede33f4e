// fed_mix_matching — the pairwise-matching mixing kernel of the gossip
// family, hand-written for Hopper (sm_90a).
//
//   eff = s * x_new + (1 - s) * x_old          (per row; s the survive mask)
//   eff = 0.5 * (eff + eff[perm_s])            for each stage s = 0 .. S-1
//   out = eff                                   (in x_new's dtype)
//
// on the packed [D clients, P params] buffers, in f32, stored in x_new's
// dtype (f32 or bf16). perm_s[i] is row i's partner in stage s (itself for
// a bye); nothing assumes a stage is an involution.
//
// Replaces: src/repro/kernels/fed_mix_sparse.py · fed_mix_matching, whose
// Pallas call is _pair_average_kernel (one halving add per stage on rows
// that XLA gathered beforehand: S round trips of [D, P] through HBM).
//
// What bounds it on the card: memory. Per output element it does a few
// flops against eight bytes read and four written (f32). At the main
// path's shape (D = 100, P = 246,590, f32) one launch must move
// 3·D·P·4 ≈ 296 MB.
//
// What the design does about it: all the parallelism lies along P, and a
// stage mixes whole rows, so a block owns a tile of consecutive columns
// and holds all D rows of that tile in shared memory as f32, in two ping-
// pong buffers. It loads x_new and x_old once (consecutive threads on
// consecutive columns: coalesced), fuses the straggler substitution into
// that load, runs the S stages between __syncthreads(), and writes the
// last stage straight to out: each byte is moved once. Every operation is
// one IEEE rounding in the plain version's order (__fmul_rn / __fadd_rn,
// so nvcc cannot contract them into an FMA), which makes the kernel equal
// to the plain version bit for bit. When D rows of even a 32-column tile
// do not fit twice in shared memory (D > ~900), the kernel runs one launch
// per stage through device memory instead: stage 0 computes eff on the fly
// from x_new/x_old, the middle stages ping-pong between two [D, P] f32
// scratch buffers, and the last stage writes out.
//
// A partner index outside [0, D) makes that output row NaN (jnp.take's
// fill mode); the CPU wrapper raises on it before any launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;
constexpr int kMinTile = 32;
// shared memory a block aims to stay under, so several blocks share an SM
constexpr size_t kSmemTarget = 56 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float substitute(float s, float xn, float xo) {
  return __fadd_rn(__fmul_rn(s, xn), __fmul_rn(__fsub_rn(1.f, s), xo));
}

__device__ __forceinline__ float halve_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// Shared-memory path: block b owns columns [b * tile, (b + 1) * tile).
// buf[k] holds the tile's D rows, element (i, c) at i * tile + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
matching_mix_kernel(const int32_t* __restrict__ perms, const float* __restrict__ survive,
                    const T* __restrict__ x_new, const T* __restrict__ x_old,
                    T* __restrict__ out, int d, int64_t p, int stages, int tile) {
  extern __shared__ float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + (size_t)d * tile;
  const int64_t col0 = (int64_t)blockIdx.x * tile;
  const int width = p - col0 < tile ? (int)(p - col0) : tile;
  const int n = d * tile;

  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / tile, c = e % tile;
    if (c < width) {
      const int64_t g = (int64_t)i * p + col0 + c;
      const float v = substitute(survive[i], to_f32(x_new[g]), to_f32(x_old[g]));
      if (stages == 0) out[g] = from_f32<T>(v);
      else buf0[e] = v;
    }
  }
  for (int s = 0; s < stages; ++s) {
    __syncthreads();
    const float* src = (s & 1) ? buf1 : buf0;
    float* dst = (s & 1) ? buf0 : buf1;
    const int32_t* perm = perms + (int64_t)s * d;
    const bool last = s == stages - 1;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int i = e / tile, c = e % tile;
      if (c >= width) continue;
      const int j = perm[i];
      const float v = (unsigned)j < (unsigned)d ? halve_sum(src[e], src[j * tile + c])
                                                : nan_f32();
      if (last) out[(int64_t)i * p + col0 + c] = from_f32<T>(v);
      else dst[e] = v;
    }
  }
}

// Device-memory path, one launch per stage over the whole [D, P] buffer:
// stage 0 reads x_new/x_old (computing eff of a row and of its partner),
// a later stage reads the previous stage's f32 buffer. The last stage (or
// stage 0 of a zero-stage call, which writes eff itself) stores T.
template <typename T, bool kFirst, typename TOut>
__global__ void __launch_bounds__(kThreads)
matching_stage_kernel(const int32_t* __restrict__ perm, const float* __restrict__ survive,
                      const T* __restrict__ x_new, const T* __restrict__ x_old,
                      const float* __restrict__ src, TOut* __restrict__ dst, int d,
                      int64_t p) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (col >= p) return;
  const int64_t g = (int64_t)i * p + col;
  float v;
  if (kFirst) {
    const float a = substitute(survive[i], to_f32(x_new[g]), to_f32(x_old[g]));
    if (perm == nullptr) {
      v = a;
    } else {
      const int j = perm[i];
      if ((unsigned)j < (unsigned)d) {
        const int64_t h = (int64_t)j * p + col;
        v = halve_sum(a, substitute(survive[j], to_f32(x_new[h]), to_f32(x_old[h])));
      } else {
        v = nan_f32();
      }
    }
  } else {
    const int j = perm[i];
    v = (unsigned)j < (unsigned)d ? halve_sum(src[g], src[(int64_t)j * p + col]) : nan_f32();
  }
  dst[g] = from_f32<TOut>(v);
}

size_t max_smem_per_block() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

size_t smem_bytes(int d, int tile) { return 2 * (size_t)d * tile * sizeof(float); }

// Widest power-of-two tile (32..256 columns) whose two [D, tile] buffers
// stay under kSmemTarget; 0 when even [D, 32] twice exceeds the block's
// shared-memory limit.
int tile_for(int d) {
  int tile = kMaxTile;
  while (tile > kMinTile && smem_bytes(d, tile) > kSmemTarget) tile /= 2;
  if (smem_bytes(d, tile) > max_smem_per_block()) return 0;
  return tile;
}

template <typename T>
cudaError_t launch(const int32_t* perms, const float* survive, const T* x_new,
                   const T* x_old, T* out, float* scratch, int d, int64_t p, int stages,
                   cudaStream_t stream) {
  const int tile = tile_for(d);
  if (tile > 0) {
    const size_t smem = smem_bytes(d, tile);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          matching_mix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int64_t blocks = (p + tile - 1) / tile;
    matching_mix_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
        perms, survive, x_new, x_old, out, d, p, stages, tile);
    return cudaGetLastError();
  }
  const dim3 grid((unsigned)((p + kThreads - 1) / kThreads), (unsigned)d);
  if (stages <= 1) {
    matching_stage_kernel<T, true, T><<<grid, kThreads, 0, stream>>>(
        stages ? perms : nullptr, survive, x_new, x_old, nullptr, out, d, p);
    return cudaGetLastError();
  }
  float* buf[2] = {scratch, scratch + (size_t)d * p};
  matching_stage_kernel<T, true, float><<<grid, kThreads, 0, stream>>>(
      perms, survive, x_new, x_old, nullptr, buf[0], d, p);
  cudaError_t err = cudaGetLastError();
  for (int s = 1; s < stages && err == cudaSuccess; ++s) {
    const int32_t* perm = perms + (int64_t)s * d;
    if (s == stages - 1)
      matching_stage_kernel<T, false, T><<<grid, kThreads, 0, stream>>>(
          perm, nullptr, nullptr, nullptr, buf[(s - 1) & 1], out, d, p);
    else
      matching_stage_kernel<T, false, float><<<grid, kThreads, 0, stream>>>(
          perm, nullptr, nullptr, nullptr, buf[(s - 1) & 1], buf[s & 1], d, p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// How many [D, P] f32 scratch buffers the caller must pass for (d, stages):
// 0 on the shared-memory path, else min(stages - 1, 2) (one launch per
// stage through device memory).
int fed_mix_matching_scratch_buffers(int d, int stages) {
  if (tile_for(d) > 0 || stages < 2) return 0;
  return stages == 2 ? 1 : 2;
}

// perms [S, D] int32, survive [D] f32, x_new/x_old/out [D, P] contiguous
// (f32 when is_bf16 == 0, else bf16); scratch null or the buffers
// fed_mix_matching_scratch_buffers asks for, back to back. Launches on
// `stream` and returns cudaGetLastError().
int fed_mix_matching_launch(const void* perms, const void* survive, const void* x_new,
                            const void* x_old, void* out, void* scratch, int d,
                            long long p, int stages, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(
        (const int32_t*)perms, (const float*)survive, (const __nv_bfloat16*)x_new,
        (const __nv_bfloat16*)x_old, (__nv_bfloat16*)out, (float*)scratch, d, p, stages, s);
  return (int)launch<float>((const int32_t*)perms, (const float*)survive,
                            (const float*)x_new, (const float*)x_old, (float*)out,
                            (float*)scratch, d, p, stages, s);
}

}  // extern "C"
