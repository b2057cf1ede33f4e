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
// 3·D·P·4 ≈ 296 MB: 0.088 ms at 3.35 TB/s.
//
// What the design does about it: all the parallelism lies along P, and a
// stage mixes whole rows, so a block owns a tile of consecutive columns
// and holds all D rows of that tile in shared memory. Every operation is
// one IEEE rounding in the plain version's order (__fmul_rn / __fadd_rn,
// so nvcc cannot contract them into an FMA), which makes the kernel equal
// to the plain version bit for bit. Three routes, by S and D:
// 1. matching_tree_kernel (S <= 3, the gossip family's 1 and 2): no stage
//    loop and no barrier between stages. Stage s averages row r with row
//    perm_s[r], so the output of row i is a rounding tree over 2^S rows
//    of eff (i, perm_0[i], perm_1[i], perm_0[perm_1[i]] at S = 2), added
//    pairwise in the plain version's order: each intermediate value is
//    the same IEEE operation on the same operands, so the result is bit
//    for bit the stage loop's. Each block composes every row's leaves
//    once from the [S, D] perms (a row with a partner outside [0, D)
//    anywhere in its tree is NaN, as the stage loop makes it) and stages
//    the survive mask, both in shared memory. The block is persistent: it
//    walks column tiles of a compile-time width (256 bytes of a row at
//    D = 100) with x_new and x_old of tile t + 1 in flight by cp.async
//    (16-byte copies where the row allows, 8 where it is 8-byte aligned:
//    at P = 2 mod 4 every other f32 row is) while tile t is consumed. A
//    thread owns a (row, 16-byte column vector) pair with no division,
//    substitutes stragglers as it reads each leaf's vectors, and stores a
//    vector. Two blocks of 104 KB share an SM at D = 100.
// 2. matching_mix_kernel (S >= 4, or D too large for two tree buffers):
//    all D rows of a column tile in two ping-pong f32 buffers, the S
//    stages between __syncthreads().
// 3. When D rows of even a 32-column tile do not fit twice in shared
//    memory (D > ~900), one launch per stage through device memory:
//    stage 0 computes eff on the fly from x_new/x_old, the middle stages
//    ping-pong between two [D, P] f32 scratch buffers, and the last stage
//    writes out.
//
// A partner index outside [0, D) makes that output row NaN (jnp.take's
// fill mode); the CPU wrapper raises on it before any launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

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

// ---------------------------------------------------------------------------
// route 1: the rounding tree, S <= 3
// ---------------------------------------------------------------------------

constexpr int kTreeThreads = 256;
constexpr int kMaxTreeStages = 3;

// the 16-byte vector of VEC elements at src (16-byte aligned shared
// memory) as f32
__device__ __forceinline__ void load_vec(const float* src, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// the first n (<= VEC) of v to dst in T, 16 bytes at a time where dst
// allows, else 8, else one element at a time
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[4], int n) {
  const uintptr_t a = (uintptr_t)dst;
  if (n == 4 && (a & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (n == 4 && (a & 7) == 0) {
    reinterpret_cast<float2*>(dst)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(dst)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) dst[k] = v[k];
  }
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&v)[8], int n) {
  const uintptr_t a = (uintptr_t)dst;
  if (n == 8 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else if (n == 8 && (a & 7) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n) dst[k] = __float2bfloat16_rn(v[k]);
  }
}

// Bytes of shared memory the tree kernel takes: two buffers of the
// [D, W] x_new and x_old tiles, the leaves and the survive mask.
__host__ __device__ constexpr size_t tree_smem_bytes(int d, int stages, int tile_bytes) {
  return 4 * (size_t)d * tile_bytes + (size_t)d * ((1 << stages) + 1) * 4;
}

// Block: persistent over column tiles of W = WB / sizeof(T) elements.
// Shared: tiles[2 buffers][x_new, x_old][D][W] (T), leaf[D][2^S] (int,
// leaf[i][0] = -1 for a NaN row), sv[D] (f32).
template <typename T, int S, int WB>
__global__ void __launch_bounds__(kTreeThreads)
matching_tree_kernel(const int32_t* __restrict__ perms, const float* __restrict__ survive,
                     const T* __restrict__ x_new, const T* __restrict__ x_old,
                     T* __restrict__ out, int d, int64_t p, int64_t n_tiles) {
  constexpr int NL = 1 << S;               // leaves of an output's tree
  constexpr int W = WB / (int)sizeof(T);   // columns of a tile
  constexpr int VEC = 16 / (int)sizeof(T); // columns of a 16-byte vector
  constexpr int NV = W / VEC;              // vectors of a tile row
  constexpr int RPP = kTreeThreads / NV;   // rows a pass of the block covers
  extern __shared__ __align__(16) unsigned char tree_smem[];
  T* const tiles = reinterpret_cast<T*>(tree_smem);
  const size_t tile_elems = (size_t)d * W;
  int* const leaf = reinterpret_cast<int*>(tiles + 4 * tile_elems);
  float* const sv = reinterpret_cast<float*>(leaf + d * NL);
  const int tid = threadIdx.x;
  const int vec = tid % NV, row0 = tid / NV;  // NV a power of two: no division

  // x_new and x_old of column tile `tile` into buffer `buf`, cp.async
  auto issue = [&](int64_t tile, int buf) {
    T* dn = tiles + (size_t)(2 * buf) * tile_elems + vec * VEC;
    T* dold = dn + tile_elems;
    const int64_t c = tile * W + vec * VEC;
    const int nbytes = c < p ? (int)(p - c < VEC ? p - c : VEC) * (int)sizeof(T) : 0;
    for (int i = row0; i < d; i += RPP) {
      const int64_t g = nbytes ? (int64_t)i * p + c : 0;
      cp_async::chunk16(dn + i * W, x_new + g, nbytes);
      cp_async::chunk16(dold + i * W, x_old + g, nbytes);
    }
  };
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) issue(tile, 0);
  cp_async::commit();

  // each row's leaves: expand the tree from the last stage down, each
  // node r of stage s into (r, perm_s[r]); a partner outside [0, D)
  // anywhere makes the row NaN
  for (int i = tid; i < d; i += kTreeThreads) {
    int l[NL];
    l[0] = i;
    bool ok = true;
#pragma unroll
    for (int s = S - 1; s >= 0; --s) {
#pragma unroll
      for (int k = (1 << (S - 1 - s)) - 1; k >= 0; --k) {
        const int r = l[k];
        const int j = perms[(int64_t)s * d + r];
        const bool valid = (unsigned)j < (unsigned)d;
        ok = ok && valid;
        l[2 * k + 1] = valid ? j : r;
        l[2 * k] = r;
      }
    }
#pragma unroll
    for (int k = 0; k < NL; ++k) leaf[i * NL + k] = k == 0 && !ok ? -1 : l[k];
    sv[i] = survive[i];
  }

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) issue(next, (it + 1) & 1);
    cp_async::commit();
    cp_async::wait<1>();
    __syncthreads();  // tile `tile` staged by every thread (and the leaves written)
    const T* tn = tiles + (size_t)(2 * (it & 1)) * tile_elems + vec * VEC;
    const T* to = tn + tile_elems;
    const int64_t c = tile * W + vec * VEC;
    if (c < p) {
      const int n = p - c < VEC ? (int)(p - c) : VEC;
      for (int i = row0; i < d; i += RPP) {
        const int* li = leaf + i * NL;
        float node[NL][VEC];
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          const int r = k == 0 && li[0] < 0 ? i : li[k];
          float xn[VEC], xo[VEC];
          load_vec(tn + r * W, xn);
          load_vec(to + r * W, xo);
          const float s = sv[r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) node[k][e] = substitute(s, xn[e], xo[e]);
        }
        // stage 0 pairs leaves (2m, 2m + 1), stage 1 those pairs' results, ...
#pragma unroll
        for (int step = 1; step < NL; step *= 2)
#pragma unroll
          for (int k = 0; k < NL; k += 2 * step)
#pragma unroll
            for (int e = 0; e < VEC; ++e) node[k][e] = halve_sum(node[k][e], node[k + step][e]);
        if (li[0] < 0) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) node[0][e] = nan_f32();
        }
        store_vec(out + (int64_t)i * p + c, node[0], n);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
  cp_async::wait<0>();
}

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

// The tree kernel's tile row in bytes at (d, stages): the widest of 256,
// 128 and 64 with which two blocks share an SM, else the widest with
// which one block fits; 0 when none fits or stages > 3.
int tree_tile_bytes(int d, int stages) {
  if (stages > kMaxTreeStages) return 0;
  int dev = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const size_t two = (size_t)per_sm / 2 - 1024;  // 1 KB a block is the system's
  for (int wb = 256; wb >= 64; wb /= 2)
    if (tree_smem_bytes(d, stages, wb) <= two) return wb;
  for (int wb = 256; wb >= 64; wb /= 2)
    if (tree_smem_bytes(d, stages, wb) <= max_smem_per_block()) return wb;
  return 0;
}

template <typename T, int S, int WB>
cudaError_t launch_tree(const int32_t* perms, const float* survive, const T* x_new,
                        const T* x_old, T* out, int d, int64_t p, cudaStream_t stream) {
  constexpr int W = WB / (int)sizeof(T);
  const size_t smem = tree_smem_bytes(d, S, WB);
  auto kernel = matching_tree_kernel<T, S, WB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTreeThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (p + W - 1) / W;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(n_tiles < resident ? n_tiles : resident);
  kernel<<<blocks, kTreeThreads, smem, stream>>>(perms, survive, x_new, x_old, out, d, p,
                                                 n_tiles);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_tree_wb(int wb, const int32_t* perms, const float* survive,
                           const T* x_new, const T* x_old, T* out, int d, int64_t p,
                           cudaStream_t stream) {
  if (wb == 256) return launch_tree<T, S, 256>(perms, survive, x_new, x_old, out, d, p, stream);
  if (wb == 128) return launch_tree<T, S, 128>(perms, survive, x_new, x_old, out, d, p, stream);
  return launch_tree<T, S, 64>(perms, survive, x_new, x_old, out, d, p, stream);
}

template <typename T>
cudaError_t launch(const int32_t* perms, const float* survive, const T* x_new,
                   const T* x_old, T* out, float* scratch, int d, int64_t p, int stages,
                   cudaStream_t stream) {
  if (const int wb = tree_tile_bytes(d, stages)) {
    switch (stages) {
      case 0: return launch_tree_wb<T, 0>(wb, perms, survive, x_new, x_old, out, d, p, stream);
      case 1: return launch_tree_wb<T, 1>(wb, perms, survive, x_new, x_old, out, d, p, stream);
      case 2: return launch_tree_wb<T, 2>(wb, perms, survive, x_new, x_old, out, d, p, stream);
      default: return launch_tree_wb<T, 3>(wb, perms, survive, x_new, x_old, out, d, p, stream);
    }
  }
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
// 0 on the shared-memory routes, else min(stages - 1, 2) (one launch per
// stage through device memory). (Where even the stage loop's tile does
// not fit, the tree's does not either.)
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
