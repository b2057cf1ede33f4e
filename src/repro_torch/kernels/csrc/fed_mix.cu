// fed_mix — the dense mixing kernel, hand-written for Hopper (sm_90a).
//
//   out = M_new @ X_new + M_old @ X_old
//
// with M_new/M_old the [D, D] f32 client-mixing matrices and X_new/X_old
// the packed [D, P] client buffers (f32 or bf16), accumulated in f32 and
// stored in X_new's dtype.
//
// Replaces: src/repro/kernels/fed_mix.py · fed_mix (Pallas
// _fed_mix_kernel: two MXU contractions per K step into an f32 VMEM
// accumulator, f32 throughout via preferred_element_type).
//
// What bounds it on the card: bytes. It is one [D, 2D] @ [2D, P] product,
// 4·D²·P flops; at the main path's shape (D = 100, P = 246,590) that is
// ≈ 9.9 GFLOP on ≈ 296 MB (X_new and X_old read, out written once). The
// products run on the TF32 tensor cores as split-f32 (tf32x3.cuh: three
// TF32 products per f32 product, two for a bf16 X): 3 x 9.9 GFLOP at
// 495 TFLOP/s is 0.060 ms, below the 0.088 ms the bytes take at 3.35 TB/s.
// (At the CUDA cores' 67 TFLOP/s the flops took 0.147 ms, longer than the
// bytes.)
//
// What the design does about it:
// - Persistent blocks, one per SM for each row block, 16 warps each: a
//   block walks 256-column tiles of P (blockIdx.x, + gridDim.x, ...).
// - [M_new | M_old] lives in shared memory, loaded once per block at
//   D <= 100 (padded to whole m16 tiles: 112 rows at D = 100; beside the
//   ring it takes the rest of the 227 KB) instead of every column tile
//   gathering it from L2 again. Larger D cuts K into chunks reloaded per
//   column tile, and D > 128 into row blocks (grid.y).
// - The 16 warps stand as 2 x 8: warp row wr owns m16 tiles wr, wr + 2,
//   ... (4 and 3 of the 7 at D = 100), warp column wc 32 columns (four n8
//   tiles). The four warps that share an SM quarter (w, w + 4, w + 8,
//   w + 12) hold two of each warp row, so an odd tile count loads the four
//   tensor cores evenly. The kernel is instantiated per tile count, so
//   each warp row runs straight-line products. A warp splits its B
//   fragments once per k8 step and each A fragment as it reads it (every
//   X element is split by two warps, every M element by eight), and
//   issues the three terms term by term over its accumulators.
// - X streams once through a 3-stage cp.async ring of [40, 256] tiles of
//   [X_new ; X_old], read in place; 40 rows make K = 200 (D = 100) five
//   whole stages with five k8 steps between barriers. The ring runs on
//   across column tiles, so the next tile's loads overlap this one's
//   products and epilogue. Each 16-byte chunk takes the widest copy its
//   source address allows (cp_async.cuh): with P = 2 mod 4 every other f32
//   row is only 8-byte aligned, and a bf16 row may be 2-byte aligned.
//   Ragged D, K and P edges load zeros and are masked on store. The stage
//   pitches (264 f32 / 272 bf16) keep the B-fragment reads (k = t, n = g)
//   on 32 distinct banks; M's pitch (4 mod 16 words) does the same for A.
// - The accumulators are stored straight from the C fragments, two
//   adjacent columns a store where the row is aligned for it.
// - Non-finite values: the products run on the fast split (three integer
//   and f32 operations, tf32x3.cuh), which turns an inf, a NaN or a value
//   at the f32 maximum into an inf or NaN result, never a finite one. Each
//   warp checks its tile's accumulators before the store and writes a flag
//   for it; a second launch (dense_mix_kernel_redo) takes every flagged
//   warp's part of its tile again from device memory on the full split,
//   whose products follow IEEE (w·inf = inf, 0·inf = NaN) as the plain
//   version's do. A finite mix reads the flags and exits (~4.5 us).
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
constexpr int BN = kWarpCols * NW * 8;    // output columns per tile
constexpr int BK = 40;                    // K rows of X per ring stage
constexpr int kStages = 3;                // ring depth
constexpr int kMaxMT = 8;                 // m16 tiles per row block (128 rows)
constexpr int kStageBytes = BK * (BN + 8) * 4;

// shared pitch, in elements, of a stage row: BN + 8 f32 (8 mod 32 banks),
// BN + 16 bf16 (8 mod 32 words)
template <typename T> __host__ __device__ constexpr int x_pitch() {
  return sizeof(T) == 4 ? BN + 8 : BN + 16;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// B fragment element of a stage as a TF32 hi/lo pair, on the fast split
// (a bf16 is exact: its value in both slots, tf32x3.cuh)
__device__ __forceinline__ void b_elem(const float* xs, int idx, uint32_t& hi, uint32_t& lo) {
  tf32x3::split_fast(xs[idx], hi, lo);
}
__device__ __forceinline__ void b_elem(const __nv_bfloat16* xs, int idx, uint32_t& hi,
                                       uint32_t& lo) {
  hi = lo = tf32x3::bf16_bits(reinterpret_cast<const uint16_t*>(xs)[idx]);
}

// acc += M[:, kl0 : kl0 + BK] · (one stage of X) for the warp's NJ m16
// tiles (wr, wr + 2, ...) and its NW n8 tiles. B fragments are split once
// and held; each A fragment is split as it is read and used on all NW n8
// tiles, the three terms issued term by term over those accumulators
// (lo·hi, hi·lo for an f32 X, hi·hi), on the fast split.
template <int NJ, typename T>
__device__ __forceinline__ void stage_products(float (&acc)[4][NW][4], const float* Ms, int kp,
                                               const T* xs, int kl0, int wr, int n0, int g,
                                               int t) {
  constexpr bool kExactB = sizeof(T) == 2;  // bf16 X: lo = 0, two products
  constexpr int XPT = x_pitch<T>();
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const int n = n0 + nt * 8 + g;
      b_elem(xs, (ks * 8 + t) * XPT + n, bh[nt][0], bl[nt][0]);
      b_elem(xs, (ks * 8 + t + 4) * XPT + n, bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* a = Ms + ((wr + 2 * j) * 16 + g) * kp + kl0 + ks * 8 + t;
      uint32_t ah[4], al[4];
      tf32x3::split_fast(a[0], ah[0], al[0]);
      tf32x3::split_fast(a[8 * kp], ah[1], al[1]);
      tf32x3::split_fast(a[4], ah[2], al[2]);
      tf32x3::split_fast(a[8 * kp + 4], ah[3], al[3]);
      tf32x3::mma_split<NW, false, kExactB>(acc[j], ah, al, bh, bl);
    }
  }
}

// The warp's outputs of one column tile (m16 tiles wr, wr + 2, ... of the
// row block; columns c0 .. c0 + 31) taken again from device memory with
// the full split, and stored: for a tile whose fast-split result held an
// inf or a NaN (tf32x3.cuh). Rare, so plain: no staging.
template <typename T>
__device__ __forceinline__ void tile_full(const float* m_new, const float* m_old, const T* x_new,
                                       const T* x_old, T* out, int d, long long p, int row0,
                                       int wr, int nj, long long c0, int g, int t) {
  constexpr bool kExactB = sizeof(T) == 2;
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
          if (k < k_total && c < p)
            v = to_f32(k < d ? x_new[(long long)k * p + c] : x_old[(long long)(k - d) * p + c]);
          if constexpr (kExactB)
            tf32x3::exact(__float_as_uint(v), bh[nt][h], bl[nt][h]);
          else
            tf32x3::split(v, bh[nt][h], bl[nt][h]);
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
      tf32x3::mma_split<NW, false, kExactB>(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + 8 * half;
      if (i >= d) continue;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const long long c = c0 + nt * 8 + 2 * t;
        if (c < p)
          store2<T>(out + (long long)i * p + c, acc[nt][2 * half], acc[nt][2 * half + 1],
                    c + 1 < p);
      }
    }
  }
}

// MT: m16 tiles in a row block (warp row 0 takes (MT + 1) / 2 of them,
// warp row 1 MT / 2)
template <int MT, typename T>
__global__ void __launch_bounds__(kThreads, 1)
dense_mix_kernel(const float* __restrict__ m_new, const float* __restrict__ m_old,
                 const T* __restrict__ x_new, const T* __restrict__ x_old,
                 T* __restrict__ out, unsigned char* __restrict__ redo, int d, long long p,
                 int kc, int n_col_tiles) {
  constexpr int RM = MT * 16;
  constexpr int XPT = x_pitch<T>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = BN / EPC;             // chunks per stage row
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (tid >> 5) / kWarpCols;    // its m16 tiles: wr, wr + 2, ...
  const int nj = wr == 0 ? (MT + 1) / 2 : MT / 2;
  const int n0 = (tid >> 5) % kWarpCols * NW * 8;  // its first column in a tile
  const int row0 = blockIdx.y * RM;
  const int kp = kc + 4;                    // M pitch: 4 mod 16 words
  const int k_total = 2 * d;
  const int nkt = (k_total + BK - 1) / BK;  // K tiles per column tile
  const int ktpc = kc / BK;                 // K tiles per M chunk
  const int nkc = (nkt + ktpc - 1) / ktpc;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int nmine = bx < n_col_tiles ? (n_col_tiles - bx + gx - 1) / gx : 0;
  const int nitems = nmine * nkt;           // (column tile, K tile) pairs

  float* Ms = reinterpret_cast<float*>(smem);                 // [RM][kp]
  unsigned char* ring = smem + (size_t)RM * kp * sizeof(float);

  // [M_new | M_old] rows row0.., columns kc0..kc0+kc; zeros outside. Eight
  // loads are issued before their stores, so their latencies overlap.
  auto load_m = [&](int chunk) {
    const int kc0 = chunk * kc, n = RM * kc;
    for (int e0 = tid; e0 < n; e0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / kc, k = kc0 + e - r * kc, i = row0 + r;
        v[u] = 0.f;
        if (e < n && i < d && k < k_total)
          v[u] = k < d ? m_new[(long long)i * d + k] : m_old[(long long)i * d + (k - d)];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / kc;
        if (e < n) Ms[r * kp + (e - r * kc)] = v[u];
      }
    }
  };

  // stage the [BK, BN] tile of [X_new ; X_old] of item w, a warp per row;
  // K padding rows and columns past P load zeros
  auto load_item = [&](int w) {
    const int j = w / nkt, kt = w - j * nkt;
    const long long col0 = (long long)(bx + j * gx) * BN;
    T* st = reinterpret_cast<T*>(ring + (w % kStages) * kStageBytes);
    for (int r = tid >> 5; r < BK; r += kWarps) {
      const int gk = kt * BK + r;
      const T* row = gk < d ? x_new + (long long)gk * p : x_old + (long long)(gk - d) * p;
      for (int c = lane; c < CPR; c += 32) {
        const long long gc = col0 + (long long)c * EPC;
        const int nbytes =
            gk < k_total && gc < p ? (int)min((long long)EPC, p - gc) * (int)sizeof(T) : 0;
        cp_async::chunk16(st + r * XPT + c * EPC, nbytes ? row + gc : x_new, nbytes);
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
  if (nkc == 1) load_m(0);  // once for all column tiles, while X streams in

  for (int w = 0; w < nitems; ++w) {
    cp_async::wait<kStages - 2>();
    __syncthreads();  // item w staged; every warp is done with item w - 1
    if (w + kStages - 1 < nitems) load_item(w + kStages - 1);
    cp_async::commit();
    const int kt = w % nkt;
    const int chunk = kt / ktpc;
    if (nkc > 1 && kt == chunk * ktpc) {
      load_m(chunk);
      __syncthreads();
    }
    {
      const T* xs = reinterpret_cast<const T*>(ring + (w % kStages) * kStageBytes);
      const int kl0 = (kt - chunk * ktpc) * BK;
      if (wr == 0)
        stage_products<(MT + 1) / 2>(acc, Ms, kp, xs, kl0, wr, n0, g, t);
      else
        stage_products<MT / 2>(acc, Ms, kp, xs, kl0, wr, n0, g, t);
    }

    if (kt == nkt - 1) {  // the column tile is done: store and restart
      const long long col0 = (long long)(bx + (w / nkt) * gx) * BN + n0;
      bool bad = false;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) bad |= !tf32x3::finite(acc[j][nt][c]);
      // an inf or NaN: the warp's part of the tile is taken again on the
      // full split (dense_mix_kernel_redo); every warp writes its flag
      const bool any_bad = __any_sync(0xffffffffu, bad);
      if (lane == 0)
        redo[((size_t)blockIdx.y * n_col_tiles + bx + (w / nkt) * gx) * kWarps + (tid >> 5)] =
            any_bad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = row0 + (wr + 2 * j) * 16 + g + 8 * half;
          if (i >= d) continue;
          T* orow = out + (long long)i * p;
#pragma unroll
          for (int nt = 0; nt < NW; ++nt) {
            const long long c = col0 + nt * 8 + 2 * t;
            if (c < p)
              store2<T>(orow + c, acc[j][nt][2 * half], acc[j][nt][2 * half + 1], c + 1 < p);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][nt][c] = 0.f;
      }
    }
  }
  cp_async::wait<0>();
}

// The redo pass, launched after every dense_mix_kernel on the same grid:
// a warp whose flag its dense_mix_kernel warp set takes its part of the
// column tile again on the full split (tile_full); a call whose result
// held no inf or NaN reads its flags and exits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_mix_kernel_redo(const float* __restrict__ m_new, const float* __restrict__ m_old,
                      const T* __restrict__ x_new, const T* __restrict__ x_old,
                      T* __restrict__ out, const unsigned char* __restrict__ redo, int d,
                      long long p, int mt, int n_col_tiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / kWarpCols;
  const int nj = wr == 0 ? (mt + 1) / 2 : mt / 2;
  const int n0 = warp % kWarpCols * NW * 8;
  for (int tile = blockIdx.x; tile < n_col_tiles; tile += gridDim.x)
    if (redo[((size_t)blockIdx.y * n_col_tiles + tile) * kWarps + warp])
      tile_full<T>(m_new, m_old, x_new, x_old, out, d, p, blockIdx.y * mt * 16, wr, nj,
                   (long long)tile * BN + n0, lane >> 2, lane & 3);
}

template <int MT, typename T>
cudaError_t launch_mt(const void* m_new, const void* m_old, const void* x_new,
                      const void* x_old, void* out, void* redo, int d, long long p, int kc,
                      dim3 grid, size_t bytes, int n_col_tiles, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dense_mix_kernel<MT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dense_mix_kernel<MT, T><<<grid, kThreads, bytes, stream>>>(
      (const float*)m_new, (const float*)m_old, (const T*)x_new, (const T*)x_old, (T*)out,
      (unsigned char*)redo, d, p, kc, n_col_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_mix_kernel_redo<T><<<grid, kThreads, 0, stream>>>(
      (const float*)m_new, (const float*)m_old, (const T*)x_new, (const T*)x_old, (T*)out,
      (const unsigned char*)redo, d, p, MT, n_col_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* m_new, const void* m_old, const void* x_new,
                   const void* x_old, void* out, void* redo, int d, long long p,
                   cudaStream_t stream) {
  int dev = 0, nsm = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int mt_total = (d + 15) / 16;
  const int nrb = (mt_total + kMaxMT - 1) / kMaxMT;  // row blocks
  const int mt = (mt_total + nrb - 1) / nrb;         // m16 tiles per row block
  const int ring = kStages * kStageBytes;
  const int nkt = (2 * d + BK - 1) / BK;
  // the widest M chunk that fits beside the ring, then chunks of equal size
  const int kc_max = ((smem_max - ring) / (16 * mt * 4) - 4) / BK * BK;
  if (kc_max < BK) return cudaErrorInvalidConfiguration;
  const int nkc = (nkt * BK + kc_max - 1) / kc_max;
  const int kc = (nkt + nkc - 1) / nkc * BK;
  const size_t bytes = (size_t)16 * mt * (kc + 4) * sizeof(float) + ring;
  const long long ncol = (p + BN - 1) / BN;
  long long gx = nsm / nrb;
  gx = gx < 1 ? 1 : (gx > ncol ? ncol : gx);
  const dim3 grid((unsigned)gx, (unsigned)nrb);
  const int nc = (int)ncol;
#define FED_MIX_MT(N) \
  case N:             \
    return launch_mt<N, T>(m_new, m_old, x_new, x_old, out, redo, d, p, kc, grid, bytes, nc, \
                           stream);
  switch (mt) {
    FED_MIX_MT(1)
    FED_MIX_MT(2)
    FED_MIX_MT(3)
    FED_MIX_MT(4)
    FED_MIX_MT(5)
    FED_MIX_MT(6)
    FED_MIX_MT(7)
    default:
      return launch_mt<8, T>(m_new, m_old, x_new, x_old, out, redo, d, p, kc, grid, bytes, nc,
                             stream);
  }
#undef FED_MIX_MT
}

}  // namespace

extern "C" {

// Bytes of the redo flags fed_mix_launch needs at (D, P): one per warp of
// every (row block, column tile).
long long fed_mix_redo_bytes(int d, long long p) {
  const int mt_total = (d + 15) / 16;
  return (long long)((mt_total + kMaxMT - 1) / kMaxMT) * ((p + BN - 1) / BN) * kWarps;
}

// m_new/m_old [D, D] f32, x_new/x_old/out [D, P] contiguous (f32 when
// is_bf16 == 0, else bf16), redo: fed_mix_redo_bytes(d, p) bytes of
// scratch. Two launches on `stream` (the product, the redo pass); returns
// the first failure of cudaGetLastError().
int fed_mix_launch(const void* m_new, const void* m_old, const void* x_new,
                   const void* x_old, void* out, void* redo, int d, long long p, int is_bf16,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(m_new, m_old, x_new, x_old, out, redo, d, p, s);
  return (int)launch<float>(m_new, m_old, x_new, x_old, out, redo, d, p, s);
}

}  // extern "C"
