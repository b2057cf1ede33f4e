// flash_attention_bwd — the backward of flash_attention.cu, hand-written for
// Hopper (sm_90a).
//
// Given the forward's q [B, Hq, Sq, hd], k/v [B, Hkv, T, hd], its output o,
// the row log-sum-exp lse [B, Hq, Sq] (f32, in units of the scaled scores,
// written by the forward when a gradient is needed) and dO like o, it writes
// dq like q and dk, dv like k and v:
//
//   P = exp(scale·Q·Kᵀ - lse) on the visible keys (0 elsewhere),
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP - delta),  delta = rowsum(dO ∘ O),
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q,
//
// summed over the G query heads of each kv head (GQA). The visible keys are
// the forward's: j <= i, and, when window > 0, i - j < window or j <
// num_meta. Every operand is read through its (batch, head, row) strides;
// the head_dim stride is 1.
//
// Replaces: no Pallas kernel. The JAX package computes this gradient in jnp:
// the custom VJP _flash_vjp_bwd (src/repro/models/attention.py:138) at >=
// 4096 query rows, autodiff of _direct_attention (:50) below that. This
// kernel follows the VJP's FlashAttention-2 scheme.
//
// What bounds it on the card: operations. Seven products of 2·hd flops per
// visible (query, key) pair and query head (S and dP in each of the two
// passes below, then dV, dK and dQ), against five for the function itself.
//
// What the design does about it (a first, simple version on the CUDA
// cores' FFMA; a tensor-core version is later work):
// - flash_bwd_delta_kernel: delta = rowsum(dO ∘ O), one warp per row.
// - flash_bwd_dkdv_kernel, one block per (64-key tile, kv head, batch): K
//   and V stay in shared memory; the block walks the G query heads of its
//   group and, for each, the 64-row query tiles that see a key of its tile
//   (the tiles the forward visits: from the diagonal on, and with a window
//   only those within it unless the tile holds a meta token). Per query
//   tile it recomputes Sᵀ and dPᵀ (a 4 x 4 patch a thread), P from lse, dS,
//   and adds Pᵀ·dO and dSᵀ·Q into dV and dK, which stay in registers across
//   the whole walk: no atomics, a fixed order, the same bits every run.
// - flash_bwd_dq_kernel, one block per (64-row query tile, query head,
//   batch): the forward's walk over the visible key tiles, recomputing S,
//   P, dP and dS, and adding dS·K into dQ in registers.
// - Shared tiles are f32 [row][column] with a pitch of hd + 1 (and 65 for
//   the 64 x 64 P and dS), so that a warp's reads of a column are on
//   distinct banks and its reads of a row are consecutive. bf16 operands are
//   widened to f32 as they are staged; the results are rounded to the
//   operands' dtype once, at the store.
// - The arithmetic is f32 throughout, with expf. Head dims up to 128 (32, 64
//   or 128 columns, zero-padded); the wrapper raises above 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 patch
constexpr int kPT = kT + 1;     // pitch of the 64 x 64 P and dS tiles

// element strides of one [B, H, S, hd] operand (the hd stride is 1)
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ bool visible(int i, int j, int n_k, int window, int num_meta) {
  return j < n_k && j <= i && (window <= 0 || i - j < window || j < num_meta);
}

// rows row0 .. row0 + 63 (of n) of one head into dst[64][HD + 1] as f32,
// zero past n and past hd
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* base, long long stride, int row0,
                                      int n, int hd) {
  for (int e = threadIdx.x; e < kT * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + c] = (row < n && c < hd) ? to_f32(base[(long long)row * stride + c]) : 0.f;
  }
}

// delta[b][h][i] = Σ_d dO[b, h, i, d] · O[b, h, i, d]; a warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, Strides so,
                       Strides sdo, float* __restrict__ delta, int hq, int n_q, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kThreads / 32) + warp, h = blockIdx.y, b = blockIdx.z;
  if (i >= n_q) return;
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + i * sdo.s;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[((long long)b * hq + h) * n_q + i] = s;
}

// shared memory of both passes: four [64][HD + 1] tiles, P and dS, lse and delta
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kT * (HD + 1) + 2 * kT * kPT + 2 * kT);
}

// dK and dV of one 64-key tile of kv head hk
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      int hq, int group, int n_q, int n_k, int hd, float scale, int window,
                      int num_meta) {
  constexpr int PH = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [key][d]
  float* Vs = Ks + kT * PH;      // [key][d]
  float* Qs = Vs + kT * PH;      // [query][d]
  float* dOs = Qs + kT * PH;     // [query][d]
  float* Ps = dOs + kT * PH;     // [key][query]: Pᵀ
  float* dSs = Ps + kT * kPT;    // [key][query]: dSᵀ
  float* lse_s = dSs + kT * kPT;
  float* del_s = lse_s + kT;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kT;
  stage<T, HD>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, n_k, hd);
  stage<T, HD>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, n_k, hd);

  float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  // the query tiles that see a key of this tile: from the diagonal on; with
  // a window and no meta token in the tile, those within window - 1 rows of
  // its last key
  const int n_qt = (n_q + kT - 1) / kT;
  const int qt_first = k0 / kT;
  int qt_last = n_qt - 1;
  if (window > 0 && k0 >= num_meta) qt_last = min(qt_last, (k0 + kT - 1 + window - 1) / kT);

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long row_base = ((long long)b * hq + h) * n_q;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      stage<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, n_q, hd);
      stage<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, n_q, hd);
      if (threadIdx.x < kT) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < n_q ? lse[row_base + i] : 0.f;
        del_s[threadIdx.x] = i < n_q ? delta[row_base + i] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: keys ty + 16r, queries tx + 16c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kr[4], vr[4], qc[4], oc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kr[r] = Ks[(ty + 16 * r) * PH + d];
          vr[r] = Vs[(ty + 16 * r) * PH + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qc[c] = Qs[(tx + 16 * c) * PH + d];
          oc[c] = dOs[(tx + 16 * c) * PH + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(kr[r], qc[c], s[r][c]);
            dp[r][c] = fmaf(vr[r], oc[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = k0 + ty + 16 * r, i = q0 + tx + 16 * c;
          float p = 0.f;
          if (i < n_q && visible(i, j, n_k, window, num_meta))
            p = expf(s[r][c] * scale - lse_s[tx + 16 * c]);
          Ps[(ty + 16 * r) * kPT + tx + 16 * c] = p;
          dSs[(ty + 16 * r) * kPT + tx + 16 * c] = p * (dp[r][c] - del_s[tx + 16 * c]);
        }
      __syncthreads();

      // dV += Pᵀ·dO, dK += dSᵀ·Q: keys ty + 16r, columns tx + 16c
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        float pr[4], dsr[4], oc[NC], qc[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = Ps[(ty + 16 * r) * kPT + i];
          dsr[r] = dSs[(ty + 16 * r) * kPT + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          oc[c] = dOs[i * PH + tx + 16 * c];
          qc[c] = Qs[i * PH + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_dv[r][c] = fmaf(pr[r], oc[c], acc_dv[r][c]);
            acc_dk[r][c] = fmaf(dsr[r], qc[c], acc_dk[r][c]);
          }
      }
    }
  }

  T* dkb = dk + b * sdk.b + hk * sdk.h;
  T* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= n_k) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        store(dkb + (long long)j * sdk.s + d, acc_dk[r][c] * scale);
        store(dvb + (long long)j * sdv.s + d, acc_dv[r][c]);
      }
    }
  }
}

// dQ of one 64-row query tile of query head h
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, int hq, int group, int n_q, int n_k,
                    int hd, float scale, int window, int num_meta) {
  constexpr int PH = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [query][d]
  float* dOs = Qs + kT * PH;     // [query][d]
  float* Ks = dOs + kT * PH;     // [key][d]
  float* Vs = Ks + kT * PH;      // [key][d]
  float* dSs = Vs + kT * PH;     // [query][key]
  float* lse_s = dSs + 2 * kT * kPT;
  float* del_s = lse_s + kT;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kT;
  const long long row_base = ((long long)b * hq + h) * n_q;
  stage<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, n_q, hd);
  stage<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, n_q, hd);
  if (threadIdx.x < kT) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < n_q ? lse[row_base + i] : 0.f;
    del_s[threadIdx.x] = i < n_q ? delta[row_base + i] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  // the forward's walk: key tiles up to the diagonal, skipping those wholly
  // outside the window that hold no meta token
  const int q_last = min(q0 + kT, n_q) - 1;
  const int kt_last = min((n_k - 1) / kT, q_last / kT);
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kT;
    if (window > 0 && k0 >= num_meta && q0 - (k0 + kT - 1) >= window) continue;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    stage<T, HD>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, n_k, hd);
    stage<T, HD>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, n_k, hd);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ: queries ty + 16r, keys tx + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[4], orr[4], kc[4], vc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qr[r] = Qs[(ty + 16 * r) * PH + d];
        orr[r] = dOs[(ty + 16 * r) * PH + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = Ks[(tx + 16 * c) * PH + d];
        vc[c] = Vs[(tx + 16 * c) * PH + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orr[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + ty + 16 * r, j = k0 + tx + 16 * c;
        float p = 0.f;
        if (i < n_q && visible(i, j, n_k, window, num_meta))
          p = expf(s[r][c] * scale - lse_s[ty + 16 * r]);
        dSs[(ty + 16 * r) * kPT + tx + 16 * c] = p * (dp[r][c] - del_s[ty + 16 * r]);
      }
    __syncthreads();

    // dQ += dS·K: queries ty + 16r, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float dsr[4], kc[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsr[r] = dSs[(ty + 16 * r) * kPT + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = Ks[j * PH + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsr[r], kc[c], acc[r][c]);
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= n_q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) store(dqb + (long long)i * sdq.s + d, acc[r][c] * scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, const Strides* st, int batch, int hq, int group, int n_q,
                   int n_k, int hd, float scale, int window, int num_meta,
                   cudaStream_t stream) {
  const Strides &sq = st[0], &sk = st[1], &sv = st[2], &so = st[3], &sdo = st[4], &sdq = st[5],
                &sdk = st[6], &sdv = st[7];
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  constexpr int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<T><<<dim3((n_q + rows_per_block - 1) / rows_per_block, hq, batch),
                              kThreads, 0, stream>>>((const T*)o, (const T*)dout, so, sdo, delta,
                                                     hq, n_q, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((n_k + kT - 1) / kT, hq / group, batch), kThreads, bytes,
                                 stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, sq, sk,
      sv, sdo, sdk, sdv, hq, group, n_q, n_k, hd, scale, window, num_meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<dim3((n_q + kT - 1) / kT, hq, batch), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, sq, sk, sv, sdo,
      sdq, hq, group, n_q, n_k, hd, scale, window, num_meta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, void* dk, void* dv,
                      float* delta, const Strides* st, int batch, int hq, int group, int n_q,
                      int n_k, int hd, float scale, int window, int num_meta,
                      cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, hq, group, n_q,
                         n_k, hd, scale, window, num_meta, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, hq, group, n_q,
                         n_k, hd, scale, window, num_meta, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, hq, group, n_q,
                          n_k, hd, scale, window, num_meta, stream);
  return cudaErrorInvalidValue;  // the wrapper raises before
}

}  // namespace

extern "C" {

// q [batch, hq, n_q, hd], k/v [batch, hq/group, n_k, hd], o and dout like q,
// dq like q, dk/dv like k; each given by its (batch, head, row) element
// strides, the hd stride 1; f32 when is_bf16 == 0, else bf16; hd <= 128,
// n_q <= n_k. lse [batch, hq, n_q] f32 from the forward; delta a workspace
// of batch x hq x n_q floats. Three launches on `stream` (delta, dK and dV,
// dQ); returns the first failure of cudaGetLastError().
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, void* dq, void* dk,
                               void* dv, float* delta,
                               const long long* strides,  // 24: q, k, v, o, dout, dq, dk, dv x (b, h, s)
                               int batch, int hq, int group, int n_q, int n_k, int hd,
                               float scale, int window, int num_meta, int is_bf16,
                               void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch,
                                         hq, group, n_q, n_k, hd, scale, window, num_meta, s);
  return (int)launch_hd<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, hq, group,
                               n_q, n_k, hd, scale, window, num_meta, s);
}

}  // extern "C"
