// flash_attention — causal online-softmax attention forward, hand-written
// for Hopper (sm_90a).
//
//   o[b, h, i] = Σ_j softmax_j(q[b, h, i] · k[b, h/G, j] / √hd) v[b, h/G, j]
//
// over the keys j a query i sees: j <= i, and, when window > 0, i - j <
// window or j < num_meta (the pinned meta tokens of models/attention.py
// mask_block). GQA: query head h reads kv head h / G. q [B, Hq, Sq, hd],
// k/v [B, Hkv, T, hd], f32 or bf16, read and written through their strides
// (only the head_dim stride must be 1), so the model's [B, S, H, hd]
// projections are read in place; f32 scores, running max, sum and
// accumulator; the output in q's dtype.
//
// Replaces: src/repro/kernels/flash_attention.py · flash_attention (Pallas
// _flash_kernel: grid (B, Hq, Sq/bq, Tk/bk), the kv axis sequential, the
// running (m, l, acc) in VMEM scratch). With num_meta = 0 it is that
// kernel's contract; num_meta > 0 adds the meta-token term.
//
// What bounds it on the card: operations. At Hymba's prefill (B 4, Hq 25,
// S 2048, hd 64, window 1024, 128 meta tokens) the visible part of the
// score matrix needs 4·hd flops per visible (i, j) pair, about 43 GFLOP per
// call over 126 MB of q, k, v and o; f32 without tensor cores (full f32,
// as the reference) makes the CUDA cores' f32 rate the ceiling.
//
// What the design does about it: one block of 128 threads per (b, h,
// 64-row query tile), the tiles with the most keys launched first. Q is
// staged once, transposed, in shared memory; the block walks 64-row K/V
// tiles (K transposed, V row-major, widened to f32 on load), skipping the
// tiles above the diagonal and those wholly outside the window that hold
// no meta token. Each thread owns 4 query rows x 8 keys of the score tile
// (one 16-byte Q and two 16-byte K reads feed 32 FMAs) and 4 rows x hd/8
// columns of the output. The row max and sum are reduced over the 8
// threads of a row group with warp shuffles; P goes through shared memory
// into the P·V product. Masked scores are the finite -1e30 of the TPU
// kernel, never -inf: a row's first visited tile may be fully masked, and
// the running state washes it out when a visible key arrives. A ragged
// last query tile is masked and writes no padded row. What it leaves on
// the table: no tensor cores, no asynchronous staging (each tile's loads
// are waited for), bank conflicts on the transposed stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key / value rows per tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 column groups
constexpr int kPad = 4;        // keeps 16-byte alignment of padded rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element strides of one [B, H, S, hd] operand (the hd stride is 1)
struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr int smem_floats() {
  return HD * (kBQ + kPad) + HD * (kBK + kPad) + kBK * (HD + kPad) + kBK * (kBQ + kPad);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
                 int group, int n_q, int n_k, int hd, float scale, int window,
                 int num_meta) {
  constexpr int LDQ = kBQ + kPad;  // QsT[d][row], PsT[key][row]
  constexpr int LDK = kBK + kPad;  // KsT[d][key]
  constexpr int LDV = HD + kPad;   // Vs[key][d]
  constexpr int CV = HD / 32;      // 16-byte column runs of V per thread
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;
  float* KsT = QsT + HD * LDQ;
  float* Vs = KsT + HD * LDK;
  float* PsT = Vs + kBK * LDV;

  const int n_qt = (n_q + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;                         // column group
  const int r0 = ((tid >> 5) * 4 + (lane >> 3)) * 4;  // first of 4 rows
  const int c0 = cg * 8;                           // first of 8 keys

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int qi = q0 + r;
    QsT[d * LDQ + r] = (qi < n_q && d < hd) ? to_f32(qb[qi * sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CV; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, n_q) - 1;
  const int kt_last = min((n_k - 1) / kBK, q_last / kBK);
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    // no row of this tile sees any key of it: outside the window, no meta
    if (window > 0 && k0 >= num_meta && q0 - (k0 + kBK - 1) >= window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int kj = k0 + c;
      const bool in = kj < n_k && d < hd;
      KsT[d * LDK + c] = in ? to_f32(kb[kj * sk.s + d]) : 0.f;
      Vs[c * LDV + d] = in ? to_f32(vb[kj * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&QsT[d * LDQ + r0]);
      const float4 ka = *reinterpret_cast<const float4*>(&KsT[d * LDK + c0]);
      const float4 kc = *reinterpret_cast<const float4*>(&KsT[d * LDK + c0 + 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // mask, then the online softmax of each row over its 8 column groups
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + c0 + j;
        const bool vis = kj < n_k && kj <= qi &&
                         (window <= 0 || qi - kj < window || kj < num_meta);
        s[i][j] = vis ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CV; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&PsT[(c0 + j) * LDQ + r0]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V: rows r0..r0+3, columns g*32 + cg*4 + 0..3
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&PsT[c * LDQ + r0]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < CV; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * LDV + g * 32 + cg * 4]);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][g * 4 + t] = fmaf(pr[i], vr[t], acc[i][g * 4 + t]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= n_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CV; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = g * 32 + cg * 4 + t;
        if (d < hd) ob[qi * so.s + d] = from_f32<T>(acc[i][g * 4 + t] / denom);
      }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides sq,
                   Strides sk, Strides sv, Strides so, int batch, int hq, int group,
                   int n_q, int n_k, int hd, float scale, int window, int num_meta,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBQ - 1) / kBQ, hq, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, group, n_q, n_k, hd,
      scale, window, num_meta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, Strides sq,
                      Strides sk, Strides sv, Strides so, int batch, int hq, int group,
                      int n_q, int n_k, int hd, float scale, int window, int num_meta,
                      cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, sq, sk, sv, so, batch, hq, group, n_q, n_k, hd, scale,
                         window, num_meta, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, sq, sk, sv, so, batch, hq, group, n_q, n_k, hd, scale,
                         window, num_meta, stream);
  return launch<T, 128>(q, k, v, o, sq, sk, sv, so, batch, hq, group, n_q, n_k, hd, scale,
                        window, num_meta, stream);
}

}  // namespace

extern "C" {

// q [batch, hq, n_q, hd], k/v [batch, hq/group, n_k, hd], o like q; each
// given by its (batch, head, row) element strides, the hd stride 1; f32
// when is_bf16 == 0, else bf16; hd <= 128. Launches on `stream` and
// returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides,  // 12: q, k, v, o x (b, h, s)
                           int batch, int hq, int group, int n_q, int n_k, int hd,
                           float scale, int window, int num_meta, int is_bf16,
                           void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, batch, hq, group, n_q,
                                         n_k, hd, scale, window, num_meta, s);
  return (int)launch_hd<float>(q, k, v, o, sq, sk, sv, so, batch, hq, group, n_q, n_k, hd,
                               scale, window, num_meta, s);
}

}  // extern "C"
