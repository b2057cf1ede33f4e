// ssd_scan — the Mamba-2 chunked SSD scan, hand-written for Hopper
// (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t,   y_t = h_t · C_t
//
// computed chunk by chunk as models/ssm.py ssd_chunked does: within a chunk
// of q positions, with a = cumsum(dt A),
//
//   y[l] = Σ_{s<=l} (C_l·B_s) exp(a_l - a_s) x_s dt_s  +  exp(a_l) (state C_l)
//   state <- exp(a_{q-1}) state + Σ_s exp(a_{q-1} - a_s) dt_s x_s ⊗ B_s
//
// x [b, S, h, p], dt [b, S, h] f32 (post-softplus), A [h] f32 (< 0), B/C
// [b, S, n], read through their strides (only the last stride must be 1),
// so the mixer's slices of its conv output are read in place. The initial
// state [b, h, p, n] f32 (zeros when absent) is loaded at chunk 0; y
// [b, S, h, p] in x's dtype and the final state [b, h, p, n] f32 are
// written.
//
// Replaces: src/repro/kernels/ssd_scan.py · ssd_scan (Pallas _ssd_kernel:
// grid (b, h, chunks), the chunk axis sequential with the [p, n] state in
// VMEM scratch; three MXU products per chunk on B and C broadcast to every
// head beforehand).
//
// What bounds it on the card: at Hymba's prefill (b 4, S 2048, h 50, p 64,
// n 16, chunk 128) one call needs 5.9 GFLOP (the causal halves of C·Bᵀ and
// of its product with x·dt, the carried state's two products) on 214 MB
// (x and y dominate): 0.088 ms of f32 operations against 0.064 ms of
// bytes, so operations bound it on paper; in practice the chunks'
// sequential walk, b·h blocks (200 at b 4 on 132 SMs) and the barriers of
// each tile product do.
//
// What the design does about it: one block of 256 threads per (b, h),
// walking the chunks in order with the [n, p] f32 state resident in shared
// memory. Per chunk: dt·A and its cumsum (a warp scan) in shared memory;
// then, for each 64-row tile of the chunk, y's accumulator lives in
// registers (4 rows x 4 columns a thread) and takes the carried state's
// term (C tile x state), then the intra-chunk terms tile by tile of
// sources: G = C Bᵀ (over 32-wide tiles of n), decayed and masked to the
// causal part, staged in shared memory, then G · (x·dt). The state update
// runs last, over tiles of n and of source rows. B and C are read from
// their [b, S, n] tensors, 32 state columns at a time, not broadcast to the
// heads; repeated reads of a chunk's rows by the tiles hit L2. Any chunk
// up to 1024 rows (a ragged last tile is masked), p <= 64, n <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;           // chunk rows (positions) per tile
constexpr int kP = 64;           // head_dim, padded
constexpr int kNT = 32;          // state columns (n) per tile
constexpr int kPad = 4;          // keeps 16-byte alignment of padded rows
constexpr int kMaxChunk = 1024;
constexpr int kMaxN = 256;
constexpr int LD = kR + kPad;    // row stride of CT, BT, GT, Xs, state (68)
constexpr int LDB = kNT + kPad;  // row stride of Bs (36)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;  // [b, h, p, n] or null
  void* y;            // [b, S, h, p] contiguous
  float* final_state; // [b, h, p, n] contiguous
  long long xs_b, xs_s, xs_h;   // x strides (p stride 1)
  long long ds_b, ds_s, ds_h;   // dt strides
  long long bs_b, bs_s;         // B strides (n stride 1)
  long long cs_b, cs_s;         // C strides (n stride 1)
  int seq, heads, p, n, chunk;
};

inline int n_padded(int n) { return (n + kNT - 1) / kNT * kNT; }

inline size_t smem_bytes(int n) {
  // a_cum, state [n_pad][68], CT, BT [32][68], GT, Xs [64][68], Bs [64][36]
  return sizeof(float) *
         (kMaxChunk + (size_t)n_padded(n) * LD + 2 * kNT * LD + 2 * kR * LD + kR * LDB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_pad = (a.n + kNT - 1) / kNT * kNT;
  float* a_cum = smem;                  // [kMaxChunk]
  float* state = a_cum + kMaxChunk;     // state[nn][pp]
  float* CT = state + n_pad * LD;       // CT[nn][row]
  float* BT = CT + kNT * LD;            // BT[nn][src row]
  float* GT = BT + kNT * LD;            // GT[src row][row]
  float* Xs = GT + kR * LD;             // Xs[src row][pp]
  float* Bs = Xs + kR * LD;             // Bs[src row][nn]

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;  // y / G tiles: rows rg*4.., cols cg*4..
  const int pg = tid >> 3, ng = tid & 7;   // state tile: p pg*2.., n ng*4..
  const int q = a.chunk;
  const int n_rt = (q + kR - 1) / kR;
  const int n_nt = n_pad / kNT;

  const T* x = (const T*)a.x + b * a.xs_b + hh * a.xs_h;
  const float* dt = a.dt + b * a.ds_b + hh * a.ds_h;
  const T* Bg = (const T*)a.B + b * a.bs_b;
  const T* Cg = (const T*)a.C + b * a.cs_b;
  const float A = a.A[hh];

  for (int e = tid; e < n_pad * kP; e += kThreads) {
    const int nn = e / kP, pp = e % kP;
    float s0 = 0.f;
    if (a.init && nn < a.n && pp < a.p)
      s0 = a.init[(((long long)b * a.heads + hh) * a.p + pp) * a.n + nn];
    state[nn * LD + pp] = s0;
  }

  for (int t0 = 0; t0 < a.seq; t0 += q) {
    __syncthreads();  // the previous chunk's readers of a_cum are done
    for (int i = tid; i < q; i += kThreads) a_cum[i] = dt[(t0 + i) * a.ds_s] * A;
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum: each lane scans a run, then a warp scan
      const int per = (q + 31) / 32;
      const int lo = min(tid * per, q), hi = min(lo + per, q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += a_cum[i];
        a_cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) a_cum[i] += before;
    }
    __syncthreads();

    // ---- y, one 64-row tile at a time ----
    for (int rt = 0; rt < n_rt; ++rt) {
      const int l0 = rt * kR;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      // the carried state's term: exp(a_l) Σ_n C[l, n] state[n, p]
      for (int nt = 0; nt < n_nt; ++nt) {
        for (int e = tid; e < kR * kNT; e += kThreads) {
          const int r = e / kNT, nn = e % kNT;
          const int l = l0 + r, nc = nt * kNT + nn;
          CT[nn * LD + r] = (l < q && nc < a.n) ? to_f32(Cg[(t0 + l) * a.cs_s + nc]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int nn = 0; nn < kNT; ++nn) {
          const float4 c4 = *reinterpret_cast<const float4*>(&CT[nn * LD + rg * 4]);
          const float4 s4 =
              *reinterpret_cast<const float4*>(&state[(nt * kNT + nn) * LD + cg * 4]);
          const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
          const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], sr[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + rg * 4 + i;
        const float e = l < q ? expf(a_cum[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // the intra-chunk terms, source tile by source tile
      for (int st = 0; st <= rt; ++st) {
        const int s0 = st * kR;
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int nt = 0; nt < n_nt; ++nt) {
          for (int e = tid; e < kR * kNT; e += kThreads) {
            const int r = e / kNT, nn = e % kNT;
            const int nc = nt * kNT + nn;
            const int l = l0 + r, s = s0 + r;
            CT[nn * LD + r] = (l < q && nc < a.n) ? to_f32(Cg[(t0 + l) * a.cs_s + nc]) : 0.f;
            BT[nn * LD + r] = (s < q && nc < a.n) ? to_f32(Bg[(t0 + s) * a.bs_s + nc]) : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int nn = 0; nn < kNT; ++nn) {
            const float4 c4 = *reinterpret_cast<const float4*>(&CT[nn * LD + rg * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&BT[nn * LD + cg * 4]);
            const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
            const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cr[i], br[j], g[i][j]);
          }
          __syncthreads();
        }
        // decay and causal mask; G goes to shared memory as GT[src][row]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + cg * 4 + j;
          float col[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = l0 + rg * 4 + i;
            col[i] = (l < q && s <= l) ? g[i][j] * expf(a_cum[l] - a_cum[s]) : 0.f;
          }
          *reinterpret_cast<float4*>(&GT[(cg * 4 + j) * LD + rg * 4]) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        for (int e = tid; e < kR * kP; e += kThreads) {
          const int r = e / kP, pp = e % kP;
          const int s = s0 + r;
          Xs[r * LD + pp] = (s < q && pp < a.p)
                                ? to_f32(x[(t0 + s) * a.xs_s + pp]) * dt[(t0 + s) * a.ds_s]
                                : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kR; ++s) {
          const float4 g4 = *reinterpret_cast<const float4*>(&GT[s * LD + rg * 4]);
          const float4 x4 = *reinterpret_cast<const float4*>(&Xs[s * LD + cg * 4]);
          const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
          const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gr[i], xr[j], acc[i][j]);
        }
        __syncthreads();
      }

      T* y = (T*)a.y;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + rg * 4 + i;
        if (l >= q) continue;
        const long long row = (((long long)b * a.seq + t0 + l) * a.heads + hh) * a.p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = cg * 4 + j;
          if (pp < a.p) y[row + pp] = from_f32<T>(acc[i][j]);
        }
      }
    }

    // ---- the state update (after every row of the chunk has read it) ----
    const float a_last = a_cum[q - 1];
    const float chunk_decay = expf(a_last);
    for (int nt = 0; nt < n_nt; ++nt) {
      float sacc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sacc[i][j] = state[(nt * kNT + ng * 4 + j) * LD + pg * 2 + i] * chunk_decay;
      for (int st = 0; st < n_rt; ++st) {
        const int s0 = st * kR;
        for (int e = tid; e < kR * kP; e += kThreads) {
          const int r = e / kP, pp = e % kP;
          const int s = s0 + r;
          Xs[r * LD + pp] = (s < q && pp < a.p)
                                ? to_f32(x[(t0 + s) * a.xs_s + pp]) * dt[(t0 + s) * a.ds_s] *
                                      expf(a_last - a_cum[s])
                                : 0.f;
        }
        for (int e = tid; e < kR * kNT; e += kThreads) {
          const int r = e / kNT, nn = e % kNT;
          const int s = s0 + r, nc = nt * kNT + nn;
          Bs[r * LDB + nn] = (s < q && nc < a.n) ? to_f32(Bg[(t0 + s) * a.bs_s + nc]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kR; ++s) {
          const float2 x2 = *reinterpret_cast<const float2*>(&Xs[s * LD + pg * 2]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Bs[s * LDB + ng * 4]);
          const float xr[2] = {x2.x, x2.y};
          const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(xr[i], br[j], sacc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) state[(nt * kNT + ng * 4 + j) * LD + pg * 2 + i] = sacc[i][j];
    }
  }

  __syncthreads();
  for (int e = tid; e < a.p * a.n; e += kThreads) {
    const int pp = e / a.n, nn = e % a.n;
    a.final_state[(((long long)b * a.heads + hh) * a.p + pp) * a.n + nn] = state[nn * LD + pp];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<dim3(a.heads, batch), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, seq, heads, p], dt [batch, seq, heads] f32, A [heads] f32,
// B/C [batch, seq, n], init [batch, heads, p, n] f32 or null, y [batch,
// seq, heads, p] contiguous, final_state [batch, heads, p, n] f32
// contiguous. strides: x (b, s, h), dt (b, s, h), B (b, s), C (b, s) in
// elements. x, B, C f32 when is_bf16 == 0, else bf16 (y likewise); seq a
// multiple of chunk, chunk <= 1024, p <= 64, n <= 256. Launches on
// `stream` and returns cudaGetLastError().
int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                    const void* C, const void* init, void* y, void* final_state,
                    const long long* strides, int batch, int seq, int heads, int p, int n,
                    int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seq % chunk || p < 1 || p > kP || n < 1 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  Args a{x,          (const float*)dt, (const float*)A, B,          C,
         (const float*)init, y,        (float*)final_state,
         strides[0], strides[1],       strides[2],      strides[3], strides[4],
         strides[5], strides[6],       strides[7],      strides[8], strides[9],
         seq,        heads,            p,               n,          chunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)launch<__nv_bfloat16>(a, batch, s);
  return (int)launch<float>(a, batch, s);
}

}  // extern "C"
