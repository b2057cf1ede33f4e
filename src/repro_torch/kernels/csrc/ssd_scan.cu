// ssd_scan — the Mamba-2 chunked SSD scan, hand-written for Hopper
// (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t,   y_t = h_t · C_t
//
// computed chunk by chunk as models/ssm.py ssd_chunked does: within a chunk
// c of q positions, with a = cumsum(dt A) over the chunk,
//
//   y[l]      = Σ_{s<=l} (C_l·B_s) exp(a_l - a_s) dt_s x_s  +  exp(a_l) (C_l · state_c)
//   state_c+1 = exp(a_{q-1}) state_c + Σ_s exp(a_{q-1} - a_s) dt_s x_s ⊗ B_s
//
// x [b, S, h, p], dt [b, S, h] f32 (post-softplus), A [h] f32 (< 0), B/C
// [b, S, n], read through their strides (only the last stride must be 1),
// so the mixer's slices of its conv output are read in place. The initial
// state [b, h, p, n] f32 (zeros when absent) enters chunk 0; y [b, S, h, p]
// in x's dtype and the final state [b, h, p, n] f32 are written.
//
// Replaces: src/repro/kernels/ssd_scan.py · ssd_scan (Pallas _ssd_kernel:
// grid (b, h, chunks), the chunk axis sequential with the [p, n] state in
// VMEM scratch; three MXU products per chunk on B and C broadcast to every
// head beforehand).
//
// What bounds it on the card: at Hymba's prefill (b 4, S 2048, h 50, p 64,
// n 16, chunk 128) one call needs 5.9 GFLOP (the causal halves of C·Bᵀ and
// of its product with x·dt, the carried state's two products) on 214 MB
// (x and y dominate): 0.064 ms of bytes at 3.35 TB/s against 0.036 ms of
// split-f32 tensor-core operations (3 x 5.9 GFLOP at 495 TFLOP/s), so
// bytes bound it. This design moves more than those 214 MB: x is read by
// the chunk-state pass and again by the output pass (by every row tile at
// or below its source tile), and the [b, h, nc, p, n] f32 workspace of
// chunk states (13 MB at Hymba) is written, read and rewritten by the
// state pass and read by the output pass.
//
// What the design does about it: Mamba-2's split into chunk-local work,
// parallel over (b, h, chunk), and a short recurrence on the [p, n] state
// across chunks, in three launches on the caller's stream:
// 1. ssd_scan_kernel_local, one block of 4 warps per (b, h, chunk, group
//    of up to 64 state columns): the chunk's a = cumsum(dt A) (one warp
//    scan, shared with pass 3 so both see the same values), then the
//    chunk's own state Σ_s exp(a_last - a_s) dt_s x_s ⊗ B_s as a
//    [p, q] x [q, n] product, warp w owning state rows 16w.. and the
//    group's n8 tiles (2, 4 or 8 of them: n = 16 runs 16 columns, not 32);
//    the chunk's rows stream through two cp.async buffers of 64 sources.
//    It writes the state and a_last to the workspace.
// 2. ssd_scan_kernel_carry, one thread per (b, h, p, n): state_c =
//    state_{c-1} · exp(a_last,c-1) + local_{c-1}, in the JAX kernel's
//    order (a rounded product, then a rounded sum), from initial_state or
//    zeros; each chunk's incoming state overwrites its local one, and the
//    last is the final state.
// 3. ssd_scan_kernel_output, one block of 4 warps per (b, h, chunk, 64-row
//    tile of the chunk), warp w owning rows 16w..: y's accumulator starts
//    as exp(a_l) (C · state_cᵀ), then for each source tile at or below the
//    diagonal G = C·Bᵀ, decayed by exp(a_l - a_s) dt_s and causally masked
//    on the accumulator fragments, and y += G · x with G kept in registers
//    (A's columns t and t + 4 stand for sources 2t and 2t + 1, the pair
//    the C fragment holds, as flash_attention.cu does with P). C stays in
//    shared memory; B and x tiles are double-buffered with cp.async, and
//    the chunk state is staged where the second buffer goes.
// Every product is split-f32 mma.sync.m16n8k8 (tf32x3.cuh); a bf16 x, B or
// C is exact in TF32 and takes fewer terms. exp, the mask and the decay
// stay on the CUDA cores. The products run on the fast split; a block of
// pass 1 or 3 whose result holds an inf or NaN runs again on the full one,
// whose products follow IEEE. Any chunk up to 1024 that divides S (ragged
// row and source tiles are masked), p <= 64 (padded to 64), n <= 256
// (padded to whole k8 steps).
//
// Non-finite values above the diagonal. The JAX kernel takes the whole
// chunk: y = ((C·Bᵀ) ∘ L) · (x·dt) with L = 0 above the diagonal, so a
// source s makes every earlier row l < s of its chunk NaN wherever C_l·B_s
// or x_s·dt_s is not finite: (C_l·B_s)·0 is NaN for a non-finite C row or
// B row (all columns), and 0 · (x·dt)[s, p] is NaN for a non-finite
// x[s, p] or dt_s (column p, or all of them). Pass 3 keeps that without
// visiting more: on the full split (the fast split's result is never
// silently finite, so a block whose own tiles hold such a value is always
// taken again) its masked entries are G·(0·dt_s) instead of 0; the source
// tiles above the diagonal, which it skips, are summarized by pass 1, which
// reads every source anyway: on its full split it writes, per (b, h,
// chunk, 64-source tile, group of state columns), a bitmask over p of
// "x·dt holds an inf or NaN in this column", all ones where the group's
// B columns hold one (zeros on the fast split: then nothing there is non-
// finite). Pass 3 ORs the masks of the tiles above its row tile into NaN
// columns, and a row whose C holds an inf or NaN is NaN in every column
// when such a tile exists. Finite input pays only the masks' stores and
// loads. Limit: x·dt that overflows f32 from finite x and dt is not
// flagged (the reference then gives NaN in earlier rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kR = 64;           // rows per tile (output rows, sources)
constexpr int kP = 64;           // head_dim, padded
constexpr int kMaxChunk = 1024;
constexpr int kMaxTiles = kMaxChunk / kR;  // 64-row tiles of a chunk
constexpr int kFlagSlots = 4;              // pass 1's groups of state columns, at most
constexpr int kMaxN = 256;
constexpr int kPX1 = kP + 8;     // pass 1 x pitch: [source][p] read as (t, g)
constexpr int kPX3F = kP + 4;    // pass 3 x pitch, f32: [source][p] read as (2t, g)
constexpr int kPX3H = kP + 8;    // the same, bf16

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;   // [b, h, p, n] or null
  void* y;             // [b, S, h, p] contiguous
  float* final_state;  // [b, h, p, n] contiguous
  float* ws;           // [b, h, nc, p, n]: chunk states, then incoming states
  float* alast;        // [b, h, nc]: a at each chunk's last row
  unsigned long long* flags;  // [b, h, nc, tiles, kFlagSlots]: pass 1's masks of non-finite columns
  long long xs_b, xs_s, xs_h;   // x strides (p stride 1)
  long long ds_b, ds_s, ds_h;   // dt strides
  long long bs_b, bs_s;         // B strides (n stride 1)
  long long cs_b, cs_s;         // C strides (n stride 1)
  int batch, seq, heads, p, n, chunk, nc;
  int n_pad;     // n in whole k8 steps
  int ngroups;   // pass 1: groups of state columns
  int nbuf;      // pass 3: source buffers (1 or 2)
};

// exp with subnormal results flushed to 0, as XLA computes the reference
// on the CPU and the TPU (where a decay underflows, an inf state times it
// is NaN there); the plain version's ref._exp_ftz
__device__ __forceinline__ float exp_ftz(float z) {
  const float e = expf(z);
  return e < 1.17549435e-38f ? 0.f : e;  // FLT_MIN; a NaN stays NaN
}
// exp_ftz on the full split; plain expf on the fast one, whose result is
// kept only where every input it met is finite (a flushed subnormal then
// changes it by less than FLT_MIN times a finite value)
template <bool kFull>
__device__ __forceinline__ float exp_as(float z) {
  if constexpr (kFull) return exp_ftz(z);
  else return expf(z);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* dst, float v0, float v1, bool both) {
  if (both && ((uintptr_t)dst & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (both) dst[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1, bool both) {
  if (both && ((uintptr_t)dst & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (both) dst[1] = __float2bfloat16_rn(v1);
  }
}

// element idx of a shared tile as a TF32 operand: f32 split (kFull:
// tf32x3::split, else split_fast); a bf16 is exact, its value in both
// slots on the fast path and its finite part in lo's on the full one
template <bool kFull>
__device__ __forceinline__ void frag(const float* s, int idx, uint32_t& hi, uint32_t& lo) {
  tf32x3::split_as<kFull>(s[idx], hi, lo);
}
template <bool kFull>
__device__ __forceinline__ void frag(const __nv_bfloat16* s, int idx, uint32_t& hi,
                                     uint32_t& lo) {
  const uint32_t bits = tf32x3::bf16_bits(reinterpret_cast<const uint16_t*>(s)[idx]);
  if constexpr (kFull) tf32x3::exact(bits, hi, lo);
  else hi = lo = bits;
}

// pass 3's pitch of C, B ([row][n] read as (g, t)): f32 n_pad + 4 (4 mod 8
// words); bf16 8 mod 16 halves (4 mod 8 words), rows 16-byte aligned
template <typename T> __host__ __device__ __forceinline__ int pitch_n(int n_pad) {
  return sizeof(T) == 4 ? n_pad + 4 : n_pad + (n_pad % 16 ? 16 : 8);
}
template <typename T> __host__ __device__ constexpr int pitch_x3() {
  return sizeof(T) == 4 ? kPX3F : kPX3H;
}

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Stage rows [0, rows) of a [*, cols_pad] tile with pitch `pitch` from
// `src` (row r at src + r * stride), cp.async per 16-byte chunk; rows past
// `rows_valid` and columns past `cols_valid` load zeros.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src, long long stride,
                                      int rows, int rows_valid, int cols_pad, int cols_valid) {
  constexpr int EPC = 16 / (int)sizeof(T);
  const int cpr = cols_pad / EPC;
  for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * EPC;
    const int nbytes = r < rows_valid && c < cols_valid
                           ? min(EPC, cols_valid - c) * (int)sizeof(T) : 0;
    cp_async::chunk16(dst + r * pitch + c, nbytes ? src + r * stride + c : src, nbytes);
  }
}

// The chunk's dt (dtv) and inclusive cumsum of dt·A (a_cum), both [q], in
// one fixed order (each lane of warp 0 scans a run, then a warp scan of
// the runs): passes 1 and 3 call it alike and see the same values.
// Starts and ends with a barrier of the whole block.
__device__ __forceinline__ void chunk_scan(float* a_cum, float* dtv, const float* dtc,
                                           long long ds_s, float A, int q) {
  const int tid = threadIdx.x;
  for (int i = tid; i < q; i += kThreads) {
    const float d = dtc[i * ds_s];
    dtv[i] = d;
    a_cum[i] = d * A;
  }
  __syncthreads();
  if (tid < 32) {
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
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's own state, local[p, n] = Σ_s (x_s[p] w_s) B_s[n],
// w_s = dt_s exp(a_last - a_s)
// ---------------------------------------------------------------------------

template <typename T, int NTW>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel_local(Args a) {
  constexpr bool kB = sizeof(T) == 2;
  constexpr int GW = NTW * 8;    // state columns of the group
  constexpr int PB1 = GW + 8;    // [source][n] read as (t, g)
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = a.chunk;
  const int c = blockIdx.x / a.ngroups, grp = blockIdx.x - c * a.ngroups;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int t0 = c * q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float* a_cum = reinterpret_cast<float*>(smem);
  float* dtv = a_cum + q;
  float* w = dtv + q;
  // each source tile's mask of non-finite columns (the full split only)
  unsigned long long* tflag =
      reinterpret_cast<unsigned long long*>(smem + align16((size_t)3 * q * sizeof(float)));
  unsigned char* bufs = reinterpret_cast<unsigned char*>(tflag + kMaxTiles);
  if (tid < kMaxTiles) tflag[tid] = 0ull;
  const size_t xbytes = (size_t)kR * kPX1 * sizeof(T);
  const size_t buf_bytes = xbytes + (size_t)kR * PB1 * sizeof(T);

  const T* xc = (const T*)a.x + b * a.xs_b + hh * a.xs_h + (long long)t0 * a.xs_s;
  const T* Bc = (const T*)a.B + b * a.bs_b + (long long)t0 * a.bs_s + grp * GW;
  const int n_valid = min(GW, a.n - grp * GW);
  auto issue = [&](int st) {
    unsigned char* buf = bufs + (st & 1) * buf_bytes;
    const int s0 = st * kR;
    stage<T>(reinterpret_cast<T*>(buf), kPX1, xc + s0 * a.xs_s, a.xs_s, kR, q - s0, kP, a.p);
    stage<T>(reinterpret_cast<T*>(buf + xbytes), PB1, Bc + s0 * a.bs_s, a.bs_s, kR, q - s0, GW,
             n_valid);
  };
  issue(0);
  cp_async::commit();

  chunk_scan(a_cum, dtv, a.dt + b * a.ds_b + hh * a.ds_h + (long long)t0 * a.ds_s, a.ds_s,
             a.A[hh], q);
  const float a_last = a_cum[q - 1];
  for (int i = tid; i < q; i += kThreads) w[i] = dtv[i] * exp_ftz(a_last - a_cum[i]);

  float acc[NTW][4];
  const int nst = (q + kR - 1) / kR;
  const int prow = warp * 16 + g;  // this lane's state rows: prow, prow + 8
  // the product over the chunk's sources, on the fast split (kSlow false)
  // or, again, on the full one where the fast result holds an inf or NaN
  auto run = [&](auto slow_tag) {
    constexpr bool kSlow = decltype(slow_tag)::value;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int st = 0; st < nst; ++st) {
      cp_async::wait<0>();
      __syncthreads();  // tile st staged (and w written); all warps done with st - 1
      if (st + 1 < nst) issue(st + 1);
      cp_async::commit();
      const T* xs = reinterpret_cast<const T*>(bufs + (st & 1) * buf_bytes);
      const T* bs = reinterpret_cast<const T*>(bufs + (st & 1) * buf_bytes + xbytes);
      const int s0 = st * kR;
      const int nks = min(kR, q - s0 + 7) / 8;  // k8 steps holding a source
      if constexpr (kSlow) {
        // the tile's columns where x·dt is not finite; all of them where
        // the group's B columns hold an inf or NaN
        unsigned long long bits = 0ull;
        bool b_bad = false;
        for (int e = tid; e < kR * kP; e += kThreads) {
          const int r = e / kP, col = e % kP;
          if (s0 + r < q && col < a.p &&
              !tf32x3::finite(to_f32(xs[r * kPX1 + col]) * dtv[s0 + r]))
            bits |= 1ull << col;
        }
        for (int e = tid; e < kR * GW; e += kThreads) {
          const int r = e / GW, col = e % GW;
          b_bad |= s0 + r < q && col < n_valid && !tf32x3::finite(to_f32(bs[r * PB1 + col]));
        }
        if (b_bad) bits = ~0ull;
        if (bits) atomicOr(&tflag[st], bits);
      }
#pragma unroll
      for (int ks = 0; ks < kR / 8; ++ks) {
        if (ks >= nks) break;
        const int r0 = ks * 8 + t, r1 = r0 + 4;
        const float w0 = s0 + r0 < q ? w[s0 + r0] : 0.f;
        const float w1 = s0 + r1 < q ? w[s0 + r1] : 0.f;
        uint32_t ah[4], al[4];
        tf32x3::split_as<kSlow>(to_f32(xs[r0 * kPX1 + prow]) * w0, ah[0], al[0]);
        tf32x3::split_as<kSlow>(to_f32(xs[r0 * kPX1 + prow + 8]) * w0, ah[1], al[1]);
        tf32x3::split_as<kSlow>(to_f32(xs[r1 * kPX1 + prow]) * w1, ah[2], al[2]);
        tf32x3::split_as<kSlow>(to_f32(xs[r1 * kPX1 + prow + 8]) * w1, ah[3], al[3]);
        uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          frag<kSlow>(bs, r0 * PB1 + j * 8 + g, bh[j][0], bl[j][0]);
          frag<kSlow>(bs, r1 * PB1 + j * 8 + g, bh[j][1], bl[j][1]);
        }
        tf32x3::mma_split<NTW, false, kB>(acc, ah, al, bh, bl);
      }
    }
    cp_async::wait<0>();
  };
  run(std::false_type{});
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) bad |= !tf32x3::finite(acc[j][e]);
  if (__syncthreads_or(bad)) {  // every warp is done with the buffers
    issue(0);
    cp_async::commit();
    run(std::true_type{});
  }

  const long long bh_c = ((long long)b * a.heads + hh) * a.nc + c;
  __syncthreads();  // every tile's mask is in tflag
  if (tid < nst) a.flags[(bh_c * nst + tid) * kFlagSlots + grp] = tflag[tid];
  float* out = a.ws + bh_c * a.p * a.n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pp = prow + 8 * half;
    if (pp >= a.p) continue;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nn = grp * GW + j * 8 + 2 * t;
      if (nn < a.n)
        store2(out + (long long)pp * a.n + nn, acc[j][2 * half], acc[j][2 * half + 1],
               nn + 1 < a.n);
    }
  }
  if (tid == 0 && grp == 0) a.alast[bh_c] = a_last;
}

// ---------------------------------------------------------------------------
// pass 2: the recurrence across chunks, one thread per (b, h, p, n)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ssd_scan_kernel_carry(Args a) {
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  const long long pn = (long long)a.p * a.n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.batch * a.heads * pn) return;
  const long long bh = idx / pn, e = idx - bh * pn;
  float state = a.init ? a.init[idx] : 0.f;
  float* slot = a.ws + bh * a.nc * pn + e;
  const float* al = a.alast + bh * a.nc;
  for (int c0 = 0; c0 < a.nc; c0 += kAhead) {
    float local[kAhead], decay[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      local[i] = c0 + i < a.nc ? slot[(c0 + i) * pn] : 0.f;
      decay[i] = c0 + i < a.nc ? exp_ftz(al[c0 + i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i >= a.nc) break;
      slot[(c0 + i) * pn] = state;  // the state entering chunk c0 + i
      state = __fadd_rn(__fmul_rn(state, decay[i]), local[i]);
    }
  }
  a.final_state[idx] = state;
}

// ---------------------------------------------------------------------------
// pass 3: y, one 64-row tile of a chunk per block
// ---------------------------------------------------------------------------

// (at most 128 registers: four blocks share an SM at Hymba's shape; the
// full split's extra terms must not take that from the fast path)
template <typename T>
__global__ void __launch_bounds__(kThreads, 4) ssd_scan_kernel_output(Args a) {
  constexpr bool kB = sizeof(T) == 2;
  constexpr int PX = pitch_x3<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = a.chunk;
  const int n_rt = (q + kR - 1) / kR;
  const int c = blockIdx.x / n_rt, rt = blockIdx.x - c * n_rt;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int t0 = c * q, l0 = rt * kR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_pad = a.n_pad, PN = pitch_n<T>(n_pad), PS = n_pad + 4;

  float* a_cum = reinterpret_cast<float*>(smem);
  float* dtv = a_cum + q;
  T* Cs = reinterpret_cast<T*>(smem + align16((size_t)2 * q * sizeof(float)));
  unsigned char* buf0 = reinterpret_cast<unsigned char*>(Cs) + align16((size_t)kR * PN * sizeof(T));
  const size_t bbytes = align16((size_t)kR * PN * sizeof(T));
  const size_t buf_bytes = bbytes + (size_t)kR * PX * sizeof(T);
  unsigned char* region1 = buf0 + align16(buf_bytes);  // the second buffer, or St
  float* St = reinterpret_cast<float*>(region1);       // [kP][PS]: state_c

  const long long bh_c = ((long long)b * a.heads + hh) * a.nc + c;
  const T* xc = (const T*)a.x + b * a.xs_b + hh * a.xs_h + (long long)t0 * a.xs_s;
  const T* Bc = (const T*)a.B + b * a.bs_b + (long long)t0 * a.bs_s;
  const T* Cc = (const T*)a.C + b * a.cs_b + (long long)(t0 + l0) * a.cs_s;
  auto issue = [&](int st) {
    unsigned char* buf = (a.nbuf == 2 && (st & 1)) ? region1 : buf0;
    const int s0 = st * kR;
    stage<T>(reinterpret_cast<T*>(buf), PN, Bc + s0 * a.bs_s, a.bs_s, kR, q - s0, n_pad, a.n);
    stage<T>(reinterpret_cast<T*>(buf + bbytes), PX, xc + s0 * a.xs_s, a.xs_s, kR, q - s0, kP,
             a.p);
  };
  // C, the chunk's incoming state and the first source tile
  auto issue_first = [&]() {
    stage<T>(Cs, PN, Cc, a.cs_s, kR, q - l0, n_pad, a.n);
    stage<float>(St, PS, a.ws + bh_c * a.p * a.n, a.n, kP, a.p, n_pad, a.n);
    issue(0);
    cp_async::commit();
  };
  issue_first();

  // the columns pass 1 found not finite (x·dt, or B) in the source tiles
  // above this row tile, which no warp visits; read by warp 0 before the
  // main loop and kept in shared memory (chunk_scan's barriers publish it)
  __shared__ unsigned long long skipped_nan_cols;
  if (warp == 0) {
    unsigned long long m = 0ull;
    const unsigned long long* fl = a.flags + (bh_c * n_rt + rt + 1) * kFlagSlots;
    const int cnt = (n_rt - rt - 1) * kFlagSlots;
    for (int i = lane; i < cnt; i += 32)
      if ((i & (kFlagSlots - 1)) < a.ngroups) m |= fl[i];
    const uint32_t lo = __reduce_or_sync(0xffffffffu, (uint32_t)m);
    const uint32_t hi = __reduce_or_sync(0xffffffffu, (uint32_t)(m >> 32));
    if (lane == 0) skipped_nan_cols = ((unsigned long long)hi << 32) | lo;
  }

  chunk_scan(a_cum, dtv, a.dt + b * a.ds_b + hh * a.ds_h + (long long)t0 * a.ds_s, a.ds_s,
             a.A[hh], q);

  const int crow = warp * 16 + g;                // tile rows crow, crow + 8
  const int l_lo = l0 + crow, l_hi = l_lo + 8;   // chunk rows
  const int nks = n_pad / 8;
  float acc[8][4];

  // the block's work on the fast split (kSlow false) or, again, on the
  // full one where the fast result holds an inf or NaN
  auto run = [&](auto slow_tag) {
    constexpr bool kSlow = decltype(slow_tag)::value;
    // C's A fragments of k8 step ks
    auto c_frag = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      const int idx = crow * PN + ks * 8 + t;
      frag<kSlow>(Cs, idx, hi[0], lo[0]);
      frag<kSlow>(Cs, idx + 8 * PN, hi[1], lo[1]);
      frag<kSlow>(Cs, idx + 4, hi[2], lo[2]);
      frag<kSlow>(Cs, idx + 8 * PN + 4, hi[3], lo[3]);
    };
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int st = 0; st <= rt; ++st) {
      cp_async::wait<0>();
      __syncthreads();  // tile st staged; all warps done with tile st - 1
      if (st == 0) {
        // the carried state's term: exp(a_l) Σ_n C[l, n] state_c[p, n]
        for (int ks = 0; ks < nks; ++ks) {
          uint32_t ah[4], al[4];
          c_frag(ks, ah, al);
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = (j * 8 + g) * PS + ks * 8 + t;
            tf32x3::split_as<kSlow>(St[idx], bh[j][0], bl[j][0]);
            tf32x3::split_as<kSlow>(St[idx + 4], bh[j][1], bl[j][1]);
          }
          tf32x3::mma_split<8, kB, false>(acc, ah, al, bh, bl);
        }
        const float e_lo = l_lo < q ? exp_as<kSlow>(a_cum[l_lo]) : 0.f;
        const float e_hi = l_hi < q ? exp_as<kSlow>(a_cum[l_hi]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= e_lo;
          acc[j][1] *= e_lo;
          acc[j][2] *= e_hi;
          acc[j][3] *= e_hi;
        }
        __syncthreads();  // every warp has read St before the second buffer replaces it
      }
      if (a.nbuf == 2 && st < rt) issue(st + 1);
      cp_async::commit();

      const unsigned char* buf = (a.nbuf == 2 && (st & 1)) ? region1 : buf0;
      const T* Bs = reinterpret_cast<const T*>(buf);
      const T* Xs = reinterpret_cast<const T*>(buf + bbytes);
      const int s0 = st * kR;
      // G = C Bᵀ over the n k8 steps: rows crow (+8), sources j·8 + g
      float G[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t ah[4], al[4];
        c_frag(ks, ah, al);
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = (j * 8 + g) * PN + ks * 8 + t;
          frag<kSlow>(Bs, idx, bh[j][0], bl[j][0]);
          frag<kSlow>(Bs, idx + 4, bh[j][1], bl[j][1]);
        }
        tf32x3::mma_split<8, kB, kB>(G, ah, al, bh, bl);
      }
      // decay exp(a_l - a_s) dt_s and the causal mask (s <= l < q) on the
      // fragments: G[j][e] is row (e < 2 ? l_lo : l_hi), source
      // s0 + 8j + 2t + (e & 1)
      // (the full split keeps the reference's masked term: G·(0·dt_s) is
      // NaN where C_l·B_s or dt_s is not finite)
      const float al_lo = l_lo < q ? a_cum[l_lo] : 0.f;
      const float al_hi = l_hi < q ? a_cum[l_hi] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = e < 2 ? l_lo : l_hi;
          const int s = s0 + j * 8 + 2 * t + (e & 1);
          const bool vis = l < q && s <= l;
          if (vis)
            G[j][e] *= exp_as<kSlow>((e < 2 ? al_lo : al_hi) - a_cum[s]) * dtv[s];
          else
            G[j][e] = kSlow && s < q ? G[j][e] * (0.f * dtv[s]) : 0.f;
        }
      // y += G · x over the tile's eight k8 steps of sources; A's columns t
      // and t + 4 stand for sources 2t and 2t + 1, which this lane holds
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ph[4], pl[4];
        tf32x3::split_as<kSlow>(G[kk][0], ph[0], pl[0]);
        tf32x3::split_as<kSlow>(G[kk][2], ph[1], pl[1]);
        tf32x3::split_as<kSlow>(G[kk][1], ph[2], pl[2]);
        tf32x3::split_as<kSlow>(G[kk][3], ph[3], pl[3]);
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = (kk * 8 + 2 * t) * PX + j * 8 + g;  // x[source 2t][p g]
          frag<kSlow>(Xs, idx, bh[j][0], bl[j][0]);
          frag<kSlow>(Xs, idx + PX, bh[j][1], bl[j][1]);
        }
        tf32x3::mma_split<8, false, kB>(acc, ph, pl, bh, bl);
      }
      if (a.nbuf == 1 && st < rt) {
        __syncthreads();  // every warp is done with the one buffer
        issue(st + 1);
        cp_async::commit();
      }
    }
    cp_async::wait<0>();
  };
  run(std::false_type{});
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) bad |= !tf32x3::finite(acc[j][e]);
  const bool slow = __syncthreads_or(bad);  // every warp is done with the buffers
  if (slow) {
    issue_first();
    run(std::true_type{});
  }

  // the source tiles above this row tile, which no warp visited: the
  // columns where pass 1 found x·dt (or B) not finite are NaN in every row
  // of the tile, and so is every column of a row whose C is not finite
  // (its C·B against those sources is; such a C sends the block to the
  // full split)
  const unsigned long long nan_cols = skipped_nan_cols;
  bool c_bad_lo = false, c_bad_hi = false;
  if (rt + 1 < n_rt) {
    if (slow) {
      for (int col = t; col < a.n; col += 4) {
        c_bad_lo |= !tf32x3::finite(to_f32(Cs[crow * PN + col]));
        c_bad_hi |= !tf32x3::finite(to_f32(Cs[(crow + 8) * PN + col]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        c_bad_lo |= __shfl_xor_sync(0xffffffffu, c_bad_lo, off);
        c_bad_hi |= __shfl_xor_sync(0xffffffffu, c_bad_hi, off);
      }
    }
  }

  T* y = (T*)a.y;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = half ? l_hi : l_lo;
    if (l >= q) continue;
    const unsigned long long row_nan = (half ? c_bad_hi : c_bad_lo) ? ~0ull : nan_cols;
    T* row = y + (((long long)b * a.seq + t0 + l) * a.heads + hh) * a.p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pp = j * 8 + 2 * t;
      if (pp < a.p)
        store2(row + pp, (row_nan >> pp) & 1 ? nan : acc[j][2 * half],
               (row_nan >> (pp + 1)) & 1 ? nan : acc[j][2 * half + 1], pp + 1 < a.p);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int NTW>
cudaError_t launch_local(const Args& a, int smem_max, cudaStream_t stream) {
  const size_t bytes = align16((size_t)3 * a.chunk * sizeof(float)) +
                       kMaxTiles * sizeof(unsigned long long) +
                       2 * ((size_t)kR * kPX1 + (size_t)kR * (NTW * 8 + 8)) * sizeof(T);
  if (bytes > (size_t)smem_max) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel_local<T, NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel_local<T, NTW>
      <<<dim3(a.nc * a.ngroups, a.heads, a.batch), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  a.n_pad = (a.n + 7) / 8 * 8;
  const int nt = a.n_pad / 8;           // n8 tiles of state columns
  const int ntw = nt <= 2 ? 2 : (nt <= 4 ? 4 : 8);
  a.ngroups = (nt + ntw - 1) / ntw;  // <= kFlagSlots at n <= 256

  // pass 3's shared memory: a_cum and dt, C, one buffer of B and x, and
  // the second buffer or (where two do not fit) the state alone
  const int PN = pitch_n<T>(a.n_pad);
  const size_t head = align16((size_t)2 * a.chunk * sizeof(float)) +
                      align16((size_t)kR * PN * sizeof(T));
  const size_t buf = align16((size_t)kR * PN * sizeof(T)) + (size_t)kR * pitch_x3<T>() * sizeof(T);
  const size_t st_bytes = (size_t)kP * (a.n_pad + 4) * sizeof(float);
  size_t out_bytes = head + align16(buf) + (buf > st_bytes ? buf : st_bytes);
  a.nbuf = 2;
  if (out_bytes > (size_t)smem_max) {
    a.nbuf = 1;
    out_bytes = head + align16(buf) + st_bytes;
    if (out_bytes > (size_t)smem_max) return cudaErrorInvalidConfiguration;
  }

  if (ntw == 2) err = launch_local<T, 2>(a, smem_max, stream);
  else if (ntw == 4) err = launch_local<T, 4>(a, smem_max, stream);
  else err = launch_local<T, 8>(a, smem_max, stream);
  if (err != cudaSuccess) return err;

  const long long total = (long long)a.batch * a.heads * a.p * a.n;
  ssd_scan_kernel_carry<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(ssd_scan_kernel_output<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_bytes);
  if (err != cudaSuccess) return err;
  const int n_rt = (a.chunk + kR - 1) / kR;
  ssd_scan_kernel_output<T>
      <<<dim3(a.nc * n_rt, a.heads, a.batch), kThreads, out_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, seq, heads, p], dt [batch, seq, heads] f32, A [heads] f32,
// B/C [batch, seq, n], init [batch, heads, p, n] f32 or null, y [batch,
// seq, heads, p] contiguous, final_state [batch, heads, p, n] f32
// contiguous, ws [batch, heads, seq / chunk, p, n] f32, alast [batch,
// heads, seq / chunk] f32 and flags [batch, heads, seq / chunk,
// ceil(chunk / 64), 4] 64-bit workspaces. strides: x (b, s, h), dt (b, s, h),
// B (b, s), C (b, s) in elements. x, B, C f32 when is_bf16 == 0, else
// bf16 (y likewise); seq a multiple of chunk, chunk <= 1024, p <= 64,
// n <= 256. Three launches on `stream`; returns the first failure of
// cudaGetLastError().
int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                    const void* C, const void* init, void* y, void* final_state, void* ws,
                    void* alast, void* flags, const long long* strides, int batch, int seq,
                    int heads, int p, int n, int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seq % chunk || p < 1 || p > kP || n < 1 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  Args a{x,          (const float*)dt, (const float*)A, B,          C,
         (const float*)init, y,        (float*)final_state, (float*)ws, (float*)alast,
         (unsigned long long*)flags,
         strides[0], strides[1],       strides[2],      strides[3], strides[4],
         strides[5], strides[6],       strides[7],      strides[8], strides[9],
         batch,      seq,              heads,           p,          n,
         chunk,      seq / chunk,      0,               0,          0};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)launch<__nv_bfloat16>(a, s);
  return (int)launch<float>(a, s);
}

}  // extern "C"
