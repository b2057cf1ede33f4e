// cp_async — asynchronous global -> shared copies (sm_80+) for staging
// rings, with the copy width chosen from the source's actual alignment.
//
// The port's operands are read in place, so a row may start anywhere a
// 4-byte (f32) or 2-byte (bf16) element can: a [D, P] f32 buffer with
// P = 2 mod 4 has every other row 8 bytes off a 16-byte boundary, and a
// strided [B, S, H, hd] view any row stride at all. chunk16() fills one
// 16-byte-aligned shared-memory chunk from `nbytes` (0..16) source bytes,
// zero-filling the rest, with one 16-byte cp.async.cg where the source is
// 16-byte aligned and whole, else 8- or 4-byte cp.async.ca copies, else
// plain loads and stores: two bytes at a time (a bf16 row), or one (an
// int8 row at any address, or an odd byte count).
#pragma once

#include <stdint.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copies `src_bytes` (<= 16) of 16 and zero-fills the rest; src 16-aligned
__device__ __forceinline__ void cg16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ca8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ca4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst: 16-byte-aligned shared memory. src: a valid global address (pass
// any valid address when nbytes == 0: nothing is read).
__device__ __forceinline__ void chunk16(void* dst, const void* src, int nbytes) {
  nbytes = nbytes < 0 ? 0 : (nbytes > 16 ? 16 : nbytes);
  const uintptr_t a = (uintptr_t)src;
  char* d = (char*)dst;
  const char* s = (const char*)src;
  if ((a & 15) == 0 && (nbytes == 16 || nbytes == 0)) {
    cg16(d, s, nbytes);
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = nbytes - 8 * i;
      ca8(d + 8 * i, n > 0 ? s + 8 * i : s, n < 0 ? 0 : (n > 8 ? 8 : n));
    }
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nbytes - 4 * i;
      ca4(d + 4 * i, n > 0 ? s + 4 * i : s, n < 0 ? 0 : (n > 4 ? 4 : n));
    }
  } else if ((a & 1) == 0 && (nbytes & 1) == 0) {
    const uint16_t* s16 = (const uint16_t*)src;
    uint16_t* d16 = (uint16_t*)dst;
#pragma unroll
    for (int i = 0; i < 8; ++i) d16[i] = 2 * i < nbytes ? s16[i] : (uint16_t)0;
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = i < nbytes ? s[i] : (char)0;
  }
}

}  // namespace cp_async
