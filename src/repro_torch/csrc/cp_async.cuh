// Asynchronous global -> shared copies (sm_80+ cp.async), shared by the
// streaming scan and the flash-attention kernels. A copy of `bytes` (4, 8
// or 16) with `src_bytes` = 0 writes zeros and reads nothing, which is how
// the ragged edges of a tile are filled.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const int src_bytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
