// Asynchronous global -> shared copies (cp.async, sm_80 on) that B6
// (select.cu) and K2's staged group pass (rollup.cu) stream rows with.
// Rows of the port's tiles are 4-byte (timestamps) or 8-byte (values)
// aligned only, so the copies are 4 or 8 bytes each.  A thread sees its
// own copies after wait_async<n>; other threads' after a barrier too.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of this thread's committed groups are pending.
template <int n>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace
