// Asynchronous copies.  Global -> shared (cp.async, sm_80 on): B6
// (select.cu) and K2's staged group pass (rollup.cu) stream rows of the
// port's tiles, which are 4-byte (timestamps) or 8-byte (values) aligned
// only, by 4- or 8-byte copies; K1 (decode.cu) stages whole 16-byte
// words of its delta planes.  A thread sees its own copies after
// wait_async<n>; other threads' after a barrier too.  Shared -> global
// (cp.async.bulk, sm_90): K1 stores its decoded rows by the bulk copy
// engine, 16-byte aligned spans of a multiple of 16 bytes.

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

// 16 bytes, both addresses 16-byte aligned; bypasses L1
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// Make this thread's ordinary writes to shared memory visible to the
// bulk copy engine (the async proxy); a barrier then orders them before
// the one thread's bulk_store.
__device__ __forceinline__ void fence_shared_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16) of shared memory at `src` to global
// `dst`, both 16-byte aligned, by the bulk copy engine, in this thread's
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk groups have read their shared memory
// (the source may be overwritten after a barrier).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
