// Order statistics for csrc/select.cu (B7's median) and csrc/quantile.cu
// (B8): an order-preserving 64-bit key of a float64 and a block-wide radix
// select over keys.  Included by both sources; kernels.py rebuilds a
// library when a header it includes changes.
//
// Keys: unsigned order = numeric order, -0.0 folded into +0.0 (the
// interpolations that use the order statistics give +0.0 whichever zero
// they read), and NaN as the largest key, kDead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kDead = ~0ULL;

__device__ __forceinline__ double qnan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ unsigned long long order_key(double v) {
  if (v != v) return kDead;
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v == 0.0 ? 0.0 : v));
  return (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  const unsigned long long u =
      (k >> 63) ? (k & 0x7fffffffffffffffULL) : ~k;
  return __longlong_as_double(static_cast<long long>(u));
}

// Block-wide radix select over n keys key(i): the j-th smallest key (0 <= j
// < n), with *less = #keys below it and *equal = #keys equal to it.
// StagedKeys reads keys staged in an array (shared or global memory).
struct StagedKeys {
  const unsigned long long* keys;
  __device__ unsigned long long operator()(int i) const { return keys[i]; }
};

template <class KeyFn>
__device__ unsigned long long block_select(KeyFn key, int n, int j,
                                           int* less, int* equal) {
  __shared__ unsigned hist[256];
  __shared__ int s_pick[3];
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0, mask = 0;
  int below = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int digit = -1;
      if (i < n) {
        const unsigned long long u = key(i);
        if ((u & mask) == prefix) digit = static_cast<int>((u >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      unsigned local = 0;
      for (int b = 0; b < 8; ++b) local += hist[lane * 8 + b];
      unsigned incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned excl = incl - local;
      const unsigned want = static_cast<unsigned>(j - below);
      if (want >= excl && want < incl) {
        unsigned acc = excl;
        int b = 0;
        while (acc + hist[lane * 8 + b] <= want) acc += hist[lane * 8 + b++];
        s_pick[0] = lane * 8 + b;
        s_pick[1] = static_cast<int>(acc);
        s_pick[2] = static_cast<int>(hist[lane * 8 + b]);
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(s_pick[0]) << shift;
    mask |= 0xffULL << shift;
    below += s_pick[1];
    *equal = s_pick[2];
    __syncthreads();
  }
  *less = below;
  return prefix;
}

template <class KeyFn>
__device__ unsigned long long block_min_above(KeyFn key, int n,
                                              unsigned long long floor_key) {
  __shared__ unsigned long long s_min[32];
  unsigned long long m = kDead;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long u = key(i);
    if (u > floor_key && u < m) m = u;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_down_sync(0xffffffffu, m, o);
    m = y < m ? y : m;
  }
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < blockDim.x / 32 ? s_min[threadIdx.x] : kDead;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_down_sync(0xffffffffu, m, o);
      m = y < m ? y : m;
    }
    if (threadIdx.x == 0) s_min[0] = m;
  }
  __syncthreads();
  m = s_min[0];
  __syncthreads();
  return m;
}

}  // namespace
