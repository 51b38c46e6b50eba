// B8 rollup_quantile_tile: quantile(phi, rollup(m[window])) by (...) ->
// [G, T], on a rolled tile [S, T] (the output of B5 rollup_series) and the
// group layout K2 uses (group g owns rows order[starts[g]:starts[g+1]]).
//
// Replaces victoriametrics_tpu/ops/device_rollup.py:rollup_quantile_tile,
// which scatters the rolled tile into a dense [G, M, T] tensor (M = the
// largest group), sorts it along M with NaN last, and interpolates at
// rank = clip(phi, 0, 1) (n - 1) over the n live members of each (group,
// step): q = v_lo + (rank - lo) (v_hi - v_lo) with lo = floor(rank), hi =
// ceil(rank); phi < 0 gives -Inf, phi > 1 gives +Inf, n = 0 gives NaN.
// Nothing dense is built here: each (group, step) gathers its members'
// values through the layout and takes the two order statistics it needs.
//  * M <= 32: quantile_warp, one warp per (group, step).  Lane i holds
//    member i; its position in the stable sort (value, then member order)
//    is the number of members before it, counted over the warp by
//    shuffles, and the lanes at positions lo and hi hold v_lo and v_hi.
//  * larger groups: quantile_block, one block per (group, step).  The
//    members' order-preserving 64-bit keys (NaN as the largest key, never
//    selected since lo, hi < n) are staged in shared memory when M <=
//    kStageMax, else read through the layout from global memory, and a
//    radix select (8 passes of 8 bits, warp-aggregated shared-memory
//    histograms) finds the lo-th key; v_hi is the same key when enough
//    keys equal it, else the least larger key.  The interpolation gives
//    +0.0 whichever zero sits at lo or hi, so the keys fold -0.0 into
//    +0.0; inf - inf gives NaN as in the reference.
//
// Bound: bytes.  The function must read the rolled tile once (8 B per
// (series, step)) and the layout, and write [G, T].  The warp path reads
// each member once; the block path's radix passes re-read staged keys
// from shared memory (global memory above kStageMax).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 256;
constexpr int kStageMax = 24576;  // keys staged in shared memory (192 KiB)

// The reference's interpolation and its phi / n special cases.
__device__ __forceinline__ double finish(double phi, double rank, int lo,
                                         double v_lo, double v_hi, int n) {
  double q = v_lo + (rank - static_cast<double>(lo)) * (v_hi - v_lo);
  if (phi < 0.0) q = -INFINITY;
  if (phi > 1.0) q = INFINITY;
  return n > 0 ? q : qnan();
}

__device__ __forceinline__ double rank_of(double phi, int n) {
  const double c = phi < 0.0 ? 0.0 : (phi > 1.0 ? 1.0 : phi);
  return c * static_cast<double>(n - 1 > 0 ? n - 1 : 0);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantile_warp(const double* __restrict__ rolled, int T,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, long long G, double phi,
              double* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
      (threadIdx.x >> 5);
  if (pair >= G * T) return;  // uniform across the warp
  const long long g = pair / T;
  const int t = static_cast<int>(pair % T);
  const int k0 = starts[g];
  const int m = starts[g + 1] - k0;
  double v = qnan();
  if (lane < m) v = rolled[static_cast<long long>(order[k0 + lane]) * T + t];
  const bool live = v == v;
  const unsigned long long key = live ? order_key(v) : kDead;
  const int n = __popc(__ballot_sync(full, live));
  // position in the stable ascending sort: members before this one
  int pos = 0;
  for (int j = 0; j < 32; ++j) {
    const unsigned long long kj = __shfl_sync(full, key, j);
    pos += kj < key || (kj == key && j < lane);
  }
  const double rank = rank_of(phi, n);
  const int lo = static_cast<int>(floor(rank));
  const int hi = static_cast<int>(ceil(rank));
  const unsigned at_lo = __ballot_sync(full, pos == lo);
  const unsigned at_hi = __ballot_sync(full, pos == hi);
  const double v_lo = __shfl_sync(full, v, __ffs(at_lo) - 1);
  const double v_hi = __shfl_sync(full, v, __ffs(at_hi) - 1);
  if (lane == 0) out[g * T + t] = finish(phi, rank, lo, v_lo, v_hi, n);
}

struct MemberKeys {  // member i of a group, read through the layout
  const double* rolled;
  const int32_t* rows;
  int T, t;
  __device__ unsigned long long operator()(int i) const {
    return order_key(rolled[static_cast<long long>(rows[i]) * T + t]);
  }
};

template <class KeyFn>
__device__ double quantile_of(KeyFn key, int m, int n, double phi) {
  const double rank = rank_of(phi, n);
  const int lo = static_cast<int>(floor(rank));
  const int hi = static_cast<int>(ceil(rank));
  if (n == 0) return qnan();  // uniform across the block
  int less, equal;
  const unsigned long long k_lo = block_select(key, m, lo, &less, &equal);
  unsigned long long k_hi = k_lo;
  if (hi != lo && less + equal <= hi) k_hi = block_min_above(key, m, k_lo);
  return finish(phi, rank, lo, key_value(k_lo), key_value(k_hi), n);
}

__global__ void __launch_bounds__(kBlockThreads)
quantile_block(const double* __restrict__ rolled, int T,
               const int32_t* __restrict__ order,
               const int32_t* __restrict__ starts, int staged, double phi,
               double* __restrict__ out) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_live[kBlockThreads / 32];
  const long long g = blockIdx.x / T;
  const int t = static_cast<int>(blockIdx.x % T);
  const int k0 = starts[g];
  const int m = starts[g + 1] - k0;
  const MemberKeys members{rolled, order + k0, T, t};
  int live = 0;
  for (int i = threadIdx.x; i < m; i += kBlockThreads) {
    const unsigned long long u = members(i);
    if (staged) s_keys[i] = u;
    live += u != kDead;
  }
  for (int o = 16; o > 0; o >>= 1)
    live += __shfl_down_sync(0xffffffffu, live, o);
  if ((threadIdx.x & 31) == 0) s_live[threadIdx.x >> 5] = live;
  __syncthreads();
  int n = 0;
  for (int w = 0; w < kBlockThreads / 32; ++w) n += s_live[w];
  const double q = staged ? quantile_of(StagedKeys{s_keys}, m, n, phi)
                          : quantile_of(members, m, n, phi);
  if (threadIdx.x == 0) out[g * T + t] = q;
}

}  // namespace

extern "C" int vm_quantile_groups(const void* rolled, int T,
                                  const void* order, const void* starts,
                                  long long G, int max_group, double phi,
                                  void* out, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  const int32_t* o = static_cast<const int32_t*>(order);
  const int32_t* s = static_cast<const int32_t*>(starts);
  double* q = static_cast<double*>(out);
  const long long pairs = G * T;
  if (max_group <= 32) {
    const long long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quantile_warp<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                    st>>>(r, T, o, s, G, phi, q);
    return static_cast<int>(cudaGetLastError());
  }
  const int staged = max_group <= kStageMax;
  const size_t smem =
      staged ? static_cast<size_t>(max_group) * sizeof(unsigned long long)
             : 0;
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quantile_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  quantile_block<<<static_cast<unsigned>(pairs), kBlockThreads, smem, st>>>(
      r, T, o, s, staged, phi, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
