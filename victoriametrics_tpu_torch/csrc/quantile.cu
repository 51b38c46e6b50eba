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
// The wrapper plans the path once per (G, T, M) (ops/device_rollup.py:
// quantile_plan) and passes its fields:
//  * M <= 32: quantile_warp, one warp per (group, step).  Lane i holds
//    member i; its position in the stable sort (value, then member order)
//    is the number of members before it, counted over the warp by
//    shuffles, and the lanes at positions lo and hi hold v_lo and v_hi.
//  * larger groups, G x T filling the card: quantile_block, one block per
//    (group, step).  The members' order-preserving 64-bit keys (NaN as the
//    largest key, never selected since lo, hi < n) are staged in shared
//    memory when M <= kStageMax, else read through the layout from global
//    memory, and a radix select (8 passes of 8 bits, warp-aggregated
//    shared-memory histograms) finds the lo-th key; v_hi is the same key
//    when enough keys equal it, else the least larger key.
//  * larger groups over few (group, step) pairs (the instant quantile over
//    every series is one pair): quantile_cluster, a thread-block cluster
//    of up to 16 blocks per pair, on as many SMs.  Member r takes the
//    slice [r * slice, (r + 1) * slice) of the group's members and stages
//    its keys in its own shared memory (up to kStageMax keys a member,
//    else it reads its slice through the layout).  Each radix pass counts
//    the member's own keys into a shared-memory histogram; after a cluster
//    barrier every member sums the members' histograms through distributed
//    shared memory and picks the same digit, so the cluster walks the
//    select of one block over C times the keys.  The histograms are double
//    buffered: one cluster barrier a pass.  The least key above the lo-th
//    is a minimum across the cluster the same way.  The live count n is a
//    cluster sum first, so every branch is uniform across the cluster.
// The interpolation gives +0.0 whichever zero sits at lo or hi, so the keys
// fold -0.0 into +0.0; inf - inf gives NaN as in the reference.  A radix
// select returns the exact key, so every path gives the plain version's
// bits.
//
// Bound: bytes.  The function must read the rolled tile once (8 B per
// (series, step)) and the layout, and write [G, T].  The warp path reads
// each member once; the block and cluster paths re-read staged keys from
// shared memory in their radix passes (global memory past the staging
// limit).  One large group was one block on one SM before the cluster
// path: its passes gathered 100,000 keys through the layout on one SM;
// the cluster spreads them over 16 SMs' shared memory, so launch latency
// and the 11 cluster barriers set its time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "order_stats.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 256;
constexpr int kClusterThreads = 512;
constexpr int kStageMax = 24576;  // keys a block stages (192 KiB)
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kMaxDevices = 64;
enum Path { kWarpPath = 0, kBlockPath = 1, kClusterPath = 2 };

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

// The cluster's radix select: the j-th smallest of the keys of every
// member (key(i), i < mine, the member's own), with *less = #keys below it
// and *equal = #keys equal to it, on every thread of every member.
// block_select's passes (order_stats.cuh), with each pass's histogram
// summed over the members through distributed shared memory.
template <class KeyFn>
__device__ unsigned long long cluster_select(KeyFn key, int mine, int j,
                                             int* less, int* equal) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned hist[2][256];  // this member's, double buffered
  __shared__ unsigned total[256];    // the cluster's
  __shared__ int s_pick[3];
  const int C = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0, mask = 0;
  int below = 0, pass = 0;
  for (int shift = 56; shift >= 0; shift -= 8, ++pass) {
    // hist[pass & 1] was last read in pass - 2, before every member
    // reached the last pass's barrier
    unsigned* h = hist[pass & 1];
    for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
    __syncthreads();
    for (int base = 0; base < mine; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int digit = -1;
      if (i < mine) {
        const unsigned long long u = key(i);
        if ((u & mask) == prefix) digit = static_cast<int>((u >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&h[digit], static_cast<unsigned>(__popc(peers)));
    }
    cluster.sync();  // every member's histogram is complete
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      unsigned sum = 0;
      for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(h, r)[b];
      total[b] = sum;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      unsigned local = 0;
      for (int b = 0; b < 8; ++b) local += total[lane * 8 + b];
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
        while (acc + total[lane * 8 + b] <= want) acc += total[lane * 8 + b++];
        s_pick[0] = lane * 8 + b;
        s_pick[1] = static_cast<int>(acc);
        s_pick[2] = static_cast<int>(total[lane * 8 + b]);
      }
    }
    __syncthreads();
    // total and s_pick are rewritten only after the next pass's cluster
    // barrier, which every thread reaches after these reads
    prefix |= static_cast<unsigned long long>(s_pick[0]) << shift;
    mask |= 0xffULL << shift;
    below += s_pick[1];
    *equal = s_pick[2];
  }
  *less = below;
  return prefix;
}

// The least key above floor_key over every member's keys (kDead when
// none), on every thread of every member.
template <class KeyFn>
__device__ unsigned long long cluster_min_above(
    KeyFn key, int mine, unsigned long long floor_key) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned long long s_warp_min[32];
  __shared__ unsigned long long s_block_min;  // read by the other members
  __shared__ unsigned long long s_min;
  const int C = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  unsigned long long m = kDead;
  for (int i = threadIdx.x; i < mine; i += blockDim.x) {
    const unsigned long long u = key(i);
    if (u > floor_key && u < m) m = u;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_down_sync(0xffffffffu, m, o);
    m = y < m ? y : m;
  }
  if (lane == 0) s_warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
      m = s_warp_min[w] < m ? s_warp_min[w] : m;
    s_block_min = m;
  }
  cluster.sync();
  if (threadIdx.x < 32) {
    m = lane < C ? *cluster.map_shared_rank(&s_block_min, lane) : kDead;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_down_sync(0xffffffffu, m, o);
      m = y < m ? y : m;
    }
    if (lane == 0) s_min = m;
  }
  __syncthreads();
  return s_min;
}

// quantile_of over the keys of every member of the cluster; n, the
// cluster's live count, is the same on every member.
template <class KeyFn>
__device__ double cluster_quantile_of(KeyFn key, int mine, int n,
                                      double phi) {
  const double rank = rank_of(phi, n);
  const int lo = static_cast<int>(floor(rank));
  const int hi = static_cast<int>(ceil(rank));
  if (n == 0) return qnan();  // uniform across the cluster
  int less, equal;
  const unsigned long long k_lo = cluster_select(key, mine, lo, &less, &equal);
  unsigned long long k_hi = k_lo;
  if (hi != lo && less + equal <= hi) k_hi = cluster_min_above(key, mine, k_lo);
  return finish(phi, rank, lo, key_value(k_lo), key_value(k_hi), n);
}

// One cluster of C blocks per (group, step), blocks (pair * C + r); member
// r owns the group's members [r * slice, (r + 1) * slice).
__global__ void __launch_bounds__(kClusterThreads)
quantile_cluster(const double* __restrict__ rolled, int T,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts, int slice, int staged,
                 double phi, double* __restrict__ out) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_warp_live[kClusterThreads / 32];
  __shared__ int s_live;  // this member's, read by the other members
  __shared__ int s_n;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int member = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const long long pair = blockIdx.x / C;
  const long long g = pair / T;
  const int t = static_cast<int>(pair % T);
  const int k0 = starts[g];
  const int m = starts[g + 1] - k0;
  const int b0 = static_cast<int>(
      min(static_cast<long long>(m), static_cast<long long>(member) * slice));
  const int mine = min(m - b0, slice);
  const MemberKeys members{rolled, order + k0 + b0, T, t};
  int live = 0;
  for (int i = threadIdx.x; i < mine; i += kClusterThreads) {
    const unsigned long long u = members(i);
    if (staged) s_keys[i] = u;
    live += u != kDead;
  }
  for (int o = 16; o > 0; o >>= 1)
    live += __shfl_down_sync(0xffffffffu, live, o);
  if (lane == 0) s_warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kClusterThreads / 32; ++w) live += s_warp_live[w];
    s_live = live;
  }
  cluster.sync();  // the members' counts (and staged keys) are in place
  if (threadIdx.x < 32) {
    int n = lane < C ? *cluster.map_shared_rank(&s_live, lane) : 0;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n = s_n;
  const double q = staged
                       ? cluster_quantile_of(StagedKeys{s_keys}, mine, n, phi)
                       : cluster_quantile_of(members, mine, n, phi);
  if (member == 0 && threadIdx.x == 0) out[g * T + t] = q;
  cluster.sync();  // no member leaves while another reads its shared memory
}

// cudaFuncSetAttribute once per device and kernel for the largest dynamic
// shared memory asked so far (the static shared memory counts against the
// default 48 KB too, so any amount is declared)
template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, std::atomic<int>* set, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes == 0 || set[dev].load() >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) set[dev].store(bytes);
  return e;
}

cudaError_t launch_cluster(const double* r, int T, const int32_t* o,
                           const int32_t* s, long long pairs, int cluster,
                           int slice, int staged, double phi, double* q,
                           cudaStream_t st) {
  static std::atomic<int> smem_set[kMaxDevices];
  static std::atomic<int> nonportable_set[kMaxDevices];
  const int smem = staged ? slice * static_cast<int>(sizeof(unsigned long long))
                          : 0;
  cudaError_t e = ensure_smem(quantile_cluster, smem_set, smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!nonportable_set[dev].load()) {
      e = cudaFuncSetAttribute(
          quantile_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      nonportable_set[dev].store(1);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pairs * cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, quantile_cluster, r, T, o, s, slice, staged,
                         phi, q);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The plan's fields (ops/device_rollup.py:quantile_plan): the path, the
// blocks of a (group, step), the keys a block takes (the largest group
// for the block path, a member's slice for the cluster path) and whether
// it stages them in shared memory.
extern "C" int vm_quantile_groups(const void* rolled, int T,
                                  const void* order, const void* starts,
                                  long long G, int path, int cluster,
                                  int slice, int staged, double phi,
                                  void* out, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  const bool bad_cluster =
      path == kClusterPath &&
      (cluster < 2 || cluster > kMaxCluster || (cluster & (cluster - 1)));
  if (path < kWarpPath || path > kClusterPath || bad_cluster || slice < 0 ||
      (staged && slice > kStageMax) ||
      G * T * (path == kClusterPath ? cluster : 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  const int32_t* o = static_cast<const int32_t*>(order);
  const int32_t* s = static_cast<const int32_t*>(starts);
  double* q = static_cast<double*>(out);
  const long long pairs = G * T;
  if (path == kWarpPath) {
    const long long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quantile_warp<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                    st>>>(r, T, o, s, G, phi, q);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == kClusterPath)
    return static_cast<int>(launch_cluster(r, T, o, s, pairs, cluster, slice,
                                           staged, phi, q, st));
  static std::atomic<int> smem_set[kMaxDevices];
  const int smem =
      staged ? slice * static_cast<int>(sizeof(unsigned long long)) : 0;
  const cudaError_t e = ensure_smem(quantile_block, smem_set, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  quantile_block<<<static_cast<unsigned>(pairs), kBlockThreads, smem, st>>>(
      r, T, o, s, staged, phi, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
