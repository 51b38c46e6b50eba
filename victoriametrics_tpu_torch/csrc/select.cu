// B6 topk_select_tile (+ take_rows) and B7 rank_tile: selections over a
// rolled tile [S, T] (the output of B5 rollup_series).
//
// B6 replaces victoriametrics_tpu/ops/device_rollup.py:topk_select_tile,
// whose selection is jax.lax.top_k over the key
// NaN ? -inf : (bottom ? -v : v) for every step: the k best series by key
// in lax.top_k's order, which ranks +0.0 above -0.0 and breaks ties (the
// -inf of NaN rows among them) to the lower series index, plus a NaN flag
// per pick.  The wrapper plans a call once per (S, T, k)
// (ops/device_rollup.py:topk_plan): the path, the cluster size and rows of
// a cluster member, the sort path's chunk, blocks and scratch.  A pick is
// (key, tag), tag = 2 * row + isnan(value): the tags of one step are
// distinct and order as their rows do, so "key descending, then tag
// ascending" is lax.top_k's order whatever order the rows are offered in,
// and the flag rides along.  Two paths:
//  * k <= kRegMax: topk_scan, one launch and no scratch.  A block owns 32
//    steps and a range of rows; the row ranges of one 32-step tile form a
//    thread block cluster.  Rows stream through a ring of shared-memory
//    buffers of 32 rows x 32 steps, filled by 8-byte cp.async (a warp
//    copies 256 contiguous bytes of a row; 16-byte copies would need rows
//    whose byte length is a multiple of 16, and the dashboard's 355 steps
//    are not), kRing - 1 buffers in flight.  Warp w keeps the sorted k-list
//    of 4 steps in registers, slot j in lane j % 32 (two halves for
//    k > 32), with the k-th pick in every lane: each buffer offers a
//    step's 32 rows at once, one per lane, and a row that does not beat
//    the k-th costs a comparison and a vote; the few that do are inserted
//    by shuffles.  After a cluster barrier each member gathers the
//    members' lists of every C-th step (C the cluster size) through
//    distributed shared memory and merges them the same way into idx
//    [T, k] and the NaN flags.
//  * larger k (up to S): the steps go in chunks.  topk_codes transposes a
//    chunk of rolled, read in coalesced [32 rows x 32 steps] tiles through
//    shared memory, into step-major 64-bit codes that order the picks
//    ascending, and NaN flags.  topk_sort then takes one step per block (the
//    plan's blocks walk the chunk), stages the step's
//    contiguous codes in shared memory when they fit, finds the k-th code
//    with block_select (order_stats.cuh), gathers the codes below it in
//    index order and puts them in order with a stable LSD radix sort (8
//    passes of 8 bits), so equal codes keep the lower index first; the
//    remaining slots take the series whose code equals the k-th, lowest
//    index first.  O(S + k) per step.
// take_rows replaces device_rollup.py:take_rows (a row gather in
// jnp.take's fill mode: a negative index counts from the end, one outside
// [-S, S) gives a NaN row): one block per (picked row, kTakeChunk
// doubles), the loads of a thread issued before its stores, 16-byte
// accesses where the source and destination rows share their alignment,
// int32 or int64 indices as the caller has them.
//
// B7 replaces device_rollup.py:rank_tile's statistic: per series, over its
// non-NaN steps, max / min / avg (sum in ascending step order over
// max(n, 1)) / last (the last non-NaN value) / median (NaN as +inf, the
// interpolation a + (pos - j0) (b - a) at pos = 0.5 (n - 1)); NaN where
// n = 0.  max/min/avg/last take one thread per row.  median takes one
// block per row: the row's order-preserving 64-bit keys are staged in
// shared memory when T <= kStageMax (else read from global memory) and a
// radix select (8 passes of 8 bits, warp-aggregated shared-memory
// histograms) finds the j0-th key; the j1-th is the same key when enough
// keys equal it, else the least larger key.  The interpolation's result
// is +0.0 whichever zero sits at j0 or j1, so keys fold -0.0 into +0.0.
//
// Bound: bytes.  B6 must read the rolled tile once (8 B per (series,
// step)) and write [T, k] picks; take_rows reads and writes each picked
// row once; B7 reads the tile once and writes [S]; the radix passes
// re-read the keys staged in scratch or shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"
#include "order_stats.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRegMax = 64;       // largest k of the scan path (K_REG)
constexpr int kScanWarps = 8;     // warps of a scan block
constexpr int kStepsPerWarp = 32 / kScanWarps;
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kRing = 4;          // row buffers of a scan block
constexpr int kBufRows = 32;      // rows of a buffer
constexpr int kBufStride = 33;    // doubles per buffered row (32 steps)
constexpr int kPickBytes = 12;    // a pick in shared memory: key, tag
constexpr uint32_t kNoTag = 0xffffffffu;  // an empty slot: after every pick
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRankThreads = 256;
constexpr int kStageMax = 24576;  // keys staged in shared memory (192 KiB)
constexpr int kTakeThreads = 128;
constexpr int kTakePairs = 2;  // 16-byte accesses a take_rows thread issues
constexpr int kTakeChunk = kTakeThreads * kTakePairs * 2;  // doubles
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double topk_key(double v, int bottom) {
  return v != v ? -INFINITY : (bottom ? -v : v);
}

// a above b in lax.top_k's order: numeric, and +0.0 above -0.0.
__device__ __forceinline__ bool above(double a, double b) {
  if (a == 0.0 && b == 0.0) return !signbit(a) && signbit(b);
  return a > b;
}

// (ka, ta) is picked before (kb, tb): key descending, tag ascending.
__device__ __forceinline__ bool before(double ka, uint32_t ta, double kb,
                                       uint32_t tb) {
  return above(ka, kb) || (!above(kb, ka) && ta < tb);
}

// Dynamic shared memory of a scan block: the ring of row buffers (reused
// for the gathered lists after the scan), then the block's lists [k][32]
// (keys, then tags).
__host__ __device__ inline long long scan_smem_bytes(int k) {
  return static_cast<long long>(kRing) * kBufRows * kBufStride * 8 +
         static_cast<long long>(k) * 32 * kPickBytes;
}

// A warp's sorted list of picks: slot j in lane j % 32 of half j / 32
// (NE halves, k <= 32 * NE), in registers; the slots past k hold what was
// pushed out.  Every lane holds the k-th pick (th_k, th_t).
template <int NE>
__device__ __forceinline__ void list_kth(const double (&key)[NE],
                                         const uint32_t (&tag)[NE], int k,
                                         double& th_k, uint32_t& th_t) {
  const bool high = NE > 1 && k > 32;
  th_k = __shfl_sync(0xffffffffu, high ? key[NE - 1] : key[0], (k - 1) & 31);
  th_t = __shfl_sync(0xffffffffu, high ? tag[NE - 1] : tag[0], (k - 1) & 31);
}

// Insert (c, g), which comes before the k-th pick (warp-uniform).
template <int NE>
__device__ __forceinline__ void list_insert(double (&key)[NE],
                                            uint32_t (&tag)[NE], double c,
                                            uint32_t g, int lane) {
  int pos = 32 * NE;
#pragma unroll
  for (int e = NE - 1; e >= 0; --e) {
    const unsigned m = __ballot_sync(0xffffffffu,
                                     before(c, g, key[e], tag[e]));
    if (m) pos = 32 * e + __ffs(m) - 1;
  }
  // every slot from pos on moves one down; slot pos takes (c, g)
  double carry_k = 0.0;
  uint32_t carry_t = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    double up_k = __shfl_up_sync(0xffffffffu, key[e], 1);
    uint32_t up_t = __shfl_up_sync(0xffffffffu, tag[e], 1);
    const double last_k = __shfl_sync(0xffffffffu, key[e], 31);
    const uint32_t last_t = __shfl_sync(0xffffffffu, tag[e], 31);
    if (lane == 0) {
      up_k = carry_k;
      up_t = carry_t;
    }
    const int slot = 32 * e + lane;
    if (slot > pos) {
      key[e] = up_k;
      tag[e] = up_t;
    } else if (slot == pos) {
      key[e] = c;
      tag[e] = g;
    }
    carry_k = last_k;
    carry_t = last_t;
  }
}

// Whether the offer (key, tag) of a live lane goes before the k-th: a
// numeric comparison, the full order only on equal keys (ties, +-0).
__device__ __forceinline__ bool beats(bool live, double key, uint32_t tag,
                                      double th_k, uint32_t th_t) {
  return live && (key > th_k || (key == th_k && before(key, tag, th_k, th_t)));
}

// Insert the lanes of mask m (their offers beat the k-th when the mask
// was taken), lowest lane first.
template <int NE>
__device__ __forceinline__ void list_take(double (&key)[NE],
                                          uint32_t (&tag)[NE], unsigned m,
                                          double key_l, uint32_t tag_l,
                                          int k, int lane, double& th_k,
                                          uint32_t& th_t) {
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const double c = __shfl_sync(0xffffffffu, key_l, src);
    const uint32_t g = __shfl_sync(0xffffffffu, tag_l, src);
    if (!before(c, g, th_k, th_t)) continue;  // the k-th moved up
    list_insert<NE>(key, tag, c, g, lane);
    list_kth<NE>(key, tag, k, th_k, th_t);
  }
}

// Start buffer b's copies (rows b * kBufRows + w + 8i of the range, this
// lane's step) into its ring slot, then commit a group (empty past the
// last buffer, so that group counts stay aligned).
__device__ __forceinline__ void issue_buffer(double* ring, const double* src,
                                             long long left, int b,
                                             int n_buf, bool step_ok,
                                             int T) {
  if (b < n_buf && step_ok) {
    double* dst = ring + (b % kRing) * kBufRows * kBufStride;
#pragma unroll
    for (int i = 0; i < kBufRows / kScanWarps; ++i)
      if (i * kScanWarps < left)
        copy8_async(dst + i * kScanWarps * kBufStride,
                    src + static_cast<long long>(i) * kScanWarps * T);
  }
  commit_async();
}

// One 32-step tile and one cluster member's rows [member * rows, +rows):
// kBufRows rows at a time stream through a ring of shared-memory buffers
// by cp.async (kRing - 1 buffers in flight); warp w keeps the sorted k-list
// of steps 4w..4w+3 in registers and offers it each buffer's 32 rows of a
// step at once, one row per lane.  Then the cluster merges the members'
// lists through distributed shared memory.
template <int NE>
__global__ void __launch_bounds__(kScanWarps * 32)
topk_scan(const double* __restrict__ rolled, int S, int T, int k, int bottom,
          int rows, int32_t* __restrict__ out_idx,
          uint8_t* __restrict__ out_nan) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int member = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  double* ring = reinterpret_cast<double*>(smem);
  double* bk = ring + kRing * kBufRows * kBufStride;
  uint32_t* bt = reinterpret_cast<uint32_t*>(bk + k * 32);
  const int t0 = static_cast<int>(blockIdx.y) * 32;
  const long long r_begin = static_cast<long long>(member) * rows;
  const long long r_end = min(static_cast<long long>(S), r_begin + rows);
  const int n_buf = r_end > r_begin
      ? static_cast<int>((r_end - r_begin + kBufRows - 1) / kBufRows) : 0;
  // this thread copies rows w + 8i of each buffer at step t0 + lane into
  // ring[slot][w + 8i][lane]
  const bool step_ok = t0 + lane < T;
  double* my_ring = ring + w * kBufStride + lane;
  const double* my_src = rolled + (r_begin + w) * T + t0 + lane;
  const long long buf_src = static_cast<long long>(kBufRows) * T;
  double key[kStepsPerWarp][NE];
  uint32_t tag[kStepsPerWarp][NE];
  double th_k[kStepsPerWarp];
  uint32_t th_t[kStepsPerWarp];
#pragma unroll
  for (int j = 0; j < kStepsPerWarp; ++j) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      key[j][e] = -INFINITY;
      tag[j][e] = kNoTag;
    }
    th_k[j] = -INFINITY;
    th_t[j] = kNoTag;
  }
  for (int b = 0; b < kRing - 1; ++b)
    issue_buffer(my_ring, my_src + b * buf_src,
                 r_end - r_begin - w - static_cast<long long>(b) * kBufRows,
                 b, n_buf, step_ok, T);
  for (int b = 0; b < n_buf; ++b) {
    const int nb = b + kRing - 1;
    issue_buffer(my_ring, my_src + nb * buf_src,
                 r_end - r_begin - w - static_cast<long long>(nb) * kBufRows,
                 nb, n_buf, step_ok, T);
    wait_async<kRing - 1>();
    __syncthreads();
    const double* buf = ring + (b % kRing) * kBufRows * kBufStride;
#pragma unroll
    for (int h = 0; h < kBufRows / 32; ++h) {
      // all steps' votes first (independent), then the few insertions
      const long long r =
          r_begin + static_cast<long long>(b) * kBufRows + h * 32 + lane;
      const bool live = r < r_end;
      double kv[kStepsPerWarp];
      uint32_t tv[kStepsPerWarp];
      unsigned m[kStepsPerWarp];
#pragma unroll
      for (int j = 0; j < kStepsPerWarp; ++j) {
        const double v = buf[(h * 32 + lane) * kBufStride +
                             w * kStepsPerWarp + j];
        kv[j] = topk_key(v, bottom);
        tv[j] = static_cast<uint32_t>((r << 1) | (v != v ? 1 : 0));
        m[j] = __ballot_sync(0xffffffffu,
                             beats(live, kv[j], tv[j], th_k[j], th_t[j]));
      }
#pragma unroll
      for (int j = 0; j < kStepsPerWarp; ++j)
        list_take<NE>(key[j], tag[j], m[j], kv[j], tv[j], k, lane, th_k[j],
                      th_t[j]);
    }
    __syncthreads();  // the buffer may be refilled
  }
  // the block's lists, slot j of step s at [j * 32 + s]
#pragma unroll
  for (int j = 0; j < kStepsPerWarp; ++j) {
    const int s = w * kStepsPerWarp + j;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int slot = 32 * e + lane;
      if (slot < k) {
        bk[slot * 32 + s] = key[j][e];
        bt[slot * 32 + s] = tag[j][e];
      }
    }
  }
  cluster.sync();
  // gather the members' lists of this member's steps member + g * C into
  // the ring: [g][q][slot]
  double* gk = ring;
  uint32_t* gt = reinterpret_cast<uint32_t*>(gk + 32 * k);
  const int ck = C * k;
  const int gathered = (32 / C) * ck;
  for (int i = threadIdx.x; i < gathered; i += blockDim.x) {
    const int g = i / ck;
    const int q = (i - g * ck) / k;
    const int slot = i - g * ck - q * k;
    const int l = member + g * C;
    gk[i] = cluster.map_shared_rank(bk, q)[slot * 32 + l];
    gt[i] = cluster.map_shared_rank(bt, q)[slot * 32 + l];
  }
  cluster.sync();  // no member leaves while another reads its lists
  // one warp per gathered step: the members' lists offered to an empty
  // list; together they hold at least k picks
  for (int g = w; g < 32 / C; g += kScanWarps) {
    const long long t = t0 + member + g * C;
    if (t >= T) continue;
    double mk[NE];
    uint32_t mt[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      mk[e] = -INFINITY;
      mt[e] = kNoTag;
    }
    double th_mk = -INFINITY;
    uint32_t th_mt = kNoTag;
    for (int q = 0; q < C; ++q)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int slot = 32 * e + lane;
        const int i = g * ck + q * k + slot;
        const bool live = slot < k;
        const double ck_l = live ? gk[i] : -INFINITY;
        const uint32_t ct_l = live ? gt[i] : kNoTag;
        list_take<NE>(mk, mt,
                      __ballot_sync(0xffffffffu,
                                    beats(live, ck_l, ct_l, th_mk, th_mt)),
                      ck_l, ct_l, k, lane, th_mk, th_mt);
      }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int slot = 32 * e + lane;
      if (slot < k) {
        out_idx[t * k + slot] = static_cast<int32_t>(mt[e] >> 1);
        out_nan[t * k + slot] = static_cast<uint8_t>(mt[e] & 1);
      }
    }
  }
}

// The pick code of a value: ascending codes are lax.top_k's order of the
// key NaN ? -inf : (bottom ? -v : v), best first, +0.0 before -0.0.
__device__ __forceinline__ unsigned long long pick_code(double v,
                                                        int bottom) {
  const unsigned long long u = static_cast<unsigned long long>(
      __double_as_longlong(topk_key(v, bottom)));
  return (u >> 63) ? u : ~(u | 0x8000000000000000ULL);
}

// One [32 rows x 32 steps] tile of a chunk of steps [t0, t0 + steps):
// coalesced reads of rolled's rows, coalesced writes of the step-major
// codes[s * S + r] and flags[s * S + r].
__global__ void __launch_bounds__(256)
topk_codes(const double* __restrict__ rolled, int S, int T, int t0, int steps,
           int bottom, unsigned long long* __restrict__ codes,
           uint8_t* __restrict__ flags) {
  __shared__ double tile[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * 32;
  const int s0 = static_cast<int>(blockIdx.y) * 32;
  for (int i = ty; i < 32; i += 8) {
    const long long r = r0 + i;
    const int s = s0 + tx;
    tile[i][tx] = r < S && s < steps ? __ldg(rolled + r * T + t0 + s) : 0.0;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const long long s = s0 + i;
    const long long r = r0 + tx;
    if (s < steps && r < S) {
      const double v = tile[tx][i];
      codes[s * S + r] = pick_code(v, bottom);
      flags[s * S + r] = v != v;
    }
  }
}

// A flag's rank among the set flags of the lower threads of the block,
// and (*total) the block's count.
__device__ int block_rank(bool f, int* total) {
  __shared__ int s_warp[kSortWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, f);
  if (lane == 0) s_warp[w] = __popc(b);
  __syncthreads();
  int before = __popc(b & ((1u << lane) - 1u));
  int tot = 0;
  for (int q = 0; q < kSortWarps; ++q) {
    if (q < w) before += s_warp[q];
    tot += s_warp[q];
  }
  __syncthreads();
  *total = tot;
  return before;
}

// Stable LSD radix sort of n (code, index) pairs by code, 8 passes of 8
// bits between (ak, ai) and (bk, bi); the result ends in (ak, ai).  A
// chunk of kSortThreads pairs scatters in thread order: a pair's slot is
// its digit's base, plus the same digit's count in the lower warps of
// the chunk, plus its rank among its warp's peers.
__device__ void block_sort(unsigned long long* ak, int32_t* ai,
                           unsigned long long* bk, int32_t* bi, int n) {
  __shared__ unsigned s_base[256];
  __shared__ unsigned s_wc[kSortWarps][256];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int b = threadIdx.x; b < kSortWarps * 256; b += kSortThreads)
    (&s_wc[0][0])[b] = 0;
  for (int shift = 0; shift < 64; shift += 8) {
    for (int b = threadIdx.x; b < 256; b += kSortThreads) s_base[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kSortThreads)
      atomicAdd(&s_base[(ak[i] >> shift) & 255], 1u);
    __syncthreads();
    if (threadIdx.x < 32) {  // exclusive scan of the 256 digit counts
      unsigned local = 0;
      for (int b = 0; b < 8; ++b) local += s_base[lane * 8 + b];
      unsigned incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      unsigned run = incl - local;
      for (int b = 0; b < 8; ++b) {
        const unsigned c = s_base[lane * 8 + b];
        s_base[lane * 8 + b] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int base = 0; base < n; base += kSortThreads) {
      const int i = base + threadIdx.x;
      const bool valid = i < n;
      unsigned long long key = 0;
      int32_t idx = 0;
      int digit = -1;
      if (valid) {
        key = ak[i];
        idx = ai[i];
        digit = static_cast<int>((key >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (valid && lane == __ffs(peers) - 1)
        s_wc[w][digit] = static_cast<unsigned>(__popc(peers));
      __syncthreads();
      if (valid) {
        unsigned slot = s_base[digit] + __popc(peers & lt_mask);
        for (int q = 0; q < w; ++q) slot += s_wc[q][digit];
        bk[slot] = key;
        bi[slot] = idx;
      }
      __syncthreads();
      for (int b = threadIdx.x; b < 256; b += kSortThreads) {
        unsigned c = 0;
        for (int q = 0; q < kSortWarps; ++q) {
          c += s_wc[q][b];
          s_wc[q][b] = 0;
        }
        s_base[b] += c;
      }
      __syncthreads();
    }
    unsigned long long* tk = ak;
    ak = bk;
    bk = tk;
    int32_t* ti = ai;
    ai = bi;
    bi = ti;
  }
}

// Scratch of the sort path: a chunk's codes and flags, then each sort
// block's two (code, index) buffers of k pairs.
__host__ __device__ inline long long round256(long long b) {
  return (b + 255) / 256 * 256;
}
__host__ __device__ inline long long pair_bytes(int k) {
  return round256(24LL * k);
}
__host__ __device__ inline long long sort_scratch_bytes(long long S,
                                                        int chunk, int k,
                                                        int blocks) {
  return round256(8LL * chunk * S) + round256(1LL * chunk * S) +
         blocks * pair_bytes(k);
}

// One step per block over a chunk's codes; `staged`: the step's S codes
// fit the block's dynamic shared memory.
__global__ void __launch_bounds__(kSortThreads)
topk_sort(const unsigned long long* __restrict__ codes,
          const uint8_t* __restrict__ flags, int S, int t0, int steps, int k,
          int staged, unsigned char* __restrict__ pairs,
          int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_nan) {
  extern __shared__ unsigned long long s_codes[];
  unsigned char* mine = pairs + blockIdx.x * pair_bytes(k);
  unsigned long long* ak = reinterpret_cast<unsigned long long*>(mine);
  unsigned long long* bk = ak + k;
  int32_t* ai = reinterpret_cast<int32_t*>(bk + k);
  int32_t* bi = ai + k;
  for (int s = blockIdx.x; s < steps; s += gridDim.x) {
    const unsigned long long* cs = codes + static_cast<long long>(s) * S;
    const uint8_t* fs = flags + static_cast<long long>(s) * S;
    if (staged) {
      for (int i = threadIdx.x; i < S; i += kSortThreads) s_codes[i] = cs[i];
      __syncthreads();
      cs = s_codes;
    }
    const long long t = t0 + s;
    int less, equal;
    const unsigned long long kth =
        block_select(StagedKeys{cs}, S, k - 1, &less, &equal);
    const int ties = k - less;  // slots left for codes equal to the k-th
    int n_less = 0, n_tie = 0;
    for (int base = 0; base < S; base += kSortThreads) {
      const int i = base + threadIdx.x;
      const unsigned long long c = i < S ? cs[i] : 0;
      const bool lt = i < S && c < kth;
      const bool eq = i < S && c == kth;
      int tot_lt, tot_eq;
      const int r_lt = block_rank(lt, &tot_lt);
      const int r_eq = block_rank(eq, &tot_eq);
      if (lt) {
        ak[n_less + r_lt] = c;
        ai[n_less + r_lt] = i;
      }
      if (eq && n_tie + r_eq < ties) {
        const long long o = t * k + less + n_tie + r_eq;
        out_idx[o] = i;
        out_nan[o] = fs[i];
      }
      n_less += tot_lt;
      n_tie += tot_eq;
    }
    __syncthreads();
    block_sort(ak, ai, bk, bi, less);
    for (int j = threadIdx.x; j < less; j += kSortThreads) {
      const long long o = t * k + j;
      const int32_t i = ai[j];
      out_idx[o] = i;
      out_nan[o] = fs[i];
    }
    __syncthreads();
  }
}

// One block per (picked row m, chunk c of kTakeChunk doubles), the chunks
// of a row on consecutive blocks: every thread issues its kTakePairs loads
// before its stores.
template <class Idx>
__global__ void __launch_bounds__(kTakeThreads)
take_rows_kernel(const double* __restrict__ rolled, long long S, int T,
                 int chunks, const Idx* __restrict__ sel,
                 double* __restrict__ out) {
  const long long m = blockIdx.x / chunks;
  const int c = static_cast<int>(blockIdx.x - m * chunks);
  long long r = static_cast<long long>(sel[m]);
  if (r < 0) r += S;  // from the end, as jnp.take
  double* dst = out + m * T;
  const int c0 = c * kTakeChunk;
  if (r < 0 || r >= S) {
#pragma unroll
    for (int u = 0; u < 2 * kTakePairs; ++u) {
      const int i = c0 + u * kTakeThreads + threadIdx.x;
      if (i < T) dst[i] = qnan();
    }
    return;
  }
  const double* src = rolled + r * T;
  // doubles before each row's first 16-byte boundary (0 or 1)
  const int hs = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
  const int hd = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 3) & 1);
  if (hs != hd) {  // 8-byte accesses
    double v[2 * kTakePairs];
#pragma unroll
    for (int u = 0; u < 2 * kTakePairs; ++u) {
      const int i = c0 + u * kTakeThreads + threadIdx.x;
      if (i < T) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < 2 * kTakePairs; ++u) {
      const int i = c0 + u * kTakeThreads + threadIdx.x;
      if (i < T) dst[i] = v[u];
    }
    return;
  }
  // 16-byte accesses over the aligned body: pair q is doubles hs + 2q and
  // hs + 2q + 1; the first chunk's block also copies the head and tail
  const int n2 = (T - hs) >> 1;
  const double2* s2 = reinterpret_cast<const double2*>(src + hs);
  double2* d2 = reinterpret_cast<double2*>(dst + hs);
  const int q0 = c * (kTakeChunk / 2);
  double2 v[kTakePairs];
#pragma unroll
  for (int u = 0; u < kTakePairs; ++u) {
    const int q = q0 + u * kTakeThreads + threadIdx.x;
    if (q < n2) v[u] = __ldg(s2 + q);
  }
#pragma unroll
  for (int u = 0; u < kTakePairs; ++u) {
    const int q = q0 + u * kTakeThreads + threadIdx.x;
    if (q < n2) d2[q] = v[u];
  }
  if (c == 0 && threadIdx.x == 0 && hs) dst[0] = src[0];
  if (c == 0 && threadIdx.x == kTakeThreads - 1 && hs + 2 * n2 < T)
    dst[T - 1] = src[T - 1];
}

// cudaFuncSetAttribute once per device for what a launch needs: the
// largest dynamic shared memory asked so far, and clusters above 8
std::atomic<int> g_sort_smem[kMaxDevices];

template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, std::atomic<int>* set, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || set[dev].load() >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) set[dev].store(bytes);
  return e;
}

template <class Kernel>
cudaError_t ensure_nonportable(Kernel kernel, std::atomic<int>* set,
                               int cluster) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cluster <= 8 || set[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) set[dev].store(1);
  return e;
}

// topk_scan<NE> for k <= 32 * NE, with its attributes set once per device
template <int NE>
cudaError_t launch_scan(const double* r, int S, int T, int k, int bottom,
                        int cluster, int rows, int32_t* oi, uint8_t* on,
                        cudaStream_t st) {
  static std::atomic<int> smem_set[kMaxDevices];
  static std::atomic<int> nonportable_set[kMaxDevices];
  const int smem = static_cast<int>(scan_smem_bytes(k));
  cudaError_t e = ensure_smem(topk_scan<NE>, smem_set, smem);
  if (e == cudaSuccess)
    e = ensure_nonportable(topk_scan<NE>, nonportable_set, cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster),
                     static_cast<unsigned>((T + 31) / 32));
  cfg.blockDim = dim3(kScanWarps * 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, topk_scan<NE>, r, S, T, k, bottom, rows, oi,
                         on);
  return e != cudaSuccess ? e : cudaGetLastError();
}

enum Kind { kMax = 0, kMin = 1, kAvg = 2, kMedian = 3, kLast = 4 };

// One thread per row: max / min / avg / last over the non-NaN steps.
__global__ void __launch_bounds__(128)
rank_simple(const double* __restrict__ rolled, long long S, int T, int kind,
            double* __restrict__ rank) {
  const long long s = static_cast<long long>(blockIdx.x) * 128 + threadIdx.x;
  if (s >= S) return;
  const double* row = rolled + s * T;
  int n = 0;
  double r = kind == kMin ? INFINITY : (kind == kMax ? -INFINITY : 0.0);
  for (int t = 0; t < T; ++t) {
    const double v = row[t];
    if (v != v) continue;
    ++n;
    if (kind == kMax) r = v > r ? v : r;
    else if (kind == kMin) r = v < r ? v : r;
    else if (kind == kAvg) r += v;
    else r = v;  // last
  }
  if (kind == kAvg) r = r / static_cast<double>(n > 1 ? n : 1);
  rank[s] = n == 0 ? qnan() : r;
}

__device__ int block_count(bool x) {
  __shared__ int s_cnt[32];
  int c = __popc(__ballot_sync(0xffffffffu, x));
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    total += s_cnt[w];
  __syncthreads();
  return total;
}

struct RowKeys {  // a rolled row, NaN as +inf
  const double* row;
  __device__ unsigned long long operator()(int i) const {
    const double v = row[i];
    return order_key(v != v ? INFINITY : v);
  }
};

// The median of one row from its keys; n = non-NaN steps.
template <class KeyFn>
__device__ double median_of(KeyFn key, int T, int n) {
  const int nm1 = n - 1 > 0 ? n - 1 : 0;
  const double pos = 0.5 * static_cast<double>(nm1);
  const int j0 = static_cast<int>(floor(pos));
  const int j1 = j0 + 1 < nm1 ? j0 + 1 : nm1;
  int less, equal;
  const unsigned long long k0 = block_select(key, T, j0, &less, &equal);
  unsigned long long k1 = k0;
  if (j1 != j0 && less + equal <= j1) k1 = block_min_above(key, T, k0);
  const double a = key_value(k0);
  const double b = key_value(k1);
  return a + (pos - static_cast<double>(j0)) * (b - a);
}

__global__ void __launch_bounds__(kRankThreads)
rank_median(const double* __restrict__ rolled, int T, int staged,
            double* __restrict__ rank) {
  extern __shared__ unsigned long long s_stage[];
  const long long s = blockIdx.x;
  const double* row = rolled + s * T;
  int live = 0;
  for (int base = 0; base < T; base += kRankThreads) {
    const int t = base + threadIdx.x;
    const double v = t < T ? row[t] : qnan();
    if (staged && t < T) s_stage[t] = order_key(v != v ? INFINITY : v);
    live += block_count(v == v);
  }
  double r;
  if (staged) r = median_of(StagedKeys{s_stage}, T, live);
  else r = median_of(RowKeys{row}, T, live);
  if (threadIdx.x == 0) rank[s] = live == 0 ? qnan() : r;
}

}  // namespace

// B6 with the wrapper's plan: cluster and rows for k <= kRegMax (one
// launch, no scratch); chunk, blocks and the scratch (of
// sort_scratch_bytes) otherwise.
extern "C" int vm_topk_select(const void* rolled, long long S, int T, int k,
                              int bottom, int cluster, long long rows,
                              int chunk, int blocks, void* scratch,
                              long long scratch_bytes, void* out_idx,
                              void* out_nan, void* stream) {
  if (S <= 0 || T <= 0 || k <= 0 || k > S || S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  uint8_t* on = static_cast<uint8_t*>(out_nan);
  const int s32 = static_cast<int>(S);
  if (k <= kRegMax) {
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
        rows < 1 || rows * cluster < S || rows > S)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows32 = static_cast<int>(rows);
    return static_cast<int>(
        k <= 32 ? launch_scan<1>(r, s32, T, k, bottom, cluster, rows32, oi,
                                 on, st)
                : launch_scan<2>(r, s32, T, k, bottom, cluster, rows32, oi,
                                 on, st));
  }
  if (chunk < 1 || chunk > T || chunk > 65535 * 32 || blocks < 1 ||
      scratch_bytes < sort_scratch_bytes(S, chunk, k, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned long long* codes = reinterpret_cast<unsigned long long*>(base);
  uint8_t* flags = base + round256(8LL * chunk * S);
  unsigned char* pairs = flags + round256(1LL * chunk * S);
  const int staged = S <= kStageMax;
  const int smem = staged ? s32 * 8 : 0;
  const cudaError_t e = ensure_smem(topk_sort, g_sort_smem, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int steps = chunk < T - t0 ? chunk : T - t0;
    const dim3 grid(static_cast<unsigned>((S + 31) / 32),
                    static_cast<unsigned>((steps + 31) / 32));
    topk_codes<<<grid, 256, 0, st>>>(r, s32, T, t0, steps, bottom, codes,
                                     flags);
    const int nb = blocks < steps ? blocks : steps;
    topk_sort<<<static_cast<unsigned>(nb), kSortThreads,
                static_cast<size_t>(smem), st>>>(
        codes, flags, s32, t0, steps, k, staged, pairs, oi, on);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  return 0;
}

// take_rows with int64 (idx64 = 1) or int32 indices.
extern "C" int vm_take_rows(const void* rolled, long long S, int T,
                            const void* sel, long long M, int idx64,
                            void* out, void* stream) {
  if (M <= 0 || T <= 0) return 0;
  const int chunks = (T + kTakeChunk - 1) / kTakeChunk;
  if (M * chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  double* o = static_cast<double*>(out);
  const unsigned grid = static_cast<unsigned>(M * chunks);
  if (idx64)
    take_rows_kernel<<<grid, kTakeThreads, 0, st>>>(
        r, S, T, chunks, static_cast<const int64_t*>(sel), o);
  else
    take_rows_kernel<<<grid, kTakeThreads, 0, st>>>(
        r, S, T, chunks, static_cast<const int32_t*>(sel), o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vm_rank_rows(const void* rolled, long long S, int T, int kind,
                            void* rank, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  double* out = static_cast<double*>(rank);
  if (kind != kMedian) {
    rank_simple<<<static_cast<unsigned>((S + 127) / 128), 128, 0, st>>>(
        r, S, T, kind, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int staged = T <= kStageMax;
  const size_t smem =
      staged ? static_cast<size_t>(T) * sizeof(unsigned long long) : 0;
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_median, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rank_median<<<static_cast<unsigned>(S), kRankThreads, smem, st>>>(
      r, T, staged, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
