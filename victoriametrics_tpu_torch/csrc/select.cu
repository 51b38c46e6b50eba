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
// non-NaN steps, max / min / avg (the sum over max(n, 1)) / last (the
// last non-NaN value) / median (NaN as +inf, the interpolation a + (pos -
// j0) (b - a) at pos = 0.5 (n - 1)); NaN where n = 0.  max/min/avg/last
// take a warp per row (rank_simple): coalesced 32-step loads, a lane's
// steps folded in order and the lanes by shuffles (avg a tree sum, within
// rtol 1e-12 of the serial one), last by a ballot from the row's end.
// The median takes the wrapper's plan (ops/device_rollup.rank_plan): a
// warp per row, several rows a block, for short rows (the dashboard's
// 355 steps); a block per row for long ones (5761 at full width); a block
// per row reading global memory above kStageMax steps.  The row is staged
// by 8-byte cp.async (rows are 8-byte aligned only), each thread turning
// the values it copied into order-preserving 64-bit keys and counting the
// live ones and their least and greatest key in registers, one reduction
// a row.  A radix select (select_pair) then runs passes of 256 digits
// over the candidates' key range [lo, hi], digit (key - lo) >> shift with
// the least shift that spans it (the first pass spreads the live keys
// over every bin), each pass's histogram built in a private one per warp;
// once the keys of the buckets holding j0 and j1 number at most the
// team's threads, they are compacted into shared memory and ranked one a
// thread, which gives j0 and j1 both.  A row of distinct rates gets there
// in one or two passes; a pass that splits nothing narrows the range to
// the candidates' own, so a run of ties ends at once; a j1 that starts
// the bucket after a large j0 bucket is the least key above j0's (one
// more read).  The
// interpolation's result is +0.0 whichever zero sits at j0 or j1, so keys
// fold -0.0 into +0.0, and the selected keys are those of the plain sort:
// the same bits.
//
// Bound: bytes.  B6 must read the rolled tile once (8 B per (series,
// step)) and write [T, k] picks; take_rows reads and writes each picked
// row once; B7 reads the tile once and writes [S]; the radix passes
// re-read the keys staged in scratch or shared memory (B7's global path
// re-reads the row).

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
// the median's paths (RANK_WARP, RANK_BLOCK, RANK_GLOBAL in
// ops/device_rollup.py, chosen by rank_plan)
enum RankPath { kRankWarp = 0, kRankBlock = 1, kRankGlobal = 2 };
constexpr int kRankWarps = kRankThreads / 32;  // rows a warp-path block
constexpr int kHistBins = 256;                 // a radix pass's digits

// Diagnostic builds (tools/select_timing.py, -DVM_B7_STOP=k) end the
// median after phase k: 1 the staging (rank = live count), 2 the radix
// passes (rank = the selected prefix's value).
#ifndef VM_B7_STOP
#define VM_B7_STOP 0
#endif

// A warp per row: max / min / avg / last over the non-NaN steps.  The
// row is read 128 steps at a time, 32 consecutive doubles a load; a lane
// folds its steps in ascending order, then the lanes fold by shuffles
// (avg's sum is a tree, as jnp.sum's is); last is the highest set lane
// of a ballot of the non-NaN flags, from the row's end.
__global__ void __launch_bounds__(kRankThreads)
rank_simple(const double* __restrict__ rolled, long long S, int T, int kind,
            double* __restrict__ rank) {
  const long long s =
      static_cast<long long>(blockIdx.x) * kRankWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  if (s >= S) return;  // uniform across the warp
  const double* row = rolled + s * T;
  if (kind == kLast) {
    for (int base = (T - 1) / 32 * 32; base >= 0; base -= 32) {
      const int t = base + lane;
      const double v = t < T ? row[t] : qnan();
      const unsigned live = __ballot_sync(full, v == v);
      if (live != 0u) {  // uniform across the warp
        const double r = __shfl_sync(full, v, 31 - __clz(live));
        if (lane == 0) rank[s] = r;
        return;
      }
    }
    if (lane == 0) rank[s] = qnan();
    return;
  }
  int n = 0;
  double r = kind == kMin ? INFINITY : (kind == kMax ? -INFINITY : 0.0);
  for (int base = 0; base < T; base += 128) {
    double v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = base + 32 * k + lane;
      v[k] = t < T ? row[t] : qnan();
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v[k] != v[k]) continue;
      ++n;
      if (kind == kMax) r = v[k] > r ? v[k] : r;
      else if (kind == kMin) r = v[k] < r ? v[k] : r;
      else r += v[k];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    n += __shfl_xor_sync(full, n, o);
    const double y = __shfl_xor_sync(full, r, o);
    if (kind == kMax) r = y > r ? y : r;
    else if (kind == kMin) r = y < r ? y : r;
    else r += y;
  }
  if (lane == 0) {
    if (kind == kAvg) r = r / static_cast<double>(n > 1 ? n : 1);
    rank[s] = n == 0 ? qnan() : r;
  }
}

// The shared state of one row's median, for a team of NT threads: a warp
// (NT = 32, the warp path) or a block (NT = kRankThreads).
template <int NT>
struct Team {
  static constexpr int kWarps = NT / 32;
  unsigned hist[kWarps][kHistBins];  // a private histogram per warp
  unsigned long long cand[NT];       // the candidates around j0 and j1
  unsigned long long cand2[32];      // ... narrowed again (a block)
  unsigned long long red_min[kWarps], red_max[kWarps];
  int red_live[kWarps];
  unsigned warp_tot[kWarps];
  // j0's bucket, the keys before it, the keys in it; j1's bucket, every
  // candidate, the keys in j1's bucket
  int pick[6];
  int n_cand, n_cand2;
  unsigned long long key0, key1;
};

template <int NT>
__device__ __forceinline__ void team_sync() {
  if (NT == 32) __syncwarp();
  else __syncthreads();
}

// The exclusive prefix sum of x over the team's threads in order.
template <int NT>
__device__ __forceinline__ unsigned team_excl_scan(unsigned x,
                                                   Team<NT>& tm) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += y;
  }
  if (NT == 32) return incl - x;
  const int w = threadIdx.x >> 5;
  if (lane == 31) tm.warp_tot[w] = incl;
  __syncthreads();
  unsigned off = 0;
  for (int k = 0; k < w; ++k) off += tm.warp_tot[k];
  return off + incl - x;
}

// A row's keys from global memory (T > kStageMax): NaN as +inf.
struct RowKeys {
  const double* row;
  __device__ unsigned long long operator()(int i) const {
    const double v = row[i];
    return order_key(v != v ? INFINITY : v);
  }
};

// The least key above `floor` among the team's nk keys (the exact path of
// a median whose j0 and j1 lie in two large buckets).
template <int NT, class KeyFn>
__device__ unsigned long long team_min_above(KeyFn key, int nk,
                                             unsigned long long floor,
                                             Team<NT>& tm, int tid) {
  unsigned long long m = kDead;
  for (int i = tid; i < nk; i += NT) {
    const unsigned long long u = key(i);
    if (u > floor && u < m) m = u;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, m, o);
    m = y < m ? y : m;
  }
  if (NT == 32) return m;
  if ((threadIdx.x & 31) == 0) tm.red_min[threadIdx.x >> 5] = m;
  __syncthreads();
  m = tm.red_min[0];
  for (int w = 1; w < Team<NT>::kWarps; ++w)
    m = tm.red_min[w] < m ? tm.red_min[w] : m;
  return m;
}

// The least and greatest of the team's (mn, mx), on every thread.
template <int NT>
__device__ __forceinline__ void team_minmax(unsigned long long* mn,
                                            unsigned long long* mx,
                                            Team<NT>& tm) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_xor_sync(0xffffffffu, *mn, o);
    const unsigned long long b = __shfl_xor_sync(0xffffffffu, *mx, o);
    *mn = a < *mn ? a : *mn;
    *mx = b > *mx ? b : *mx;
  }
  if (NT == 32) return;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    tm.red_min[w] = *mn;
    tm.red_max[w] = *mx;
  }
  __syncthreads();
  for (int k = 0; k < Team<NT>::kWarps; ++k) {
    *mn = tm.red_min[k] < *mn ? tm.red_min[k] : *mn;
    *mx = tm.red_max[k] > *mx ? tm.red_max[k] : *mx;
  }
  __syncthreads();  // red_min / red_max are rewritten next
}

// A radix select's state: the candidates are the keys in [lo, hi],
// `below` keys lie under lo, and the wanted ranks are want0 <= want1
// (want1 = want0 once j1 is left to the exact path, min_above).  done:
// k0 and k1 are found.
struct Select {
  unsigned long long lo, hi, k0, k1;
  unsigned below, want0, want1;
  bool min_above, done;
};

// Radix passes over the team's nk keys key(i) until the keys of the
// buckets holding want0 and want1 (one bucket, or two neighbouring ones)
// are at most `limit` (then [lo, hi] is their range), or k0 and k1 are
// found.  A pass takes 256 digits (k - lo) >> shift with the least shift
// that spans [lo, hi], so the first one spreads the live keys over every
// bin whatever their magnitudes (rates in [1, 2.2] share their sign and
// most of their exponent), each histogram built in a private one per
// warp.  A pass that leaves every candidate in one bucket narrows to the
// candidates' own least and greatest key, so a run of ties ends at once.
// `ncand`: the candidates, at most.
template <int NT, class KeyFn>
__device__ void narrow(KeyFn key, int nk, int ncand, int limit, Select& s,
                       Team<NT>& tm, int tid, int wid) {
  constexpr int kBins = kHistBins / NT;  // bins a thread totals
  while (ncand > limit) {
    const unsigned long long lo = s.lo, hi = s.hi;
    const int shift = max(0, 56 - __clzll(static_cast<long long>(hi - lo)));
    unsigned long long cmin = kDead, cmax = 0;
    for (int i = tid; i < nk; i += NT) {
      const unsigned long long k = key(i);
      if (k >= lo && k <= hi) {
        atomicAdd(&tm.hist[wid][static_cast<int>((k - lo) >> shift)], 1u);
        cmin = k < cmin ? k : cmin;
        cmax = k > cmax ? k : cmax;
      }
    }
    team_sync<NT>();
    unsigned c[kBins];
    unsigned tot = 0;
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      const int b = tid * kBins + q;
      c[q] = 0;
      for (int w = 0; w < Team<NT>::kWarps; ++w) {
        c[q] += tm.hist[w][b];
        tm.hist[w][b] = 0;
      }
      tot += c[q];
    }
    const unsigned excl = team_excl_scan<NT>(tot, tm);
    if (tid == NT - 1) tm.pick[4] = static_cast<int>(excl + tot);
    const unsigned r0 = s.want0 - s.below, r1 = s.want1 - s.below;
    if (r0 >= excl && r0 < excl + tot) {
      unsigned acc = excl;
      int q = 0;
      while (acc + c[q] <= r0) acc += c[q++];
      tm.pick[0] = tid * kBins + q;
      tm.pick[1] = static_cast<int>(acc);
      tm.pick[2] = static_cast<int>(c[q]);
    }
    if (r1 >= excl && r1 < excl + tot) {
      unsigned acc = excl;
      int q = 0;
      while (acc + c[q] <= r1) acc += c[q++];
      tm.pick[3] = tid * kBins + q;
      tm.pick[5] = static_cast<int>(c[q]);
    }
    team_sync<NT>();
    const int b0 = tm.pick[0], acc0 = tm.pick[1], cnt0 = tm.pick[2];
    const int b1 = tm.pick[3], cnt1 = tm.pick[5], total = tm.pick[4];
    if (cnt0 == total) {  // nothing split: the candidates' own range
      team_minmax<NT>(&cmin, &cmax, tm);
      if (cmin == cmax) {  // a run of ties
        s.k0 = s.k1 = cmin;
        s.done = true;
        return;
      }
      s.lo = cmin;
      s.hi = cmax;
      ncand = total;
      continue;
    }
    // bucket b's keys: lo + (b << shift) .. lo + last(b), within hi
    const auto last = [&](int b) {
      const unsigned long long off =
          (static_cast<unsigned long long>(b) << shift) +
          ((1ULL << shift) - 1);
      return off >= hi - lo ? hi : lo + off;
    };
    s.lo = lo + (static_cast<unsigned long long>(b0) << shift);
    s.below += static_cast<unsigned>(acc0);
    if ((b0 == b1 ? cnt0 : cnt0 + cnt1) <= limit) {  // j0's and j1's keys
      s.hi = last(b1);
      return;
    }
    if (b0 != b1) {  // j0 ends its bucket, j1 starts the next: exact path
      s.min_above = true;
      s.want1 = s.want0;
    }
    s.hi = last(b0);
    ncand = cnt0;
    if (shift == 0) {  // a bucket of one key
      s.k0 = s.k1 = s.lo;
      s.done = true;
      return;
    }
  }
}

// The team's keys key(i), i < nk, within [s.lo, s.hi] (at most NT of
// them) into `out`, in any order; returns their count.
template <int NT, class KeyFn>
__device__ int compact(KeyFn key, int nk, const Select& s,
                       unsigned long long* out, int* count) {
  for (int i = threadIdx.x % NT; i < nk; i += NT) {
    const unsigned long long k = key(i);
    if (k >= s.lo && k <= s.hi) out[atomicAdd(count, 1)] = k;
  }
  team_sync<NT>();
  return *count;
}

// The j0-th and j1-th smallest of the team's nk keys (j1 - j0 <= 1),
// whose live keys lie in [kmin, kmax], kmin < kmax: narrow until the
// keys around them are at most NT, compact those into shared memory; on
// a block, narrow those (one key a thread) until at most 32 and compact
// again; then each of the last candidates is ranked by one thread, which
// gives j0 and j1 both.  A j1 that starts the bucket after a large j0
// bucket is the least key above j0's (a read of every key).
template <int NT, class KeyFn>
__device__ void select_pair(KeyFn key, int nk, unsigned j0, unsigned j1,
                            unsigned long long kmin, unsigned long long kmax,
                            Team<NT>& tm, int tid, int wid,
                            unsigned long long* k0, unsigned long long* k1) {
  Select s{kmin, kmax, 0, 0, 0, j0, j1, false, false};
  narrow<NT>(key, nk, nk, NT, s, tm, tid, wid);
#if VM_B7_STOP == 2
  *k0 = *k1 = s.done ? s.k0 : s.lo;
  return;
#endif
  if (!s.done) {
    const unsigned long long* last = tm.cand;
    int m = compact<NT>(key, nk, s, tm.cand, &tm.n_cand);
    if (NT > 32 && m > 32) {
      narrow<NT>(StagedKeys{tm.cand}, m, m, 32, s, tm, tid, wid);
      if (!s.done) {
        m = compact<NT>(StagedKeys{tm.cand}, m, s, tm.cand2, &tm.n_cand2);
        last = tm.cand2;
      }
    }
    if (!s.done) {
      const unsigned w0 = s.want0 - s.below, w1 = s.want1 - s.below;
      if (tid < m) {  // this thread's candidate's place among them
        const unsigned long long k = last[tid];
        unsigned r = 0;
        for (int q = 0; q < m; ++q) {
          const unsigned long long y = last[q];
          r += y < k || (y == k && q < tid);
        }
        if (r == w0) tm.key0 = k;
        if (r == w1) tm.key1 = k;
      }
      team_sync<NT>();
      s.k0 = tm.key0;
      s.k1 = tm.key1;
    }
  }
  *k0 = s.k0;
  *k1 = s.min_above ? team_min_above<NT>(key, nk, s.k0, tm, tid) : s.k1;
}

// The median of one row by a team (a warp, or a block): the row's T
// values staged into `keys` by 8-byte cp.async (rows are 8-byte aligned
// only) and turned into keys in place by the thread that copied them,
// which counts its live steps and their least and greatest key in
// registers (one reduction), then select_pair over the staged keys.  With
// keys == nullptr (T > kStageMax) the passes read the row from global
// memory.  Returns the interpolation a + (pos - j0) (b - a) at pos = 0.5
// (n - 1), NaN where n = 0, on every thread.
template <int NT>
__device__ double median_row(const double* __restrict__ row, int T,
                             unsigned long long* keys, Team<NT>& tm,
                             int tid, int wid) {
  const unsigned full = 0xffffffffu;
  for (int b = tid; b < Team<NT>::kWarps * kHistBins; b += NT)
    (&tm.hist[0][0])[b] = 0;
  if (tid == 0) tm.n_cand = tm.n_cand2 = 0;
  int live = 0;
  unsigned long long kmin = kDead, kmax = 0;
  if (keys != nullptr) {
    for (int t = tid; t < T; t += NT) copy8_async(keys + t, row + t);
    commit_async();
    wait_async<0>();
  }
  for (int t = tid; t < T; t += NT) {
    const double v = keys != nullptr
                         ? __longlong_as_double(static_cast<long long>(keys[t]))
                         : row[t];
    const unsigned long long k = order_key(v != v ? INFINITY : v);
    if (keys != nullptr) keys[t] = k;
    if (v == v) {
      ++live;
      kmin = k < kmin ? k : kmin;
      kmax = k > kmax ? k : kmax;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_xor_sync(full, live, o);
    const unsigned long long a = __shfl_xor_sync(full, kmin, o);
    const unsigned long long b = __shfl_xor_sync(full, kmax, o);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
  }
  if (NT > 32) {
    if ((threadIdx.x & 31) == 0) {
      tm.red_live[wid] = live;
      tm.red_min[wid] = kmin;
      tm.red_max[wid] = kmax;
    }
  }
  team_sync<NT>();  // the keys, the cleared histograms and n_cand
  if (NT > 32) {
    live = tm.red_live[0];
    kmin = tm.red_min[0];
    kmax = tm.red_max[0];
    for (int w = 1; w < Team<NT>::kWarps; ++w) {
      live += tm.red_live[w];
      kmin = tm.red_min[w] < kmin ? tm.red_min[w] : kmin;
      kmax = tm.red_max[w] > kmax ? tm.red_max[w] : kmax;
    }
  }
#if VM_B7_STOP == 1
  return static_cast<double>(live);
#endif
  if (live == 0) return qnan();
  const int nm1 = live - 1;
  const double pos = 0.5 * static_cast<double>(nm1);
  const int j0 = static_cast<int>(floor(pos));
  const int j1 = j0 + 1 < nm1 ? j0 + 1 : nm1;
  unsigned long long k0 = kmin, k1 = kmin;
  if (kmin != kmax) {  // else every live key is kmin: j0 and j1 lie there
    if (keys != nullptr)
      select_pair<NT>(StagedKeys{keys}, T, j0, j1, kmin, kmax, tm, tid, wid,
                      &k0, &k1);
    else
      select_pair<NT>(RowKeys{row}, T, j0, j1, kmin, kmax, tm, tid, wid,
                      &k0, &k1);
  }
  const double a = key_value(k0);
  const double b = key_value(k1);
  return a + (pos - static_cast<double>(j0)) * (b - a);
}

// The warp path: `rows` rows a block, one warp each, each warp's keys in
// its own T-key slice of the block's shared memory.
__global__ void __launch_bounds__(kRankThreads)
rank_median_warp(const double* __restrict__ rolled, long long S, int T,
                 int rows, double* __restrict__ rank) {
  extern __shared__ __align__(16) unsigned long long s_keys[];
  __shared__ Team<32> teams[kRankWarps];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * rows + w;
  if (s >= S) return;  // a whole warp: nothing below waits for it
  const double r = median_row<32>(rolled + s * T, T,
                                  s_keys + static_cast<long long>(w) * T,
                                  teams[w], lane, 0);
  if (lane == 0) rank[s] = r;
}

// The block and global paths: a block per row.
__global__ void __launch_bounds__(kRankThreads)
rank_median_block(const double* __restrict__ rolled, int T, int staged,
                  double* __restrict__ rank) {
  extern __shared__ __align__(16) unsigned long long s_keys[];
  __shared__ Team<kRankThreads> team;
  const long long s = blockIdx.x;
  const double r = median_row<kRankThreads>(
      rolled + s * T, T, staged ? s_keys : nullptr, team, threadIdx.x,
      threadIdx.x >> 5);
  if (threadIdx.x == 0) rank[s] = r;
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

// B7 over S rows of T steps -> rank [S].  The median takes the
// wrapper's plan (ops/device_rollup.rank_plan): the warp path with `rows`
// rows a block (rows x T keys staged), a block a row with its T keys
// staged (T <= kStageMax), or a block a row reading the row from global
// memory.
extern "C" int vm_rank_rows(const void* rolled, long long S, int T, int kind,
                            int path, int rows, void* rank, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (kind < kMax || kind > kLast || S > 2147483647LL * kRankWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  double* out = static_cast<double*>(rank);
  if (kind != kMedian) {
    rank_simple<<<static_cast<unsigned>((S + kRankWarps - 1) / kRankWarps),
                  kRankThreads, 0, st>>>(r, S, T, kind, out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = cudaSuccess;
  if (path == kRankWarp) {
    const long long smem = 8LL * rows * T;
    if (rows < 1 || rows > kRankWarps || smem > 8LL * kStageMax ||
        (S + rows - 1) / rows > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
    // the opt-in covers the static teams too: above 48 KB in all
    static std::atomic<int> smem_set[kMaxDevices];
    e = ensure_smem(rank_median_warp, smem_set,
                    static_cast<int>(smem + sizeof(Team<32>) * kRankWarps));
    if (e != cudaSuccess) return static_cast<int>(e);
    rank_median_warp<<<static_cast<unsigned>((S + rows - 1) / rows),
                       rows * 32, static_cast<size_t>(smem), st>>>(
        r, S, T, rows, out);
    return static_cast<int>(cudaGetLastError());
  }
  if ((path != kRankBlock && path != kRankGlobal) ||
      (path == kRankBlock && T > kStageMax) || S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int staged = path == kRankBlock;
  const int smem = staged ? 8 * T : 0;
  static std::atomic<int> smem_set[kMaxDevices];
  e = ensure_smem(rank_median_block, smem_set,
                  smem + static_cast<int>(sizeof(Team<kRankThreads>)));
  if (e != cudaSuccess) return static_cast<int>(e);
  rank_median_block<<<static_cast<unsigned>(S), kRankThreads,
                      static_cast<size_t>(smem), st>>>(r, T, staged, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
