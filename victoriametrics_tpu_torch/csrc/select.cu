// B6 topk_select_tile (+ take_rows) and B7 rank_tile: selections over a
// rolled tile [S, T] (the output of B5 rollup_series).
//
// B6 replaces victoriametrics_tpu/ops/device_rollup.py:topk_select_tile,
// whose selection is jax.lax.top_k over the key
// NaN ? -inf : (bottom ? -v : v) for every step: the k best series by key
// in lax.top_k's order, which ranks +0.0 above -0.0 and breaks ties (the
// -inf of NaN rows among them) to the lower series index, plus a NaN flag
// per pick.  Two paths:
//  * k <= kTopkMax: topk_partial, one block per (32-step tile, row
//    partition).  Lane l of each warp owns step t0 + l, so a warp reads 32
//    neighbouring float64 of one row (coalesced); the four warps take
//    interleaved rows, each thread keeps a sorted list of its k best in
//    registers and local memory, and the block merges its four lists per
//    step.  With one partition that is the answer; otherwise each of up to
//    32 partitions' k best go to scratch and topk_merge, one warp per step
//    with a lane per partition, merges them.
//  * larger k (up to S): topk_sort, one block per step (a grid of at most
//    kSortBlocks blocks walks the steps).  The step's keys, as 64-bit
//    codes that order the picks ascending, go to the block's scratch;
//    block_select (order_stats.cuh) finds the k-th code.  The codes below
//    it (fewer than k) are gathered in index order and put in order by a
//    stable LSD radix sort (8 passes of 8 bits), so equal codes keep the
//    lower index first; the remaining slots take the series whose code
//    equals the k-th, lowest index first.  O(S + k) per step.
// Both paths' plans (row partitions, sort blocks, scratch) come from
// topk_plan, which vm_topk_scratch reports to the caller.
// take_rows replaces device_rollup.py:take_rows (a row gather; an index
// outside [0, S) gives a NaN row, like jnp.take's fill mode).
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
// step)) and write [T, k] picks; B7 reads it once and writes [S]; the
// radix passes re-read the keys staged in scratch or shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"

namespace {

constexpr int kTopkMax = 16;     // largest k of the register path
constexpr int kTopkWarps = 4;
constexpr int kTopkMaxParts = 32;  // row partitions the merge takes
constexpr int kMergeWarps = 4;
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortBlocks = 264;  // two per SM of an H100 SXM
constexpr int kRankThreads = 256;
constexpr int kStageMax = 24576;  // keys staged in shared memory (192 KiB)
constexpr int32_t kNoIndex = 2147483647;

__device__ __forceinline__ double topk_key(double v, int bottom) {
  return v != v ? -INFINITY : (bottom ? -v : v);
}

// a above b in lax.top_k's order: numeric, and +0.0 above -0.0.
__device__ __forceinline__ bool above(double a, double b) {
  if (a == 0.0 && b == 0.0) return !signbit(a) && signbit(b);
  return a > b;
}

// (ka, ia) is picked before (kb, ib): key descending, index ascending.
__device__ __forceinline__ bool before(double ka, int ia, double kb, int ib) {
  return above(ka, kb) || (!above(kb, ka) && ia < ib);
}

__global__ void __launch_bounds__(kTopkWarps * 32)
topk_partial(const double* __restrict__ rolled, long long S, int T, int k,
             int bottom, long long rows_per_part, int parts,
             double* __restrict__ part_key, int32_t* __restrict__ part_idx,
             int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_nan) {
  __shared__ double s_key[kTopkWarps][32][kTopkMax];
  __shared__ int32_t s_idx[kTopkWarps][32][kTopkMax];
  __shared__ int s_cnt[kTopkWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const int p = blockIdx.y;
  const long long r0 = static_cast<long long>(p) * rows_per_part;
  const long long r1 = min(S, r0 + rows_per_part);
  double kk[kTopkMax];
  int32_t ki[kTopkMax];
  int m = 0;
  if (t < T) {
    for (long long r = r0 + w; r < r1; r += kTopkWarps) {
      const double key = topk_key(rolled[r * T + t], bottom);
      int pos;
      if (m < k) pos = m++;
      else if (above(key, kk[k - 1])) pos = k - 1;
      else continue;  // rows come in ascending order: a tie never wins
      while (pos > 0 && above(key, kk[pos - 1])) {
        kk[pos] = kk[pos - 1];
        ki[pos] = ki[pos - 1];
        --pos;
      }
      kk[pos] = key;
      ki[pos] = static_cast<int32_t>(r);
    }
  }
  for (int j = 0; j < m; ++j) {
    s_key[w][lane][j] = kk[j];
    s_idx[w][lane][j] = ki[j];
  }
  s_cnt[w][lane] = m;
  __syncthreads();
  if (w != 0 || t >= T) return;
  // merge the four warps' lists of step t
  int head[kTopkWarps];
  for (int q = 0; q < kTopkWarps; ++q) head[q] = 0;
  for (int j = 0; j < k; ++j) {
    int best = -1;
    for (int q = 0; q < kTopkWarps; ++q) {
      if (head[q] >= s_cnt[q][lane]) continue;
      if (best < 0 || before(s_key[q][lane][head[q]], s_idx[q][lane][head[q]],
                             s_key[best][lane][head[best]],
                             s_idx[best][lane][head[best]]))
        best = q;
    }
    double key = -INFINITY;
    int32_t idx = kNoIndex;  // partition shorter than k: loses every tie
    if (best >= 0) {
      key = s_key[best][lane][head[best]];
      idx = s_idx[best][lane][head[best]];
      ++head[best];
    }
    if (parts == 1) {
      out_idx[static_cast<long long>(t) * k + j] = idx;
      out_nan[static_cast<long long>(t) * k + j] =
          rolled[static_cast<long long>(idx) * T + t] !=
          rolled[static_cast<long long>(idx) * T + t];
    } else {
      const long long o = (static_cast<long long>(p) * T + t) * k + j;
      part_key[o] = key;
      part_idx[o] = idx;
    }
  }
}

// One warp per step: lane q holds the head of partition q's sorted k-list
// (parts <= 32); each pick is the warp's best head, whose lane advances.
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge(const double* __restrict__ rolled, int T, int k, int parts,
           const double* __restrict__ part_key,
           const int32_t* __restrict__ part_idx,
           int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_nan) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform across the warp
  int head = 0;
  for (int j = 0; j < k; ++j) {
    double bk = -INFINITY;
    int32_t bi = kNoIndex;  // an exhausted lane loses every comparison
    if (lane < parts && head < k) {
      const long long o = (static_cast<long long>(lane) * T + t) * k + head;
      bk = part_key[o];
      bi = part_idx[o];
    }
    int bl = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const double ok = __shfl_down_sync(full, bk, off);
      const int32_t oi = __shfl_down_sync(full, bi, off);
      const int ol = __shfl_down_sync(full, bl, off);
      if (before(ok, oi, bk, bi)) {
        bk = ok;
        bi = oi;
        bl = ol;
      }
    }
    bi = __shfl_sync(full, bi, 0);
    if (lane == __shfl_sync(full, bl, 0)) ++head;
    if (lane == 0) {
      out_idx[static_cast<long long>(t) * k + j] = bi;
      const double v = rolled[static_cast<long long>(bi) * T + t];
      out_nan[static_cast<long long>(t) * k + j] = v != v;
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

// The scratch of one sort block: S codes, then two (code, index) buffers
// of k pairs.
__host__ __device__ long long sort_block_bytes(long long S, int k) {
  return ((8 * S + 24LL * k) + 255) / 256 * 256;
}

__global__ void __launch_bounds__(kSortThreads)
topk_sort(const double* __restrict__ rolled, int S, int T, int k, int bottom,
          unsigned char* __restrict__ scratch,
          int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_nan) {
  unsigned char* mine = scratch + blockIdx.x * sort_block_bytes(S, k);
  unsigned long long* codes = reinterpret_cast<unsigned long long*>(mine);
  unsigned long long* ak = codes + S;
  unsigned long long* bk = ak + k;
  int32_t* ai = reinterpret_cast<int32_t*>(bk + k);
  int32_t* bi = ai + k;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    for (int i = threadIdx.x; i < S; i += kSortThreads)
      codes[i] = pick_code(rolled[static_cast<long long>(i) * T + t], bottom);
    __syncthreads();
    int less, equal;
    const unsigned long long kth =
        block_select(StagedKeys{codes}, S, k - 1, &less, &equal);
    const int ties = k - less;  // slots left for codes equal to the k-th
    int n_less = 0, n_tie = 0;
    for (int base = 0; base < S; base += kSortThreads) {
      const int i = base + threadIdx.x;
      const unsigned long long c = i < S ? codes[i] : 0;
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
        const long long o = static_cast<long long>(t) * k + less + n_tie +
                            r_eq;
        const double v = rolled[static_cast<long long>(i) * T + t];
        out_idx[o] = i;
        out_nan[o] = v != v;
      }
      n_less += tot_lt;
      n_tie += tot_eq;
    }
    __syncthreads();
    block_sort(ak, ai, bk, bi, less);
    for (int j = threadIdx.x; j < less; j += kSortThreads) {
      const long long o = static_cast<long long>(t) * k + j;
      const int32_t i = ai[j];
      const double v = rolled[static_cast<long long>(i) * T + t];
      out_idx[o] = i;
      out_nan[o] = v != v;
    }
    __syncthreads();
  }
}

struct TopkPlan {
  int parts;  // register path: row partitions (1: no merge)
  long long rows_per_part;
  int blocks;  // sort path: blocks walking the steps
  long long bytes;  // scratch
};

TopkPlan topk_plan(long long S, int T, int k) {
  TopkPlan p{1, S, 0, 0};
  if (k <= kTopkMax) {
    // enough blocks to fill the card: split the rows when the steps alone
    // give too few 32-step tiles
    const long long col_tiles = (T + 31) / 32;
    long long parts = (1024 + col_tiles - 1) / col_tiles;
    parts = parts < S / 256 ? parts : S / 256;
    parts = parts < kTopkMaxParts ? parts : kTopkMaxParts;
    parts = parts > 1 ? parts : 1;
    p.rows_per_part = (S + parts - 1) / parts;
    p.parts = static_cast<int>((S + p.rows_per_part - 1) / p.rows_per_part);
    if (p.parts > 1) p.bytes = static_cast<long long>(p.parts) * T * k * 12;
  } else {
    p.blocks = T < kSortBlocks ? T : kSortBlocks;
    p.bytes = p.blocks * sort_block_bytes(S, k);
  }
  return p;
}

__global__ void __launch_bounds__(256)
take_rows_kernel(const double* __restrict__ rolled, long long S, int T,
                 const int64_t* __restrict__ sel,
                 double* __restrict__ out) {
  const long long m = blockIdx.x;
  const int t = blockIdx.y * 256 + threadIdx.x;
  if (t >= T) return;
  const int64_t r = sel[m];
  out[m * T + t] = r >= 0 && r < S ? rolled[r * T + t] : qnan();
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

// The scratch bytes vm_topk_select needs for (S, T, k).
extern "C" int vm_topk_scratch(long long S, int T, int k, long long* bytes) {
  if (S <= 0 || T <= 0 || k <= 0 || k > S || S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = topk_plan(S, T, k).bytes;
  return 0;
}

extern "C" int vm_topk_select(const void* rolled, long long S, int T, int k,
                              int bottom, void* scratch, void* out_idx,
                              void* out_nan, void* stream) {
  if (S <= 0 || T <= 0 || k <= 0 || k > S || S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* r = static_cast<const double*>(rolled);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  uint8_t* on = static_cast<uint8_t*>(out_nan);
  const TopkPlan p = topk_plan(S, T, k);
  if (k > kTopkMax) {
    topk_sort<<<static_cast<unsigned>(p.blocks), kSortThreads, 0, st>>>(
        r, static_cast<int>(S), T, k, bottom,
        static_cast<unsigned char*>(scratch), oi, on);
    return static_cast<int>(cudaGetLastError());
  }
  double* part_key = static_cast<double*>(scratch);
  int32_t* part_idx = p.parts > 1
      ? reinterpret_cast<int32_t*>(part_key +
                                   static_cast<long long>(p.parts) * T * k)
      : nullptr;
  const dim3 grid(static_cast<unsigned>((T + 31) / 32),
                  static_cast<unsigned>(p.parts));
  topk_partial<<<grid, kTopkWarps * 32, 0, st>>>(
      r, S, T, k, bottom, p.rows_per_part, p.parts, part_key, part_idx, oi,
      on);
  if (p.parts > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    topk_merge<<<(T + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0,
                 st>>>(r, T, k, p.parts, part_key, part_idx, oi, on);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vm_take_rows(const void* rolled, long long S, int T,
                            const void* sel, long long M, void* out,
                            void* stream) {
  if (M <= 0 || T <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(M),
                  static_cast<unsigned>((T + 255) / 256));
  take_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rolled), S, T,
      static_cast<const int64_t*>(sel), static_cast<double*>(out));
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
