// K2 rollup_aggregate_tile: fused aggr(rollup(m[window])) -> [G, T],
// B5 rollup_tile: the per-series rollup -> [S, T], B9
// fleet_rollup_aggregate_tile: K2 over a stack of B streams -> [B, G, T],
// B12 decode_and_rollup: K1's row decode fused into B5 -> [S, T], and
// B13's per-shard pass: K2's group walk writing its moments -> [D, M, G, T].
//
// K2 replaces victoriametrics_tpu/ops/device_rollup.py:rollup_aggregate_tile
// and B5 victoriametrics_tpu/ops/device_rollup.py:rollup_tile, jax.jit
// programs of the 26 CORE_SUPPORTED rollup branches (_masked_window_reduce,
// _remove_counter_resets, _max_prev_interval_tile) and, for K2,
// partial_group_moments + finalize_group_moments.  B9 replaces
// victoriametrics_tpu/ops/device_rollup.py:fleet_rollup_aggregate_tile
// (fleet_rollup_aggregate_impl + _fleet_group_aggregate): rollup_tile
// vmapped over a leading stream axis, each stream with its own grid shift,
// fetch bound min_ts, rebase offsets v0 and aggregate code.  On the TPU
// the window reduce is a dense [S, 256-chunk, T] compare-and-reduce,
// because gathers are slow there.  Here each (series, step) finds its
// window by a search of the sorted row and reads the samples it needs
// directly; one device function, window_value, computes every func for
// all of them.
//
// Launches:
//  1. rollup_scan, one warp per row (of one tile, or of the D row blocks
//     of B13's shards on one card): the row's maxPrevInterval mpi
//     (_max_prev_interval_tile); for the counter funcs (rate, increase,
//     increase_pure, irate) whether the row is regular: no NaN, no -0.0
//     and no decrease on its valid prefix; for stddev/stdvar_over_time the
//     mean of the row's valid samples, which those funcs centre by.  On a
//     regular row the reset-corrected counter cv (_remove_counter_resets)
//     and its running maximum cmax both equal the values themselves, so
//     the later passes read the tile's values directly.  Each irregular
//     row takes a slot (an atomic counter; slots only address scratch, so
//     their order does not reach the result).
//  2. rollup_prep, only when some row is irregular: one warp per irregular
//     row writes cv and cmax into its slot of an [irregular rows, N]
//     scratch pair.  Clean counters need no scratch at all; a row with a
//     reset or a NaN costs 16 B per column.
//  3. K2 and B13's per-shard pass: group_pass, one block per (group or
//     chunk, tile of 128-512 steps) over D row blocks (D = 1 for K2; B13's
//     shards of one card in one launch, at most kMaxShards), thread i
//     taking steps i, i + 128, ... of the tile.  It walks the members in
//     ascending row order (a stable sort of the group ids, computed once
//     per layout by the caller), accumulates cnt/s1/s2/min/max per step in
//     registers, then finalizes (K2), stores the moments (B13) or writes
//     them to a chunk's partial slot.  On the staged path (the plan,
//     ops/device_rollup.k2_plan) the block finds each member's span for
//     its tile once, streams the spans through a shared-memory ring by
//     cp.async, and finds each step's window in the staged span from an
//     interpolated guess: a couple of shared-memory probes where the
//     global search made 2 log2(N) dependent loads (26 at full width).
//     No [S, T] intermediate is written and no float atomics are used, so
//     a result is the same on every run.
//     A group of more than R = chunk members (FLEET_CHUNK, 64) is split
//     into chunks of R consecutive members, one block each (one group of
//     8192 rows was 3 blocks, each thread walking 8192 rows); group_fold,
//     a second launch, merges a group's chunks in ascending chunk order
//     with B9's fold_chunks and finalizes or stores them.
//     B5: series_pass, the same staged walk (walk_rows) over blocks of up
//     to 64 consecutive rows (ops/device_rollup.b5_plan), each value
//     written to [S, T] as it is found, a warp's stores consecutive in t;
//     on the global path (a wrapping grid, or spans no stage holds)
//     rollup_series, one block per (row, 128-step tile), writes
//     series_value.
//     B9: fleet_rollup_groups, the same walk with a stream axis and the
//     global search: one block per (stream, group, 128-step tile).  The
//     block reads its stream's shift, min_ts and aggregate code from [B]
//     arrays and walks the stream's group members from a [B, S] order and
//     [B, G + 1] starts (built once per upload of the bucket: a member's
//     group ids are fixed while it lives).  The row scan and the scratch
//     pass take the B x S rows as one tile, with the shift and min_ts of
//     each row's stream.  The reference computes all eight aggregates and
//     gathers one (:694-700); the block finalizes only its stream's, with
//     the same NaN where cnt is 0, so padded rows (counts 0), padded groups
//     and padded slots come out NaN.  It chunks a group as K2 does (the
//     layout numbers each stream's chunks, slot0, into a wrapper-allocated
//     [5, B x slots, T]) and fleet_fold merges the chunks as group_fold
//     does, a second launch rather than a cluster fold: a group's chunk
//     count is not bounded by a cluster's 16 blocks, and the fold reads ~1
//     MB.  Chunk boundaries depend only on the group's own size, so a
//     stream shard (B14) gets B9's bits and B9 and the per-stream K2 fold
//     alike; count, group, min and max equal an unchunked walk bit for bit
//     (extrema keep the first of equal values in ascending order), the
//     sums differ from it only in association.  Groups of at most R
//     members keep the single pass, and a layout with none larger
//     launches no fold.
//
//  4. B12 (replaces victoriametrics_tpu/ops/device_decode.py:
//     decode_and_rollup, decode_tiles then rollup_tile in one jit):
//     decode_rollup, one 256- or 512-thread block per row (grid-stride
//     over the rows, as many blocks as the card holds at once; 512 where
//     the workspace lets fewer than four blocks of 256 share an SM).  The
//     block decodes the row's two delta planes into a workspace
//     (decode.cuh decode_row_pair: K1's values from two block scans a
//     row), checks its regularity with every thread, runs scan_row
//     (mpi, mean) and, for an irregular counter row, prep_row on warp 0,
//     and its threads evaluate the row's steps, each window found in the
//     decoded row from an interpolated guess.  The decoded tile is never
//     written, and the output equals K1 then B5 bit for bit.  The
//     workspace is the row's values and timestamps (12 B per column) in
//     dynamic shared memory up to the opt-in limit (above 48 KB through
//     cudaFuncSetAttribute), else a global scratch slot per resident
//     block; cv and cmax always sit in the block's scratch slot, so the
//     scratch is blocks x n columns, never S x n.
//  5. B13's per-shard pass (replaces the partial_group_moments half of
//     victoriametrics_tpu/parallel/mesh.py:sharded_rollup_aggregate): K2's
//     group_pass writing the aggregate's moments (moments.cuh, in MOMENTS
//     order) to [D, M, G, T]; mesh.cu combines the shards.
//
// Faithfulness to the reference:
//  * c_last and c_prev are max-reductions of cv over "ts <= bound" in the
//    reference; they equal cv[hi-1] / cv[lo-1] only when cv never
//    decreases, which a negative value after a reset breaks.  So they are
//    read from the running maximum cmax, and c_first (a min over the
//    window) is a loop over the window's samples.
//  * jnp.max / jnp.min propagate NaN where CUDA's fmax / fmin drop it:
//    nan_max / nan_min below propagate (min/max_over_time, c_first, cmax).
//  * changes counts a NaN as a change (NaN != anything) and drops the
//    boundary transition chg[lo] when there is no eligible previous sample.
//  * delta / increase count a series born inside the window from 0 when
//    |first| < 10 (|second - first| + 1); increase_pure always does.
//  * idelta, deriv_fast, rate and irate take the sample before the window
//    only within maxPrevInterval of the window start.
//  * deriv is the reference's t0-shifted moment formula, sums in ascending
//    sample order; stddev/stdvar centre by the mean of the whole valid row.
//  * the time-valued funcs add start_s (cfg.start / 1e3, float64) after
//    dividing by 1e3; lifetime reads the row's first sample when the
//    window has an eligible previous sample.
//  * min_ts gates only previous-sample accesses (has_prev).
//  * cv is values + (prefix sum of drops), which turns -0.0 into +0.0; a
//    row holding -0.0 is therefore irregular and goes through the scratch.
//  * mpi is float32 arithmetic in the reference: 0.6 * (n - 1) in float64
//    cast to float32, a float32 quantile interpolation, truncation to
//    int32, then the int32 jitter table.  The library is built with
//    --fmad=false so no multiply-add is contracted.
//  * Windows are searched within [0, counts[row]); timestamps are shifted
//    by `shift` in wrapping int32 arithmetic like the reference's
//    ts - shift.
//  * v0 (B9 only: the reference's rebase offsets, zeros for float64
//    buckets) enters where the reference adds it: the reset threshold and
//    restarted base of cv (prev + v0), and the born-in-window test and
//    zero base of delta / increase (first + v0, base -v0).  K2 and B5 run
//    with v0 = +0.0 there, which is the reference's v0=None: x + 0.0 and a
//    base of -0.0.
//
// Bound: bytes.  The function must read each valid sample's timestamp and
// value once (12 B/sample) and write [G, T] (K2), [S, T] (B5) or
// [B, G, T] (B9) float64; B12 reads the delta planes instead (1-4 B per
// column and plane) and writes [S, T]; B13's pass writes [D, M, G, T].
// The scan pass reads the values once (8 B/sample) for the counter funcs
// and stddev/stdvar only.  B9's series pass (and B5's global path) reads
// about 2 log2(N) + window timestamps and values per (series, step) from
// L1/L2, since a block's 128 threads walk the same row; the staged walk of
// K2 and B5 reads each sample of a tile's span once from global memory
// (the spans of neighbouring tiles overlap by a window) and a few
// shared-memory words per (series, step); B12 finds its windows in the
// decoded row in shared memory the same way.  The design keeps every
// intermediate of the [S, T] rollup in registers; its distance from the
// byte bound is recorded in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "async_copy.cuh"
#include "decode.cuh"
#include "moments.cuh"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kGroupThreads = 128;
constexpr int kFoldBatch = 8;  // chunks a fold thread loads at once
constexpr int32_t kI32Min = -2147483647 - 1;
constexpr long long kNegZeroBits =
    static_cast<long long>(0x8000000000000000ULL);

// Func codes, FUNC_CODES in ops/device_rollup.py.
enum Func {
  kRate = 0, kIncrease = 1, kIncreasePure = 2, kIrate = 3, kCount = 4,
  kPresent = 5, kSum = 6, kAvg = 7, kStddev = 8, kStdvar = 9, kMin = 10,
  kMax = 11, kTfirst = 12, kTlast = 13, kTimestamp = 14, kLag = 15,
  kFirst = 16, kLast = 17, kDefault = 18, kChanges = 19, kDelta = 20,
  kIdelta = 21, kDerivFast = 22, kDeriv = 23, kLifetime = 24,
  kScrapeInterval = 25
};

// ts - shift with int32 wraparound.
__device__ __forceinline__ int32_t shifted(int32_t t, int32_t shift) {
  return static_cast<int32_t>(static_cast<uint32_t>(t) -
                              static_cast<uint32_t>(shift));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// True when sample i's value v breaks regularity: NaN, -0.0, or below
// its predecessor `prev` (a counter reset).
__device__ __forceinline__ bool irregular_value(double v, double prev,
                                                int i) {
  if (v != v || __double_as_longlong(v) == kNegZeroBits) return true;
  return i >= 1 && v < prev;
}

// The row scan of one row, run by every lane of one warp: returns (on
// every lane) whether the row is irregular when `counter`, writes the
// mean of its valid samples to *mean when `mean` is given, and its
// maxPrevInterval to *mpi (lane 0), the quantile of its last intervals
// found by the warp's lanes together.  K2, B5 and B9 scan their rows with
// rollup_scan below, B12 the row it has just decoded.
__device__ bool scan_row(const int32_t* trow, const double* vrow, int c,
                         int N, int32_t shift, int32_t min_ts, int32_t step,
                         int instant, int counter, double* mean,
                         int32_t* mpi) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  bool irregular = false;
  if (counter) {
    // 4 x 32 samples a round, each lane's loads issued before its checks
    for (int base = 0; base < c && !irregular; base += 128) {
      double v[4], prev[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = base + 32 * k + lane;
        v[k] = i < c ? vrow[i] : 0.0;
        prev[k] = i >= 1 && i < c ? vrow[i - 1] : 0.0;
      }
      bool bad = false;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bad |= base + 32 * k + lane < c &&
               irregular_value(v[k], prev[k], base + 32 * k + lane);
      irregular = __any_sync(full, bad);
    }
  }
  if (mean != nullptr) {
    double s = 0.0;
    for (int i = lane; i < c; i += 32) s += vrow[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(full, s, o);
    if (lane == 0) *mean = s / static_cast<double>(c > 1 ? c : 1);
  }
  if (instant) {
    if (lane == 0) *mpi = step;
    return irregular;
  }
  // 0.6 quantile of the last <= 20 intervals among samples >= min_ts:
  // lane k reads sample base + k (k <= 20), and lane k < 20 holds interval
  // k when both of its samples count.  An interval's rank among the valid
  // ones (ties by lane) is its place in the ascending order, so the
  // sorted list's entries at the quantile's two ranks are read from the
  // lanes holding those ranks: an insertion sort's values.
  const int base = c - 21 > 0 ? c - 21 : 0;
  const int idx = base + lane;
  const int cl = idx < N - 1 ? idx : N - 1;
  const int32_t tv = lane <= 20 ? shifted(trow[cl], shift) : 0;
  const int ok = lane <= 20 && idx < c && tv >= min_ts;
  const int32_t tv_next = __shfl_down_sync(full, tv, 1);
  const int ok_next = __shfl_down_sync(full, ok, 1);
  const bool valid = lane < 20 && ok && ok_next;
  const float x = valid ? static_cast<float>(wsub(tv_next, tv)) : 0.0f;
  const unsigned live = __ballot_sync(full, valid);
  const int n = __popc(live);
  int rank = 0;
  for (int k = 0; k < 20; ++k) {
    const float y = __shfl_sync(full, x, k);
    if (((live >> k) & 1u) && (y < x || (y == x && k < lane))) ++rank;
  }
  int32_t si = 0;
  if (n >= 1) {  // uniform across the warp
    const float rk = __double2float_rn(0.6 * static_cast<double>(n - 1));
    const int lo_i = static_cast<int>(floorf(rk));
    const int hi_i = static_cast<int>(ceilf(rk));
    const unsigned at_lo = __ballot_sync(full, valid && rank == lo_i);
    const unsigned at_hi = __ballot_sync(full, valid && rank == hi_i);
    const float v_lo = __shfl_sync(full, x, __ffs(at_lo) - 1);
    const float v_hi = __shfl_sync(full, x, __ffs(at_hi) - 1);
    const float q = __fadd_rn(
        v_lo, __fmul_rn(__fsub_rn(rk, static_cast<float>(lo_i)),
                        __fsub_rn(v_hi, v_lo)));
    si = __float2int_rz(q);
  }
  if (si <= 0) si = step;
  int32_t r;
  if (si <= 2000) r = si + 4 * si;
  else if (si <= 4000) r = si + 2 * si;
  else if (si <= 8000) r = si + si;
  else if (si <= 16000) r = si + si / 2;
  else if (si <= 32000) r = si + si / 4;
  else r = si + si / 8;
  if (lane == 0) *mpi = r;
  return irregular;
}

// D row blocks of N columns, the rows of the passes below: one tile
// (D = 1; B9's [B, S, N] stack is one block of B x S rows), or the series
// shards of a mesh whose shards share a card (B13).  Row r of the
// concatenation lies in block d with row0[d] <= r < row0[d + 1]; the row
// scan's outputs (mpi, slots, mean) are indexed by r.
constexpr int kMaxShards = 16;

struct RowBlocks {
  const int32_t* ts[kMaxShards];
  const double* vals[kMaxShards];
  const int32_t* counts[kMaxShards];
  long long row0[kMaxShards + 1];
  int D;
};

__device__ __forceinline__ int block_of(const RowBlocks& rb, long long r) {
  int d = 0;
  while (d + 1 < rb.D && r >= rb.row0[d + 1]) ++d;
  return d;
}

// One warp per row: regularity (slot -1, or a scratch slot) when
// `counter`, the row mean when `mean` is given, and mpi.
// `shifts` / `min_tss` (B9): the values of each stream of rows_per_stream
// rows, in place of the scalars.
__global__ void __launch_bounds__(kPrepThreads)
rollup_scan(RowBlocks rb, int N, int32_t shift, int32_t min_ts,
            const int32_t* __restrict__ shifts,
            const int32_t* __restrict__ min_tss, long long rows_per_stream,
            int32_t step, int instant, int counter,
            int32_t* __restrict__ mpi, int32_t* __restrict__ slots,
            int32_t* __restrict__ n_irregular, double* __restrict__ mean) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rb.row0[rb.D]) return;  // uniform across the warp
  if (shifts != nullptr) {
    const long long b = row / rows_per_stream;
    shift = shifts[b];
    min_ts = min_tss[b];
  }
  const int d = block_of(rb, row);
  const long long local = row - rb.row0[d];
  const int c = min(rb.counts[d][local], N);
  const long long off = local * static_cast<long long>(N);
  const bool irregular = scan_row(
      rb.ts[d] + off, rb.vals[d] + off, c, N, shift, min_ts, step, instant,
      counter, mean != nullptr ? mean + row : nullptr, mpi + row);
  if (lane == 0) slots[row] = irregular ? atomicAdd(n_irregular, 1) : -1;
}

// cv and cmax over one row's valid prefix, run by every lane of one warp.
// `rebased` (B9): v0r makes the reset threshold and the restarted base
// absolute.
__device__ void prep_row(const double* vrow, int c, bool rebased, double v0r,
                         double* cv_row, double* cmax_row) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  double carry_sum = 0.0;
  double carry_max = -INFINITY;
  for (int base = 0; base < c; base += 32) {
    const int i = base + lane;
    double v = 0.0, drop = 0.0;
    if (i < c) {
      v = vrow[i];
      if (i >= 1) {
        const double prev = vrow[i - 1];
        const double pa = rebased ? prev + v0r : prev;
        if (v < prev) drop = (prev - v) * 8.0 < pa ? prev - v : pa;
      }
    }
    // left-to-right running sum of the drops (a serial scan's order)
    double my_cum = 0.0;
    for (int k = 0; k < 32; ++k) {
      carry_sum += __shfl_sync(full, drop, k);
      if (k == lane) my_cum = carry_sum;
    }
    const double cvv = v + my_cum;
    double m = cvv;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(full, m, o);
      if (lane >= o) m = nan_max(m, y);
    }
    m = nan_max(m, carry_max);
    if (i < c) {
      cv_row[i] = cvv;
      cmax_row[i] = m;
    }
    carry_max = __shfl_sync(full, m, 31);
  }
}

// One warp per irregular row: cv and cmax over the row's valid prefix,
// into the row's scratch slot.  `v0` (B9, one per row) makes the reset
// threshold and the restarted base absolute.
__global__ void __launch_bounds__(kPrepThreads)
rollup_prep(RowBlocks rb, const int32_t* __restrict__ slots,
            const double* __restrict__ v0, int N, double* __restrict__ cv,
            double* __restrict__ cmax) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  if (row >= rb.row0[rb.D]) return;  // uniform across the warp
  const int slot = slots[row];
  if (slot < 0) return;  // regular row: cv = cmax = values
  const int d = block_of(rb, row);
  const long long local = row - rb.row0[d];
  const long long soff = static_cast<long long>(slot) * N;
  prep_row(rb.vals[d] + local * static_cast<long long>(N),
           min(rb.counts[d][local], N), v0 != nullptr,
           v0 != nullptr ? v0[row] : 0.0, cv + soff, cmax + soff);
}

// #{i in [lo, hi) : ts[i] - shift <= x} + lo, on a sorted row.
__device__ __forceinline__ int count_le(const int32_t* __restrict__ trow,
                                        int lo, int hi, int32_t shift,
                                        int32_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (shifted(trow[mid], shift) <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// #{i in [0, L) : shifted(a[i]) <= x} on a sorted row, from a guess g of
// the answer: probes at distances 1, 2, 4, ... from g bracket the answer,
// then count_le finishes inside the bracket.  The same count for any g;
// two probes when g is right, O(log |answer - g|) when it is not.
__device__ __forceinline__ int count_le_from(const int32_t* a, int L,
                                             int32_t shift, int32_t x,
                                             int g) {
  g = g < 0 ? 0 : (g > L ? L : g);
  int lo, hi;
  if (g < L && shifted(a[g], shift) <= x) {  // the answer lies past g
    lo = g + 1;
    hi = L;
    for (int d = 1; lo + d - 1 < L; d <<= 1) {
      const int p = lo + d - 1;
      if (shifted(a[p], shift) > x) {
        hi = p;
        break;
      }
      lo = p + 1;
    }
  } else {  // at or before g
    lo = 0;
    hi = g;
    for (int d = 1; hi - d >= 0; d <<= 1) {
      const int p = hi - d;
      if (shifted(a[p], shift) <= x) {
        lo = p + 1;
        break;
      }
      hi = p;
    }
  }
  return count_le(a, lo, hi, shift, x);
}

// Samples per ms on the line through a row's first and last (shifted)
// timestamps f0 and f1, L samples apart; 0 for a row of one timestamp.
__device__ __forceinline__ float per_ms_of(int32_t f0, int32_t f1, int L) {
  return L > 1 && f1 > f0
             ? static_cast<float>(L - 1) /
                   static_cast<float>(static_cast<long long>(f1) - f0)
             : 0.0f;
}

// The guess of count_le_from: x's place on that line, in [0, L].
__device__ __forceinline__ int guess_count(int32_t x, int32_t f0,
                                           float per_ms, int L) {
  // wrapping int32: a span far wider than int32 only spoils the guess
  const float f = static_cast<float>(wsub(x, f0)) * per_ms;
  if (!(f >= 0.0f)) return 0;
  return f >= static_cast<float>(L) ? L : static_cast<int>(f) + 1;
}

// One row of the tile as series_value reads it.
struct Row {
  const int32_t* ts;  // timestamps (unshifted)
  const double* v;    // values
  const double* cv;   // reset-corrected counter (values on a regular row)
  const double* cm;   // running max of cv (values on a regular row)
  int c;              // valid samples
  int32_t mpi;        // maxPrevInterval
  double mean;        // mean of the valid samples (stddev/stdvar only)
  double v0;          // rebase offset: B9's v0 plane, +0.0 for K2 and B5
};

// The query grid, the same for every row.
struct Grid {
  int32_t shift, min_ts, step, lookback;
  double start_s;  // cfg.start / 1e3, for the time-valued funcs
};

__device__ __forceinline__ Row row_at(long long r, int N,
                                      const int32_t* __restrict__ ts,
                                      const double* __restrict__ vals,
                                      const double* __restrict__ cv,
                                      const double* __restrict__ cmax,
                                      const int32_t* __restrict__ slots,
                                      const int32_t* __restrict__ counts,
                                      const int32_t* __restrict__ mpi,
                                      const double* __restrict__ mean,
                                      const double* __restrict__ v0) {
  const long long off = r * static_cast<long long>(N);
  const int slot = slots[r];
  const long long soff = static_cast<long long>(slot) * N;
  Row row;
  row.ts = ts + off;
  row.v = vals + off;
  row.cv = slot < 0 ? vals + off : cv + soff;
  row.cm = slot < 0 ? vals + off : cmax + soff;
  row.c = min(counts[r], N);
  row.mpi = mpi[r];
  row.mean = mean != nullptr ? mean[r] : 0.0;
  row.v0 = v0 != nullptr ? v0[r] : 0.0;
  return row;
}

// A row's window reads, from the tile in global memory (B9, the global
// paths of K2 and B5) or B12's decoded row: the timestamps shifted onto
// the grid, the values, the
// reset-corrected counter cv and its running maximum cm (both the values
// on a regular row), each sample's time in seconds and its value less
// the row mean (stddev/stdvar).
struct GlobalRow {
  const int32_t* ts;
  const double *v, *cv, *cm;
  int32_t shift;
  double mean;
  __device__ __forceinline__ int32_t t(int i) const {
    return shifted(ts[i], shift);
  }
  __device__ __forceinline__ int32_t first() const {
    return shifted(ts[0], shift);
  }
  __device__ __forceinline__ double val(int i) const { return v[i]; }
  __device__ __forceinline__ double cval(int i) const { return cv[i]; }
  __device__ __forceinline__ double cmax(int i) const { return cm[i]; }
  __device__ __forceinline__ double secs(int i) const {
    return static_cast<double>(t(i)) / 1e3;
  }
  __device__ __forceinline__ double centred(int i) const {
    return v[i] - mean;
  }
};

// The same reads from a span of the row staged in shared memory from
// sample `base` on (the staged walk of K2 and B5): the timestamps, plane a (the
// values; cv; or the values less the row mean, computed once per sample)
// and plane b (cmax; or the time in seconds, computed once per sample),
// as the func needs them.  The row's first sample (lifetime) stays a read
// of the tile.
struct StagedRow {
  const int32_t* ts;
  const double *a, *b;
  int base;
  int32_t shift;
  const int32_t* row_ts;
  __device__ __forceinline__ int32_t t(int i) const {
    return shifted(ts[i - base], shift);
  }
  __device__ __forceinline__ int32_t first() const {
    return shifted(row_ts[0], shift);
  }
  __device__ __forceinline__ double val(int i) const { return a[i - base]; }
  __device__ __forceinline__ double cval(int i) const { return a[i - base]; }
  __device__ __forceinline__ double cmax(int i) const { return b[i - base]; }
  __device__ __forceinline__ double secs(int i) const { return b[i - base]; }
  __device__ __forceinline__ double centred(int i) const {
    return a[i - base];
  }
};

// The rollup value at step t of a row whose window at t is samples
// [lo, hi): the branches of device_rollup.py:rollup_tile, operation for
// operation.  NaN = no value.  The func is a template argument, so each
// kernel instance reads only the samples its func needs; `R` is where
// the reads go (GlobalRow or StagedRow), so a value has the same bits
// from either.
template <int F, class R>
__device__ __forceinline__ double window_value(const R& r, const Grid& g,
                                               int t, int lo, int hi,
                                               int32_t mpi, double v0) {
  const int32_t grid = static_cast<int32_t>(static_cast<uint32_t>(t) *
                                            static_cast<uint32_t>(g.step));
  const int32_t lo_t = wsub(grid, g.lookback);
  if (hi <= lo) return qnan();  // empty window
  const int n = hi - lo;
  const int32_t t_prev_i = lo >= 1 ? r.t(lo - 1) : kI32Min;
  const bool has_prev = lo >= 1 && t_prev_i >= g.min_ts;
  const bool two = n >= 2;
  const double nw = static_cast<double>(n);
  const double t_last = static_cast<double>(r.t(hi - 1));
  // read only on the branches that use it
  const auto t_first = [&]() { return static_cast<double>(r.t(lo)); };
  const double t_prev = static_cast<double>(t_prev_i);
  // prevValue only within maxPrevInterval of the window start
  const bool has_gprev = has_prev && t_prev_i > wsub(lo_t, mpi);
  switch (F) {
    case kCount: return nw;
    case kPresent: return 1.0;
    case kSum:
    case kAvg: {
      double s = 0.0;
      for (int i = lo; i < hi; ++i) s += r.val(i);
      return F == kSum ? s : s / nw;
    }
    case kStddev:
    case kStdvar: {
      double s1 = 0.0, s2 = 0.0;
      for (int i = lo; i < hi; ++i) {
        const double x = r.centred(i);
        s1 += x;
        s2 += x * x;
      }
      const double m1 = s1 / nw;
      const double var = nan_max(s2 / nw - m1 * m1, 0.0);
      return F == kStddev ? sqrt(var) : var;
    }
    case kMin:
    case kMax: {
      double m = F == kMin ? INFINITY : -INFINITY;
      for (int i = lo; i < hi; ++i)
        m = F == kMin ? nan_min(m, r.val(i)) : nan_max(m, r.val(i));
      return m;
    }
    case kTfirst: return t_first() / 1e3 + g.start_s;
    case kTlast:
    case kTimestamp: return t_last / 1e3 + g.start_s;
    case kLag: return (static_cast<double>(grid) - t_last) / 1e3;
    case kFirst: return r.val(lo);
    case kLast:
    case kDefault: return r.val(hi - 1);
    case kChanges: {
      double s = 0.0;
      for (int i = lo; i < hi; ++i)
        if (i >= 1 && r.val(i) != r.val(i - 1)) s += 1.0;
      const double boundary =
          lo >= 1 && r.val(lo) != r.val(lo - 1) ? 1.0 : 0.0;
      return s - (has_prev ? 0.0 : boundary);
    }
    case kDelta: {
      const double v_first = r.val(lo);
      const double d = two ? r.val(lo + 1) - v_first : 0.0;
      const bool born = fabs(v_first + v0) < 10.0 * (fabs(d) + 1.0);
      const double base = has_prev ? r.val(lo - 1) : (born ? -v0 : v_first);
      return r.val(hi - 1) - base;
    }
    case kIdelta: {
      if (!(two || has_gprev)) return qnan();
      const double prev = two ? r.val(hi - 2) : r.val(lo - 1);
      return r.val(hi - 1) - prev;
    }
    case kDerivFast: {
      if (!(has_gprev || two)) return qnan();
      const double base_v = has_gprev ? r.val(lo - 1) : r.val(lo);
      const double base_t = has_gprev ? t_prev : t_first();
      const double dt = (t_last - base_t) / 1e3;
      return dt > 0.0 ? (r.val(hi - 1) - base_v) / dt : qnan();
    }
    case kDeriv: {
      if (!two) return qnan();
      double st = 0.0, stt = 0.0, sv = 0.0, stv = 0.0;
      for (int i = lo; i < hi; ++i) {
        const double ts_s = r.secs(i);
        st += ts_s;
        stt += ts_s * ts_s;
        sv += r.val(i);
        stv += ts_s * r.val(i);
      }
      const double t0 = r.secs(lo);
      const double st_ = st - nw * t0;
      const double stt_ = stt - 2.0 * t0 * st + nw * t0 * t0;
      const double stv_ = stv - t0 * sv;
      const double den = nw * stt_ - st_ * st_;
      return den != 0.0 ? (nw * stv_ - st_ * sv) / den : qnan();
    }
    case kLifetime: {
      const double tf =
          has_prev ? static_cast<double>(r.first()) : t_first();
      return (t_last - tf) / 1e3;
    }
    case kScrapeInterval: {
      if (!(has_prev || two)) return qnan();
      const double dt =
          (has_prev ? t_last - t_prev : t_last - t_first()) / 1e3;
      const int cnt = has_prev ? n : n - 1;
      return cnt > 0 ? dt / static_cast<double>(cnt) : qnan();
    }
    default: break;  // the counter funcs below
  }
  const double c_last = r.cmax(hi - 1);
  const double c_prev = lo >= 1 ? r.cmax(lo - 1) : -INFINITY;
  if (F == kIncrease || F == kIncreasePure) {
    if (has_prev) return c_last - c_prev;
    if (F == kIncreasePure) return c_last - (-v0);
    // new-series baseline: a counter born inside the window counts from 0
    double c_first = INFINITY;
    for (int i = lo; i < hi; ++i) c_first = nan_min(c_first, r.cval(i));
    const double d = two ? r.cval(lo + 1) - c_first : 0.0;
    const bool born = fabs(c_first + v0) < 10.0 * (fabs(d) + 1.0);
    return c_last - (born ? -v0 : c_first);
  }
  if (!(has_gprev || two)) return qnan();
  if (F == kRate) {
    double dt, dv;
    if (has_gprev) {
      dt = (t_last - t_prev) / 1e3;
      dv = c_last - c_prev;
    } else {
      double c_first = INFINITY;
      for (int i = lo; i < hi; ++i) c_first = nan_min(c_first, r.cval(i));
      dt = (t_last - t_first()) / 1e3;
      dv = c_last - c_first;
    }
    return dt > 0.0 ? dv / dt : qnan();
  }
  // irate: the last two samples
  const double c_l2 = two ? r.cval(hi - 2) : c_prev;
  const double t_l2 = two ? static_cast<double>(r.t(hi - 2)) : t_prev;
  const double dt = (t_last - t_l2) / 1e3;
  return dt > 0.0 ? (c_last - c_l2) / dt : qnan();
}

// The per-series rollup value at step t, its window found by two binary
// searches of the row in global memory (B9, and the global paths of K2
// and B5).
template <int F>
__device__ __forceinline__ double series_value(const Row& r, const Grid& g,
                                               int t) {
  const int32_t grid = static_cast<int32_t>(static_cast<uint32_t>(t) *
                                            static_cast<uint32_t>(g.step));
  const int hi = count_le(r.ts, 0, r.c, g.shift, grid);
  const int lo = count_le(r.ts, 0, hi, g.shift, wsub(grid, g.lookback));
  return window_value<F>(GlobalRow{r.ts, r.v, r.cv, r.cm, g.shift, r.mean},
                         g, t, lo, hi, r.mpi, r.v0);
}

// The arguments of the series passes: the tile's rows and their row-scan
// outputs.
struct Tile {
  const int32_t* ts;
  const double *vals, *cv, *cmax;
  const int32_t *slots, *counts, *mpi;
  const double *mean, *v0;
  int N;
};

__device__ __forceinline__ Row tile_row(const Tile& a, long long r) {
  return row_at(r, a.N, a.ts, a.vals, a.cv, a.cmax, a.slots, a.counts, a.mpi,
                a.mean, a.v0);
}

// The segment moments of partial_group_moments over the rows
// order[k0:k1] (offset by row0) at step t, in ascending row order.
template <int F>
__device__ __forceinline__ Moments group_moments(
    const Tile& a, const int32_t* __restrict__ order, int k0, int k1,
    long long row0, const Grid& g, int t) {
  Moments m = moments_empty();
  for (int k = k0; k < k1; ++k) {
    const double v = series_value<F>(tile_row(a, row0 + order[k]), g, t);
    if (v != v) continue;  // NaN: series absent at this step
    moments_add(m, v);
  }
  return m;
}

// aggr over the rows order[k0:k1] at step t: the moments finalized by
// the aggregate's code; NaN when no row is live.
template <int F>
__device__ __forceinline__ double group_value(
    const Tile& a, const int32_t* __restrict__ order, int k0, int k1,
    long long row0, const Grid& g, int aggr, int t) {
  return finalize_moments(group_moments<F>(a, order, k0, k1, row0, g, t),
                          aggr);
}

// The arguments of B9's chunked groups: a group of more than `chunk`
// members is walked in chunks of `chunk` consecutive members; chunk c of
// stream b's group grp writes its moments to partial slot b * slots +
// slot0[b, grp] + c, moment k at partial[(k * B * slots + slot) * T + t].
struct Chunks {
  const int32_t* slot0;
  int chunk, chunks;
  long long slots, plane;  // partial slots per stream; B * slots * T
  double* partial;
};

// B9: block ((b * G + grp) * chunks + c, step tile) of a [B, S, N] stack;
// the stream's rows are b * S + order[b, k], its groups starts[b, :].  A
// group of at most `chunk` members is finalized by its chunk-0 block in
// one pass (K2's); a larger one's chunk-c block writes the moments of
// members [c * chunk, (c + 1) * chunk), which fleet_fold folds.
template <int F>
__global__ void __launch_bounds__(kGroupThreads)
fleet_rollup_groups(Tile a, const int32_t* __restrict__ order,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ shifts,
                    const int32_t* __restrict__ min_tss,
                    const int32_t* __restrict__ aggrs, long long S, int G,
                    int T, Grid g, Chunks ch, double* __restrict__ out) {
  const long long bg = blockIdx.x / ch.chunks;
  const int c = static_cast<int>(blockIdx.x - bg * ch.chunks);
  const long long b = bg / G;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  g.shift = shifts[b];
  g.min_ts = min_tss[b];
  const int32_t* st = starts + b * (G + 1) + (bg - b * G);
  const int k0 = st[0], k1 = st[1];
  if (k1 - k0 <= ch.chunk) {
    if (c == 0)
      out[bg * T + t] = group_value<F>(a, order + b * S, k0, k1, b * S, g,
                                       aggrs[b], t);
    return;
  }
  const int c0 = k0 + c * ch.chunk;
  if (c0 >= k1) return;
  const Moments m = group_moments<F>(a, order + b * S, c0,
                                     min(c0 + ch.chunk, k1), b * S, g, t);
  double* p = ch.partial + (b * ch.slots + ch.slot0[bg] + c) * T + t;
  p[0] = m.cnt;
  p[ch.plane] = m.s1;
  p[2 * ch.plane] = m.s2;
  p[3 * ch.plane] = m.mn;
  p[4 * ch.plane] = m.mx;
}

// A chunked group's moments at one step: its n chunks' moments, chunk c at
// p[c * stride] (moment k a plane `pl` further on), merged in ascending
// chunk order as B13's combine folds its shards (mesh.cu
// combine_moments).  B9's fold and K2's (group_fold) share it, so a fleet
// stream and the per-stream K2 fold a group alike.
__device__ __forceinline__ Moments fold_chunks(const double* p,
                                               long long stride,
                                               long long pl, int n) {
  Moments acc = moments_empty();
  int c = 0;
  // kFoldBatch chunks' loads in flight before their merges, in order
  for (; c + kFoldBatch <= n; c += kFoldBatch, p += kFoldBatch * stride) {
    Moments q[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      const double* x = p + u * stride;
      q[u] = Moments{x[0], x[pl], x[2 * pl], x[3 * pl], x[4 * pl]};
    }
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) moments_merge(acc, q[u]);
  }
  for (; c < n; ++c, p += stride)
    moments_merge(acc, Moments{p[0], p[pl], p[2 * pl], p[3 * pl], p[4 * pl]});
  return acc;
}

// B9's fold, one thread per (stream, group, step) of a chunked group: its
// chunks' moments folded in chunk order, then finalized by the stream's
// aggregate.  Groups of at most `chunk` members were finalized already.
__global__ void __launch_bounds__(kPrepThreads)
fleet_fold(const int32_t* __restrict__ starts,
           const int32_t* __restrict__ aggrs, long long B, int G, int T,
           Chunks ch, double* __restrict__ out) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (e >= B * G * T) return;
  const long long bg = e / T;
  const int t = static_cast<int>(e - bg * T);
  const long long b = bg / G;
  const int32_t* st = starts + b * (G + 1) + (bg - b * G);
  const int m = st[1] - st[0];
  if (m <= ch.chunk) return;
  const int n = (m + ch.chunk - 1) / ch.chunk;
  out[bg * T + t] = finalize_moments(
      fold_chunks(ch.partial + (b * ch.slots + ch.slot0[bg]) * T + t, T,
                  ch.plane, n),
      aggrs[b]);
}

// ---------------------------------------------------------------------------
// K2 and B13's per-shard pass: the group walk over D row blocks.
// ---------------------------------------------------------------------------

constexpr int kStages = 2;       // member rows in flight in a block's ring
constexpr int kSpanBatch = 64;   // member rows whose spans a block finds at once
constexpr int kMaxStepsPerThread = 4;  // a block's steps: 128, 256 or 512
// Resident blocks an SM is compiled for (at most 80 registers a thread):
// the pass waits on each step's searches and divisions, so more resident
// warps help until registers spill (PERF.md records the sweep)
constexpr int kGroupBlocksPerSm = 6;

// The group layouts of the row blocks (ops/device_rollup.py GroupLayout):
// block d's group grp owns rows order[d][starts[d][grp] : starts[d][grp +
// 1]] of the block, ascending; a group of more than `chunk` members is
// walked in chunks of `chunk` consecutive members, chunk c writing partial
// slot pslot0[d] + slot0[d][grp] + c.  The grid's x axis enumerates, block
// by block, the G groups then the block's slots: unit0[d] is block d's
// first.
struct Layouts {
  const int32_t* order[kMaxShards];
  const int32_t* starts[kMaxShards];
  const int32_t* slot0[kMaxShards];
  long long unit0[kMaxShards + 1];
  long long pslot0[kMaxShards + 1];
  int chunk;
};

// The arguments of the group pass and its fold.
struct GroupArgs {
  RowBlocks rb;
  Layouts ly;
  const double *cv, *cmax, *mean;  // the row scan's scratch and row means
  const int32_t *slots, *mpi;      // ... its slots and maxPrevIntervals
  int N, G, T;
  Grid g;
  int aggr;
  int moments;                     // B13: the moments [D, M, G, T]
  int staged, steps, cap;          // the plan (ops/device_rollup.k2_plan)
  double* partial;                 // chunks' moments [5, pslot0[D], T]
  double* out;                     // K2 [G, T]; B13 [D, M, G, T]
};

// One member row of a block's batch: where it lies, its row-scan outputs,
// and the first window's lo and the last window's hi of the block's step
// tile (a window of the tile reads samples [lo_first - 1, hi_last) only).
struct MemberRow {
  long long row;  // in the concatenation: the row scan's outputs
  double mean;
  int local, c, lo_first, hi_last, slot;
  int32_t mpi;
};

// A member's staged span: samples [*s0, *s0 + *n) of its row.  *n = 0:
// no window of the tile holds a sample (every value NaN); *n = -1: the
// span overflows a stage and the row takes the global search.
__device__ __forceinline__ void span_of(const MemberRow& m, int cap, int* s0,
                                        int* n) {
  *s0 = m.lo_first > 0 ? m.lo_first - 1 : 0;
  const int len = m.hi_last - *s0;
  *n = m.hi_last <= m.lo_first ? 0 : (len <= cap ? len : -1);
}

__host__ __device__ __forceinline__ long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// A stage of the ring: cap timestamps, then planes a and b of cap doubles.
__host__ __device__ __forceinline__ long long stage_bytes(int cap) {
  return align16(4LL * cap) + 2 * align16(8LL * cap);
}

// Funcs that read values (or cv): plane a of a stage.
template <int F>
__host__ __device__ constexpr bool reads_values() {
  return !(F == kCount || F == kPresent || F == kTfirst || F == kTlast ||
           F == kTimestamp || F == kLag || F == kLifetime ||
           F == kScrapeInterval);
}

// One row block of the series passes and its row-scan outputs: rows
// [0, rows) of an [rows, N] tile, whose scan outputs (slots, mpi, mean)
// sit at row0 + row.  walk_rows reads a row through row_ts / row_vals
// (B15's ShardSource picks each row's source there).
struct RowSource {
  const int32_t* ts;
  const double* vals;
  const int32_t* counts;
  const double *cv, *cmax, *mean;  // the row scan's scratch and row means
  const int32_t *slots, *mpi;      // ... its slots and maxPrevIntervals
  long long row0;
  int N;
  __device__ __forceinline__ const int32_t* row_ts(int local) const {
    return ts + static_cast<long long>(local) * N;
  }
  __device__ __forceinline__ const double* row_vals(int local) const {
    return vals + static_cast<long long>(local) * N;
  }
};

template <class Src>
__device__ __forceinline__ Row member_row(const Src& s, const MemberRow& m) {
  const double* v = s.row_vals(m.local);
  const int slot = s.slots[m.row];
  const long long soff = static_cast<long long>(slot) * s.N;
  return Row{s.row_ts(m.local), v, slot < 0 ? v : s.cv + soff,
             slot < 0 ? v : s.cmax + soff, m.c, m.mpi, m.mean, 0.0};
}

// Start row m's copies into stage st: its span's timestamps and the
// planes the func reads (values, or cv and cmax of an irregular counter
// row), thread i taking samples i, i + 128, ...
template <int F, class Src>
__device__ __forceinline__ void stage_row(const Src& s, int cap,
                                          const MemberRow& m,
                                          unsigned char* st) {
  int s0, n;
  span_of(m, cap, &s0, &n);
  if (n <= 0) return;
  int32_t* sts = reinterpret_cast<int32_t*>(st);
  double* sa = reinterpret_cast<double*>(st + align16(4LL * cap));
  double* sb = sa + align16(8LL * cap) / 8;
  const int32_t* tsrc = s.row_ts(m.local) + s0;
  for (int i = threadIdx.x; i < n; i += kGroupThreads)
    copy4_async(sts + i, tsrc + i);
  constexpr bool kCounter = F <= kIrate;
  if (!reads_values<F>()) return;
  const long long soff = static_cast<long long>(m.slot) * s.N + s0;
  const double* asrc =
      kCounter && m.slot >= 0 ? s.cv + soff : s.row_vals(m.local) + s0;
  for (int i = threadIdx.x; i < n; i += kGroupThreads)
    copy8_async(sa + i, asrc + i);
  if (kCounter && m.slot >= 0)
    for (int i = threadIdx.x; i < n; i += kGroupThreads)
      copy8_async(sb + i, s.cmax + soff + i);
}

// The walk K2's group pass and B5's series pass share: rows local_of(k),
// k in [k0, k1), of one row source over the block's step tile [t0, t0 +
// nst), thread i taking steps i, i + 128, ... (at most
// kMaxStepsPerThread of them).  emit(mr, j, t, v) receives row mr's
// value v at step t = t0 + j * 128 + i, rows in ascending k.
//
// Staged path (`staged`): per batch of up to 64 rows, two threads a row
// find its span for the tile by count_le_from on its row (from a guess on
// the line through the row's ends); then rows stream through a ring of
// kStages stages by cp.async, kStages - 1 rows ahead of the one
// evaluated.  A thread finds each of its steps' window in the staged span
// by count_le_from from the same kind of guess (a regular scrape puts the
// guess on the answer: two probes, where the global search makes 2
// log2(N)); per-sample conversions (deriv's seconds, stddev/stdvar's
// centred values) are made once per staged sample.  A row whose span
// overflows a stage, and every row on the global path, is evaluated by
// series_value (binary searches of the row in global memory).  Both find
// the same window, and window_value is one function: a row's value at a
// step has the same bits on either path.  `rows` holds kSpanBatch rows,
// `ring` kStages stages of `cap` samples.
template <int F, class Src, class LocalOf, class Emit>
__device__ __forceinline__ void walk_rows(const Src& s, const Grid& g,
                                          int staged, int cap, int k0,
                                          int k1, int t0, int nst,
                                          MemberRow* rows,
                                          unsigned char* ring,
                                          LocalOf local_of, Emit emit) {
  constexpr bool kCounter = F <= kIrate;
  constexpr bool kCentred = F == kStddev || F == kStdvar;
  const int tid = threadIdx.x;
  const int32_t shift = g.shift;

  // every step of row mr by the global search
  const auto global_member = [&](const MemberRow& mr) {
    const Row r = member_row(s, mr);
#pragma unroll
    for (int j = 0; j < kMaxStepsPerThread; ++j) {
      const int i = j * kGroupThreads + tid;
      if (i < nst) emit(mr, j, t0 + i, series_value<F>(r, g, t0 + i));
    }
  };

  if (!staged) {
    for (int k = k0; k < k1; ++k) {
      MemberRow mr;
      mr.local = local_of(k);
      mr.row = s.row0 + mr.local;
      mr.c = min(s.counts[mr.local], s.N);
      mr.mpi = s.mpi[mr.row];
      mr.mean = kCentred ? s.mean[mr.row] : 0.0;
      global_member(mr);
    }
    return;
  }
  // the tile's first window start and last grid point
  const int32_t lo_t0 = wsub(
      static_cast<int32_t>(static_cast<uint32_t>(t0) *
                           static_cast<uint32_t>(g.step)),
      g.lookback);
  const int32_t grid1 =
      static_cast<int32_t>(static_cast<uint32_t>(t0 + nst - 1) *
                           static_cast<uint32_t>(g.step));
  const long long sbytes = stage_bytes(cap);
  for (int kb = k0; kb < k1; kb += kSpanBatch) {
    const int nb = min(kSpanBatch, k1 - kb);
    __syncthreads();  // the last batch's rows are read no more
    if (tid < 2 * nb) {
      MemberRow& mr = rows[tid >> 1];
      const int local = local_of(kb + (tid >> 1));
      const int32_t* trow = s.row_ts(local);
      const int c = min(s.counts[local], s.N);
      int32_t f0 = 0, f1 = 0;
      if (c > 0) {
        f0 = shifted(trow[0], shift);
        f1 = shifted(trow[c - 1], shift);
      }
      const float per = per_ms_of(f0, f1, c);
      if (tid & 1) {
        mr.hi_last = count_le_from(trow, c, shift, grid1,
                                   guess_count(grid1, f0, per, c));
      } else {
        mr.lo_first = count_le_from(trow, c, shift, lo_t0,
                                    guess_count(lo_t0, f0, per, c));
        mr.local = local;
        mr.row = s.row0 + local;
        mr.c = c;
        mr.slot = kCounter ? s.slots[mr.row] : -1;
        mr.mpi = s.mpi[mr.row];
        mr.mean = kCentred ? s.mean[mr.row] : 0.0;
      }
    }
    __syncthreads();
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < nb) stage_row<F>(s, cap, rows[j], ring + j * sbytes);
      commit_async();
    }
    for (int j = 0; j < nb; ++j) {
      const int ahead = j + kStages - 1;
      if (ahead < nb)
        stage_row<F>(s, cap, rows[ahead], ring + (ahead % kStages) * sbytes);
      commit_async();
      wait_async<kStages - 1>();  // row j's copies have landed
      const MemberRow& mr = rows[j];
      int s0, n;
      span_of(mr, cap, &s0, &n);
      unsigned char* st = ring + (j % kStages) * sbytes;
      const int32_t* sts = reinterpret_cast<const int32_t*>(st);
      double* sa = reinterpret_cast<double*>(st + align16(4LL * cap));
      double* sb = sa + align16(8LL * cap) / 8;
      // once per sample, each thread on the samples it copied
      if (kCentred)
        for (int i = tid; i < n; i += kGroupThreads) sa[i] = sa[i] - mr.mean;
      if (F == kDeriv)
        for (int i = tid; i < n; i += kGroupThreads)
          sb[i] = static_cast<double>(shifted(sts[i], shift)) / 1e3;
      __syncthreads();
      if (n > 0) {
        const StagedRow r{sts, sa, kCounter && mr.slot < 0 ? sa : sb, s0,
                          shift, s.row_ts(mr.local)};
        const int32_t f0 = shifted(sts[0], shift);
        const float per = per_ms_of(f0, shifted(sts[n - 1], shift), n);
#pragma unroll
        for (int jj = 0; jj < kMaxStepsPerThread; ++jj) {
          const int i = jj * kGroupThreads + tid;
          if (i < nst) {
            const int t = t0 + i;
            const int32_t grid = static_cast<int32_t>(
                static_cast<uint32_t>(t) * static_cast<uint32_t>(g.step));
            const int32_t lo_t = wsub(grid, g.lookback);
            const int hi = count_le_from(sts, n, shift, grid,
                                         guess_count(grid, f0, per, n));
            const int lo = count_le_from(sts, hi, shift, lo_t,
                                         guess_count(lo_t, f0, per, hi));
            emit(mr, jj, t,
                 window_value<F>(r, g, t, s0 + lo, s0 + hi, mr.mpi, 0.0));
          }
        }
      } else if (n < 0) {
        global_member(mr);
      } else {
        // no window of the tile holds a sample: every value is NaN
#pragma unroll
        for (int jj = 0; jj < kMaxStepsPerThread; ++jj) {
          const int i = jj * kGroupThreads + tid;
          if (i < nst) emit(mr, jj, t0 + i, qnan());
        }
      }
      __syncthreads();  // stage j % kStages is refilled next
    }
  }
}

// K2 rollup_aggregate_tile and B13's per-shard pass.  Block (x, y): a
// group or a chunk of row block d (see Layouts) and y's tile of `steps`
// steps; thread i takes steps i, i + 128, ... of the tile.  Members are
// walked in ascending order by walk_rows (staged or by the global search,
// as the plan says), each step's moments summed in registers.  A group
// finalizes its moments (K2), stores them (B13: [D, M, G, T]), or, as a
// chunk, writes them to its partial slot for group_fold.
template <int F>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocksPerSm)
group_pass(GroupArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ MemberRow rows[kSpanBatch];
  const long long x = blockIdx.x;
  int d = 0;
  while (d + 1 < a.rb.D && x >= a.ly.unit0[d + 1]) ++d;
  const int u = static_cast<int>(x - a.ly.unit0[d]);
  const int32_t* starts = a.ly.starts[d];
  const int chunk = a.ly.chunk;
  int grp, k0, k1;
  long long pslot = -1;  // a chunk's partial slot; -1: a whole group
  if (u < a.G) {
    grp = u;
    k0 = starts[grp];
    k1 = starts[grp + 1];
    if (k1 - k0 > chunk) return;  // its chunks' blocks walk it
  } else {
    const int p = u - a.G;
    const int32_t* slot0 = a.ly.slot0[d];
    int lo = 0, hi = a.G;  // the chunked group of slot p: the last whose
    while (lo < hi) {      // first slot is at most p
      const int mid = (lo + hi) >> 1;
      if (slot0[mid] <= p) lo = mid + 1;
      else hi = mid;
    }
    grp = lo - 1;
    k0 = starts[grp] + (p - slot0[grp]) * chunk;
    k1 = min(k0 + chunk, starts[grp + 1]);
    pslot = a.ly.pslot0[d] + p;
  }
  const int32_t* order = a.ly.order[d];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.y * a.steps;
  const int nst = min(a.steps, a.T - t0);
  Moments m[kMaxStepsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxStepsPerThread; ++j) m[j] = moments_empty();
  const RowSource src{a.rb.ts[d], a.rb.vals[d], a.rb.counts[d], a.cv,
                      a.cmax,     a.mean,       a.slots,        a.mpi,
                      a.rb.row0[d], a.N};
  walk_rows<F>(src, a.g, a.staged, a.cap, k0, k1, t0, nst, rows, ring,
               [&](int k) { return order[k]; },
               [&](const MemberRow&, int j, int, double v) {
                 if (v == v) moments_add(m[j], v);
               });

  const long long T = a.T;
#pragma unroll
  for (int j = 0; j < kMaxStepsPerThread; ++j) {
    const int i = j * kGroupThreads + tid;
    if (i >= nst) continue;
    const int t = t0 + i;
    if (pslot >= 0) {
      const long long pl = a.ly.pslot0[a.rb.D] * T;
      double* p = a.partial + pslot * T + t;
      p[0] = m[j].cnt;
      p[pl] = m[j].s1;
      p[2 * pl] = m[j].s2;
      p[3 * pl] = m[j].mn;
      p[4 * pl] = m[j].mx;
    } else if (a.moments) {
      const int M = moment_count(a.aggr);
      for (int k = 0; k < M; ++k)
        a.out[((static_cast<long long>(d) * M + k) * a.G + grp) * T + t] =
            moment_get(m[j], a.aggr, k);
    } else {
      a.out[grp * T + t] = finalize_moments(m[j], a.aggr);
    }
  }
}

// K2's and B13's fold, one thread per (row block, group, step) of a
// chunked group: its chunks' moments folded in chunk order (B9's
// fold_chunks), then finalized (K2) or stored as the block's moments
// (B13, whose combine then folds the blocks in order).
__global__ void __launch_bounds__(kPrepThreads)
group_fold(GroupArgs a) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const long long GT = static_cast<long long>(a.G) * a.T;
  if (e >= a.rb.D * GT) return;
  const int d = static_cast<int>(e / GT);
  const int grp = static_cast<int>((e - d * GT) / a.T);
  const int t = static_cast<int>(e - d * GT - static_cast<long long>(grp) *
                                              a.T);
  const int32_t* st = a.ly.starts[d] + grp;
  const int n_members = st[1] - st[0];
  if (n_members <= a.ly.chunk) return;
  const int n = (n_members + a.ly.chunk - 1) / a.ly.chunk;
  const Moments acc = fold_chunks(
      a.partial + (a.ly.pslot0[d] + a.ly.slot0[d][grp]) * a.T + t, a.T,
      a.ly.pslot0[a.rb.D] * a.T, n);
  if (a.moments) {
    const int M = moment_count(a.aggr);
    for (int k = 0; k < M; ++k)
      a.out[((static_cast<long long>(d) * M + k) * a.G + grp) * a.T + t] =
          moment_get(acc, a.aggr, k);
  } else {
    a.out[static_cast<long long>(grp) * a.T + t] =
        finalize_moments(acc, a.aggr);
  }
}

// B5 on the global path (the plan's, for a grid that wraps or spans no
// stage holds): one block per (row, 128-step tile), each step's window by
// series_value.  Row r's steps go to out[r * ldo + t] (ldo = T for a
// whole [S, T] output; B15 writes a time shard's block of a wider one).
template <int F>
__global__ void __launch_bounds__(kGroupThreads)
rollup_series(Tile a, int T, long long ldo, Grid g,
              double* __restrict__ out) {
  const long long r = blockIdx.x;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  out[r * ldo + t] = series_value<F>(tile_row(a, r), g, t);
}

// The arguments of B5's staged pass (the plan: ops/device_rollup.b5_plan).
struct SeriesArgs {
  RowSource src;
  Grid g;
  long long S, ldo;
  int T, rows, steps, cap;
  double* out;
};

// B5 on the staged path: block (x, y) walks rows [x * rows, (x + 1) *
// rows) over y's tile of `steps` steps with walk_rows, K2's staged walk,
// and writes each value to out[r * ldo + t], a warp's stores consecutive
// in t.  The same windows and window_value as the global path: the same
// bits.
template <int F>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocksPerSm)
series_pass(SeriesArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ MemberRow rows[kSpanBatch];
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows;
  const int nr = static_cast<int>(min(static_cast<long long>(a.rows),
                                      a.S - r0));
  const int t0 = blockIdx.y * a.steps;
  double* __restrict__ out = a.out;
  const long long ldo = a.ldo;
  walk_rows<F>(a.src, a.g, 1, a.cap, static_cast<int>(r0),
               static_cast<int>(r0) + nr, t0, min(a.steps, a.T - t0), rows,
               ring, [](int k) { return k; },
               [&](const MemberRow& mr, int, int t, double v) {
                 out[mr.local * ldo + t] = v;
               });
}

// B15's passes over the D (series, time) shards of one card: the row
// scan, the scratch pass and B5's staged series pass, one launch each.
// Shard d's rows r in [row0[d], row0[d + 1]) of the concatenation: a row
// whose halo and local columns are all valid is read in place, from the
// tile (ts[d] + local * ts_ld[d], width[d] columns, the shard's halo
// first); any other row from its compacted copy (cts + r * N, counts[r]
// valid samples), as src[r] says (mesh.cu halo_compact wrote both).
// Timestamps are raw in either source: the passes shift them by shift[d]
// in registers.  Shard d writes its [rows, T] block at out[d], row stride
// ldo[d].
struct ShardBlocks {
  const int32_t* ts[kMaxShards];
  const double* vals[kMaxShards];
  long long ts_ld[kMaxShards], vals_ld[kMaxShards];
  double* out[kMaxShards];
  long long ldo[kMaxShards];
  int width[kMaxShards];
  int32_t shift[kMaxShards];
  long long row0[kMaxShards + 1];
  long long unit0[kMaxShards + 1];  // the series pass's first block of d
  int D;
  const int32_t* cts;  // compacted rows [row0[D], N]
  const double* cvals;
  const int32_t* counts;  // [row0[D]]
  const int32_t* src;     // [row0[D]]: 1 = compacted
  int N;
};

__device__ __forceinline__ int shard_of(const ShardBlocks& b, long long r) {
  int d = 0;
  while (d + 1 < b.D && r >= b.row0[d + 1]) ++d;
  return d;
}

// Row r's timestamps and values, from its source.
__device__ __forceinline__ void shard_row(const ShardBlocks& b, int d,
                                          long long r, const int32_t** t,
                                          const double** v) {
  if (b.src[r]) {
    *t = b.cts + r * b.N;
    *v = b.cvals + r * b.N;
  } else {
    const long long local = r - b.row0[d];
    *t = b.ts[d] + local * b.ts_ld[d];
    *v = b.vals[d] + local * b.vals_ld[d];
  }
}

// walk_rows' row source over shard d of ShardBlocks (local rows of the
// shard; the scan's outputs at row0 + local).
struct ShardSource {
  const int32_t* ts;
  const double* vals;
  long long ts_ld, vals_ld;
  const int32_t* cts;  // the shard's compacted rows
  const double* cvals;
  const int32_t* src;
  const int32_t* counts;
  const double *cv, *cmax, *mean;
  const int32_t *slots, *mpi;
  long long row0;
  int N;
  __device__ __forceinline__ const int32_t* row_ts(int local) const {
    return src[local] ? cts + static_cast<long long>(local) * N
                      : ts + local * ts_ld;
  }
  __device__ __forceinline__ const double* row_vals(int local) const {
    return src[local] ? cvals + static_cast<long long>(local) * N
                      : vals + local * vals_ld;
  }
};

// B15's row scan: one warp per row of the D shards, each with its
// shard's shift (rollup_scan's outputs, from scan_row).
__global__ void __launch_bounds__(kPrepThreads)
shard_scan(ShardBlocks b, int32_t min_ts, int32_t step, int instant,
           int counter, int32_t* __restrict__ mpi,
           int32_t* __restrict__ slots, int32_t* __restrict__ n_irregular,
           double* __restrict__ mean) {
  const long long r =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  if (r >= b.row0[b.D]) return;  // uniform across the warp
  const int d = shard_of(b, r);
  const int32_t* t;
  const double* v;
  shard_row(b, d, r, &t, &v);
  const bool irregular = scan_row(
      t, v, min(b.counts[r], b.width[d]), b.width[d], b.shift[d], min_ts,
      step, instant, counter, mean != nullptr ? mean + r : nullptr, mpi + r);
  if ((threadIdx.x & 31) == 0)
    slots[r] = irregular ? atomicAdd(n_irregular, 1) : -1;
}

// B15's scratch pass: one warp per irregular row (rollup_prep's).
__global__ void __launch_bounds__(kPrepThreads)
shard_prep(ShardBlocks b, const int32_t* __restrict__ slots,
           double* __restrict__ cv, double* __restrict__ cmax) {
  const long long r =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  if (r >= b.row0[b.D]) return;  // uniform across the warp
  const int slot = slots[r];
  if (slot < 0) return;
  const int d = shard_of(b, r);
  const int32_t* t;
  const double* v;
  shard_row(b, d, r, &t, &v);
  const long long soff = static_cast<long long>(slot) * b.N;
  prep_row(v, min(b.counts[r], b.width[d]), false, 0.0, cv + soff,
           cmax + soff);
}

// The arguments of B15's series pass.
struct ShardArgs {
  ShardBlocks b;
  const double *cv, *cmax, *mean;
  const int32_t *slots, *mpi;
  Grid g;
  int T, staged, rows, steps, cap;
};

// B15's series pass: B5's series_pass over the D shards.  Block (x, y):
// rows [u * rows, (u + 1) * rows) of the shard d whose blocks hold x (u
// = x - unit0[d]) over y's tile of `steps` steps, walked by walk_rows on
// the staged path or by the global search (the plan's), each value
// stored into the shard's output block.  The time-valued funcs add the
// shard's shift / 1e3 (a float64 division) to the final value in the
// store: B5's value, then the reference's add-back.
template <int F>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocksPerSm)
shard_pass(ShardArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ MemberRow rows[kSpanBatch];
  constexpr bool kTimeValued = F == kTfirst || F == kTlast || F == kTimestamp;
  const long long x = blockIdx.x;
  const ShardBlocks& b = a.b;
  int d = 0;
  while (d + 1 < b.D && x >= b.unit0[d + 1]) ++d;
  const long long r0 = (x - b.unit0[d]) * a.rows;
  const int nr = static_cast<int>(
      min(static_cast<long long>(a.rows), b.row0[d + 1] - b.row0[d] - r0));
  const int t0 = blockIdx.y * a.steps;
  Grid g = a.g;
  g.shift = b.shift[d];
  const long long row0 = b.row0[d];
  const ShardSource src{b.ts[d],         b.vals[d],        b.ts_ld[d],
                        b.vals_ld[d],    b.cts + row0 * b.N,
                        b.cvals + row0 * b.N,              b.src + row0,
                        b.counts + row0, a.cv,             a.cmax,
                        a.mean,          a.slots,          a.mpi,
                        row0,            b.N};
  double* __restrict__ out = b.out[d];
  const long long ldo = b.ldo[d];
  const double add = static_cast<double>(g.shift) / 1e3;
  walk_rows<F>(src, g, a.staged, a.cap, static_cast<int>(r0),
               static_cast<int>(r0) + nr, t0, min(a.steps, a.T - t0), rows,
               ring, [](int k) { return k; },
               [&](const MemberRow& mr, int, int t, double v) {
                 out[mr.local * ldo + t] = kTimeValued ? v + add : v;
               });
}

// B12 decode_and_rollup: one block of 256 or 512 threads per row
// (grid-stride over the rows), in three phases a row:
//  1. decode: the row's two delta planes by decode_row_pair (K1's values
//     from two block scans a row) into a workspace;
//  2. scan: every thread checks its samples' regularity (counter funcs;
//     one __syncthreads_or), warp 0 finds mpi and, for stddev/stdvar, the
//     mean (scan_row: the row scan's own order of the sum, so the same
//     bits) and, for an irregular counter row, cv and cmax (prep_row);
//  3. series: thread i takes steps i, i + blockDim.x, ..., each window
//     found in the decoded row by count_le_from from a guess on the line
//     through the row's ends (two probes on a regular scrape, where a
//     binary search makes 2 log2(n)), then window_value reads the row.
// The decoded tile is never written, and the output equals K1 then B5 bit
// for bit.  The workspace is the row's values and timestamps (12 B per
// column) in dynamic shared memory when they fit the opt-in limit, else a
// global scratch slot per block; cv and cmax (counter funcs only) always
// sit in the block's scratch slot, so the scratch is blocks x n, never
// S x n.
struct DecodeArgs {
  const int32_t *ts_first, *ts_fd;
  const void* ts_d2;
  int ts_d2_bytes, ts_d2w;
  const int32_t *val_first, *val_fd;
  const void* val_d2;
  int val_d2_bytes, val_d2w;
  const double* scale;
  const int32_t* counts;
  long long S;
  int n;
};

// Diagnostic builds (tools/select_timing.py, -DVM_B12_STOP=k) end each
// row of B12 after phase k (1: decode, 2: scan); 0 runs every phase.
#ifndef VM_B12_STOP
#define VM_B12_STOP 0
#endif
#define VM_B12_STOP_AFTER(k)                              \
  if (VM_B12_STOP == (k)) {                               \
    if (threadIdx.x == 0) out[row * T] = v[0];            \
    __syncthreads();                                      \
    continue;                                             \
  }

// B12's block: 256 threads, or 512 where fewer than four 256-thread
// blocks fit an SM (decode_plan: a row's workspace is 87 KB at full
// width, so 2 blocks of 16 warps); at most 64 registers a thread
constexpr int kB12Threads = 512;

template <int F>
__global__ void __launch_bounds__(kB12Threads, 2)
decode_rollup(DecodeArgs a, int T, Grid g, int instant, int smem_ws,
              unsigned char* __restrict__ scratch, long long slot_bytes,
              double* __restrict__ out) {
  extern __shared__ double smem[];
  __shared__ uint2 warp_sums[kB12Threads / 32];
  __shared__ int32_t s_mpi;
  __shared__ double s_mean;
  constexpr bool kCounter = F <= kIrate;
  constexpr bool kCentred = F == kStddev || F == kStdvar;
  const int n = a.n;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  unsigned char* slot = scratch + blockIdx.x * slot_bytes;
  double* cv = reinterpret_cast<double*>(slot);
  double* cmax = cv + n;
  double* v = smem_ws ? smem : (kCounter ? cmax + n
                                          : reinterpret_cast<double*>(slot));
  int32_t* tsr = reinterpret_cast<int32_t*>(v + n);
  for (long long row = blockIdx.x; row < a.S; row += gridDim.x) {
    const int cnt = a.counts[row];
    decode_row_pair(
        PlaneRow{static_cast<uint32_t>(a.ts_first[row]),
                 static_cast<uint32_t>(a.ts_fd[row]),
                 static_cast<const unsigned char*>(a.ts_d2) +
                     row * a.ts_d2w * a.ts_d2_bytes,
                 a.ts_d2_bytes},
        PlaneRow{static_cast<uint32_t>(a.val_first[row]),
                 static_cast<uint32_t>(a.val_fd[row]),
                 static_cast<const unsigned char*>(a.val_d2) +
                     row * a.val_d2w * a.val_d2_bytes,
                 a.val_d2_bytes},
        n, cnt, a.scale[row], tsr, v, warp_sums);
    __syncthreads();
    VM_B12_STOP_AFTER(1);
    const int c = min(cnt, n);
    bool bad = false;
    if (kCounter)
      for (int i = tid; i < c; i += threads)
        bad |= irregular_value(v[i], i >= 1 ? v[i - 1] : 0.0, i);
    const bool irregular = kCounter && __syncthreads_or(bad);
    if (tid < 32) {
      scan_row(tsr, v, c, n, g.shift, g.min_ts, g.step, instant, 0,
               kCentred ? &s_mean : nullptr, &s_mpi);
      if (kCounter && irregular) prep_row(v, c, false, 0.0, cv, cmax);
    }
    __syncthreads();
    VM_B12_STOP_AFTER(2);
    const GlobalRow r{tsr,
                      v,
                      kCounter && irregular ? cv : v,
                      kCounter && irregular ? cmax : v,
                      g.shift,
                      kCentred ? s_mean : 0.0};
    const int32_t mpi = s_mpi;
    const int32_t f0 = c > 0 ? shifted(tsr[0], g.shift) : 0;
    const float per =
        per_ms_of(f0, c > 0 ? shifted(tsr[c - 1], g.shift) : 0, c);
    for (int t = tid; t < T; t += threads) {
      const int32_t grid = static_cast<int32_t>(static_cast<uint32_t>(t) *
                                                static_cast<uint32_t>(g.step));
      const int32_t lo_t = wsub(grid, g.lookback);
      const int hi = count_le_from(tsr, c, g.shift, grid,
                                   guess_count(grid, f0, per, c));
      const int lo = count_le_from(tsr, hi, g.shift, lo_t,
                                   guess_count(lo_t, f0, per, hi));
      out[row * T + t] = window_value<F>(r, g, t, lo, hi, mpi, 0.0);
    }
    __syncthreads();  // the workspace is rewritten for the next row
  }
}

Grid make_grid(int shift, int min_ts, int step, int lookback,
               double start_s) {
  Grid g;
  g.shift = shift;
  g.min_ts = min_ts;
  g.step = step;
  g.lookback = lookback;
  g.start_s = start_s;
  return g;
}

Tile make_tile(const void* ts, const void* vals, const void* cv,
               const void* cmax, const void* slots, const void* counts,
               const void* mpi, const void* mean, const void* v0, int N) {
  return Tile{static_cast<const int32_t*>(ts),
              static_cast<const double*>(vals),
              static_cast<const double*>(cv),
              static_cast<const double*>(cmax),
              static_cast<const int32_t*>(slots),
              static_cast<const int32_t*>(counts),
              static_cast<const int32_t*>(mpi),
              static_cast<const double*>(mean),
              static_cast<const double*>(v0), N};
}

constexpr int kFuncs = kScrapeInterval + 1;

// The arguments of one series pass, B5's or B9's.
struct PassArgs {
  Tile tile;
  const int32_t *order, *starts;
  const int32_t *shifts, *min_tss, *aggrs;  // B9
  long long S;                               // B9: rows per stream
  Chunks ch;                                 // B9
  int G, T;
  long long ldo;                             // B5: output row stride
  Grid g;
  int aggr;
  double* out;
};

template <int F>
void launch_fleet(dim3 grid, cudaStream_t st, const PassArgs& a) {
  fleet_rollup_groups<F><<<grid, kGroupThreads, 0, st>>>(
      a.tile, a.order, a.starts, a.shifts, a.min_tss, a.aggrs, a.S, a.G, a.T,
      a.g, a.ch, a.out);
}

template <int F>
void launch_series(dim3 grid, cudaStream_t st, const PassArgs& a) {
  rollup_series<F><<<grid, kGroupThreads, 0, st>>>(a.tile, a.T, a.ldo, a.g,
                                                   a.out);
}

// B5's staged pass, the ring's shared memory opted into above 48 KB.
template <int F>
cudaError_t launch_series_pass(dim3 grid, size_t smem, cudaStream_t st,
                               const SeriesArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&series_pass<F>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  series_pass<F><<<grid, kGroupThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// K2's and B13's group pass (and its fold when some group is chunked),
// the ring's shared memory opted into above 48 KB.
template <int F>
cudaError_t launch_group_pass(dim3 grid, size_t smem, cudaStream_t st,
                              const GroupArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&group_pass<F>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  group_pass<F><<<grid, kGroupThreads, smem, st>>>(a);
  return cudaGetLastError();
}

using GroupLaunch = cudaError_t (*)(dim3, size_t, cudaStream_t,
                                    const GroupArgs&);

template <int... F>
const GroupLaunch* group_table(std::integer_sequence<int, F...>) {
  static const GroupLaunch table[] = {&launch_group_pass<F>...};
  return table;
}

using Launch = void (*)(dim3, cudaStream_t, const PassArgs&);

// One launcher per func code, indexed by the code.
template <int... F>
const Launch* fleet_table(std::integer_sequence<int, F...>) {
  static const Launch table[] = {&launch_fleet<F>...};
  return table;
}

template <int... F>
const Launch* series_table(std::integer_sequence<int, F...>) {
  static const Launch table[] = {&launch_series<F>...};
  return table;
}

using SeriesLaunch = cudaError_t (*)(dim3, size_t, cudaStream_t,
                                     const SeriesArgs&);

template <int... F>
const SeriesLaunch* series_pass_table(std::integer_sequence<int, F...>) {
  static const SeriesLaunch table[] = {&launch_series_pass<F>...};
  return table;
}

// B15's series pass, the ring's shared memory opted into above 48 KB.
template <int F>
cudaError_t launch_shard_pass(dim3 grid, size_t smem, cudaStream_t st,
                              const ShardArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&shard_pass<F>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  shard_pass<F><<<grid, kGroupThreads, smem, st>>>(a);
  return cudaGetLastError();
}

using ShardLaunch = cudaError_t (*)(dim3, size_t, cudaStream_t,
                                    const ShardArgs&);

template <int... F>
const ShardLaunch* shard_pass_table(std::integer_sequence<int, F...>) {
  static const ShardLaunch table[] = {&launch_shard_pass<F>...};
  return table;
}

// B12's launch plan: the workspace in shared memory when the row's values
// and timestamps fit the opt-in limit (and `force_global` is 0), the
// block's threads, the grid the blocks resident on the card at once (at
// most S), and the global scratch those blocks need.
struct DecodePlan {
  int blocks, threads, smem_ws;
  size_t smem_bytes;
  long long slot_bytes;
};

using DecodeKernel = void (*)(DecodeArgs, int, Grid, int, int,
                              unsigned char*, long long, double*);

template <int F>
DecodeKernel decode_kernel() {
  return &decode_rollup<F>;
}

template <int... F>
const DecodeKernel* decode_table(std::integer_sequence<int, F...>) {
  static const DecodeKernel table[] = {decode_kernel<F>()...};
  return table;
}

int decode_plan(long long S, int n, int func, int force_global,
                DecodePlan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long row_bytes = 12LL * n;
  // the static shared memory of the kernel stays below 1 KiB
  p->smem_ws = !force_global && row_bytes + 1024 <= optin;
  p->smem_bytes = p->smem_ws ? static_cast<size_t>(row_bytes) : 0;
  const long long slot = (func <= kIrate ? 16LL * n : 0) +
                         (p->smem_ws ? 0 : row_bytes);
  p->slot_bytes = (slot + 7) / 8 * 8;
  const DecodeKernel k =
      decode_table(std::make_integer_sequence<int, kFuncs>())[func];
  if (p->smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p->smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 256 threads a block, or 512 where fewer than four blocks of 256 fit
  // an SM (the workspace's shared memory limits them): 32 warps either way
  for (p->threads = kB12Threads / 2;; p->threads = kB12Threads) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(k), p->threads,
        p->smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (p->threads == kB12Threads || per_sm >= 4) break;
  }
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  p->blocks = static_cast<int>(S < resident ? S : resident);
  return 0;
}

unsigned step_tiles(int T) {
  return static_cast<unsigned>((T + kGroupThreads - 1) / kGroupThreads);
}

// RowBlocks of D blocks from the host arrays of their pointers and row
// counts; false when D is outside [1, kMaxShards].  `ts` may be null (the
// scratch pass reads no timestamps).
bool make_blocks(int D, const void* const* ts, const void* const* vals,
                 const void* const* counts, const long long* rows,
                 RowBlocks* rb) {
  if (D < 1 || D > kMaxShards) return false;
  *rb = RowBlocks{};
  rb->D = D;
  for (int d = 0; d < D; ++d) {
    rb->ts[d] = ts != nullptr ? static_cast<const int32_t*>(ts[d]) : nullptr;
    rb->vals[d] = static_cast<const double*>(vals[d]);
    rb->counts[d] = static_cast<const int32_t*>(counts[d]);
    if (rows[d] < 0) return false;
    rb->row0[d + 1] = rb->row0[d] + rows[d];
  }
  return true;
}

// One block of S rows from one base pointer each (B9's stack).
RowBlocks one_block(const void* ts, const void* vals, const void* counts,
                    long long S) {
  RowBlocks rb{};
  rb.D = 1;
  rb.ts[0] = static_cast<const int32_t*>(ts);
  rb.vals[0] = static_cast<const double*>(vals);
  rb.counts[0] = static_cast<const int32_t*>(counts);
  rb.row0[1] = S;
  return rb;
}

unsigned warp_blocks(long long S) {
  const long long per_block = kPrepThreads / 32;
  return static_cast<unsigned>((S + per_block - 1) / per_block);
}

int scan(const RowBlocks& rb, int N, int shift, int min_ts,
         const void* shifts, const void* min_tss, long long rows_per_stream,
         int step, int instant, int counter, void* mpi, void* slots,
         void* n_irregular, void* mean, void* stream) {
  const long long S = rb.row0[rb.D];
  if (S <= 0) return 0;
  rollup_scan<<<warp_blocks(S), kPrepThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      rb, N, shift, min_ts, static_cast<const int32_t*>(shifts),
      static_cast<const int32_t*>(min_tss), rows_per_stream, step, instant,
      counter, static_cast<int32_t*>(mpi), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(n_irregular), static_cast<double*>(mean));
  return static_cast<int>(cudaGetLastError());
}

int prep(const RowBlocks& rb, const void* slots, const void* v0, int N,
         void* cv, void* cmax, void* stream) {
  const long long S = rb.row0[rb.D];
  if (S <= 0) return 0;
  rollup_prep<<<warp_blocks(S), kPrepThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      rb, static_cast<const int32_t*>(slots),
      static_cast<const double*>(v0), N, static_cast<double*>(cv),
      static_cast<double*>(cmax));
  return static_cast<int>(cudaGetLastError());
}

// B15's shards of one card as ShardBlocks: `desc` holds kShardFields
// values per shard (ops-side layout: parallel/mesh.py _shard_desc): the
// in-place ts and vals (the tile at the shard's first column) and their
// row strides, the width, the rows, the shift, the output block and its
// row stride.  `rows_per_unit` > 0 numbers the series pass's blocks.
constexpr int kShardFields = 9;

bool make_shards(int D, const long long* desc, const void* cts,
                 const void* cvals, const void* counts, const void* src,
                 int N, int rows_per_unit, ShardBlocks* b) {
  if (D < 1 || D > kMaxShards || N < 1) return false;
  *b = ShardBlocks{};
  b->D = D;
  for (int d = 0; d < D; ++d) {
    const long long* f = desc + static_cast<long long>(d) * kShardFields;
    b->ts[d] = reinterpret_cast<const int32_t*>(f[0]);
    b->ts_ld[d] = f[1];
    b->vals[d] = reinterpret_cast<const double*>(f[2]);
    b->vals_ld[d] = f[3];
    b->width[d] = static_cast<int>(f[4]);
    const long long rows = f[5];
    b->shift[d] = static_cast<int32_t>(f[6]);
    b->out[d] = reinterpret_cast<double*>(f[7]);
    b->ldo[d] = f[8];
    if (rows < 0 || f[4] < 1 || f[4] > N || f[6] < kI32Min ||
        f[6] > 2147483647LL)
      return false;
    b->row0[d + 1] = b->row0[d] + rows;
    b->unit0[d + 1] =
        b->unit0[d] +
        (rows_per_unit > 0 ? (rows + rows_per_unit - 1) / rows_per_unit : 0);
  }
  b->cts = static_cast<const int32_t*>(cts);
  b->cvals = static_cast<const double*>(cvals);
  b->counts = static_cast<const int32_t*>(counts);
  b->src = static_cast<const int32_t*>(src);
  b->N = N;
  return true;
}

}  // namespace

// The row scan of D row blocks (host arrays of their pointers and row
// counts): mpi, slots and mean per row of the concatenation.
extern "C" int vm_rollup_scan(int D, const void* const* ts,
                              const void* const* vals,
                              const void* const* counts,
                              const long long* rows, int N, int shift,
                              int min_ts, int step, int instant, int counter,
                              void* mpi, void* slots, void* n_irregular,
                              void* mean, void* stream) {
  RowBlocks rb;
  if (!make_blocks(D, ts, vals, counts, rows, &rb))
    return static_cast<int>(cudaErrorInvalidValue);
  return scan(rb, N, shift, min_ts, nullptr, nullptr, 1, step, instant,
              counter, mpi, slots, n_irregular, mean, stream);
}

// The row scan of a [B, S, N] stack: each stream's shift and min_ts.
extern "C" int vm_fleet_rollup_scan(const void* ts, const void* vals,
                                    const void* counts, long long B,
                                    long long S, int N, const void* shifts,
                                    const void* min_tss, int step,
                                    int instant, int counter, void* mpi,
                                    void* slots, void* n_irregular,
                                    void* mean, void* stream) {
  if (S <= 0) return 0;
  return scan(one_block(ts, vals, counts, B * S), N, 0, 0, shifts, min_tss,
              S, step, instant, counter, mpi, slots, n_irregular, mean,
              stream);
}

// The scratch pass of D row blocks' irregular rows (slots of the row
// scan of the same blocks).
extern "C" int vm_rollup_prep(int D, const void* const* vals,
                              const void* const* counts,
                              const long long* rows, int N,
                              const void* slots, void* cv, void* cmax,
                              void* stream) {
  RowBlocks rb;
  if (!make_blocks(D, nullptr, vals, counts, rows, &rb))
    return static_cast<int>(cudaErrorInvalidValue);
  return prep(rb, slots, nullptr, N, cv, cmax, stream);
}

// The scratch pass of a [B, S, N] stack, rebased by the [B, S] v0 plane.
extern "C" int vm_fleet_rollup_prep(const void* vals, const void* counts,
                                    const void* slots, const void* v0,
                                    long long B, long long S, int N, void* cv,
                                    void* cmax, void* stream) {
  return prep(one_block(nullptr, vals, counts, B * S), slots, v0, N, cv,
              cmax, stream);
}

// K2 (moments = 0: D = 1, out [G, T]) or B13's per-shard pass over D
// row blocks on one card (moments = 1: out [D, M, G, T], M =
// moment_count(aggr)): the group pass and, when some group has more than
// `chunk` members, the fold of its chunks' moments [5, sum(pslots), T] in
// `partial`.  Host arrays of D: the blocks' pointers and rows, their
// layouts' order, starts and slot0, and their partial slots (the
// layouts': ops/device_rollup.group_layout); cv ... mean are the row scan
// of the same blocks; staged, steps and cap the plan
// (ops/device_rollup.k2_plan).
extern "C" int vm_rollup_groups(
    int D, const void* const* ts, const void* const* vals,
    const void* const* counts, const long long* rows, const void* cv,
    const void* cmax, const void* slots, const void* mpi, const void* mean,
    const void* const* order, const void* const* starts,
    const void* const* slot0, const long long* pslots, int G, int N, int T,
    int shift, int min_ts, int step, int lookback, double start_s, int func,
    int aggr, int moments, int chunk, void* partial, int staged, int steps,
    int cap, void* out, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  GroupArgs a{};
  if (!make_blocks(D, ts, vals, counts, rows, &a.rb) || func < 0 ||
      func >= kFuncs || aggr < aSum || aggr > aGroup || chunk < 1 ||
      (!moments && D != 1) || steps < kGroupThreads ||
      steps > kMaxStepsPerThread * kGroupThreads ||
      steps % kGroupThreads != 0 || (staged && cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ly.chunk = chunk;
  for (int d = 0; d < D; ++d) {
    if (pslots[d] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.ly.order[d] = static_cast<const int32_t*>(order[d]);
    a.ly.starts[d] = static_cast<const int32_t*>(starts[d]);
    a.ly.slot0[d] = static_cast<const int32_t*>(slot0[d]);
    a.ly.unit0[d + 1] = a.ly.unit0[d] + G + pslots[d];
    a.ly.pslot0[d + 1] = a.ly.pslot0[d] + pslots[d];
  }
  const long long tiles = (T + steps - 1) / steps;
  if (a.ly.unit0[D] > 0x7fffffffLL || tiles > 65535 ||
      (a.ly.pslot0[D] > 0 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.cv = static_cast<const double*>(cv);
  a.cmax = static_cast<const double*>(cmax);
  a.mean = static_cast<const double*>(mean);
  a.slots = static_cast<const int32_t*>(slots);
  a.mpi = static_cast<const int32_t*>(mpi);
  a.N = N;
  a.G = G;
  a.T = T;
  a.g = make_grid(shift, min_ts, step, lookback, start_s);
  a.aggr = aggr;
  a.moments = moments;
  a.staged = staged;
  a.steps = steps;
  a.cap = cap;
  a.partial = static_cast<double*>(partial);
  a.out = static_cast<double*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = group_table(std::make_integer_sequence<int, kFuncs>())[func](
      dim3(static_cast<unsigned>(a.ly.unit0[D]), static_cast<unsigned>(tiles)),
      staged ? static_cast<size_t>(kStages * stage_bytes(cap)) : 0, st, a);
  if (e != cudaSuccess || a.ly.pslot0[D] == 0) return static_cast<int>(e);
  const long long n = D * static_cast<long long>(G) * T;
  group_fold<<<static_cast<unsigned>((n + kPrepThreads - 1) / kPrepThreads),
               kPrepThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// B9 over a [B, S, N] stack -> out [B, G, T]: the group pass and, when
// some group has more than `chunk` members (chunks > 1), the fold of its
// chunks' moments [5, B * pslots, T] in `partial`.  slot0 [B, G], chunk,
// chunks and pslots are the layout's (ops/device_rollup.py:fleet_layout).
extern "C" int vm_fleet_rollup_groups(
    const void* ts, const void* vals, const void* cv, const void* cmax,
    const void* slots, const void* counts, const void* mpi, const void* mean,
    const void* v0, const void* order, const void* starts, const void* shifts,
    const void* min_tss, const void* aggrs, long long B, long long S, int G,
    int N, int T, int step, int lookback, double start_s, int func,
    const void* slot0, int chunk, int chunks, long long pslots,
    void* partial, void* out, void* stream) {
  if (B <= 0 || G <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs || chunk < 1 || chunks < 1 ||
      (chunks > 1 && (pslots < 1 || partial == nullptr)) ||
      B * G * chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{};
  a.tile = make_tile(ts, vals, cv, cmax, slots, counts, mpi, mean, v0, N);
  a.order = static_cast<const int32_t*>(order);
  a.starts = static_cast<const int32_t*>(starts);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.min_tss = static_cast<const int32_t*>(min_tss);
  a.aggrs = static_cast<const int32_t*>(aggrs);
  a.S = S;
  a.G = G;
  a.T = T;
  a.g = make_grid(0, 0, step, lookback, start_s);
  a.ch = Chunks{static_cast<const int32_t*>(slot0), chunk, chunks, pslots,
                B * pslots * T, static_cast<double*>(partial)};
  a.out = static_cast<double*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fleet_table(std::make_integer_sequence<int, kFuncs>())[func](
      dim3(static_cast<unsigned>(B * G * chunks), step_tiles(T)), st, a);
  if (chunks > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long n = B * G * T;
    fleet_fold<<<static_cast<unsigned>((n + kPrepThreads - 1) / kPrepThreads),
                 kPrepThreads, 0, st>>>(a.starts, a.aggrs, B, G, T, a.ch,
                                        a.out);
  }
  return static_cast<int>(cudaGetLastError());
}

// B5 over an [S, N] tile -> out rows of stride ldo: the staged pass
// (staged = 1: `rows` rows and `steps` steps a block, stages of `cap`
// samples) or the global search (staged = 0), as the plan says
// (ops/device_rollup.b5_plan).  cv ... mean are the row scan's.
extern "C" int vm_rollup_series(const void* ts, const void* vals,
                                const void* cv, const void* cmax,
                                const void* slots, const void* counts,
                                const void* mpi, const void* mean,
                                long long S, int N, int T, int shift,
                                int min_ts, int step, int lookback,
                                double start_s, int func, void* out,
                                long long ldo, int staged, int rows,
                                int steps, int cap, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g = make_grid(shift, min_ts, step, lookback, start_s);
  if (!staged) {
    PassArgs a{};
    a.tile = make_tile(ts, vals, cv, cmax, slots, counts, mpi, mean,
                       nullptr, N);
    a.T = T;
    a.ldo = ldo;
    a.g = g;
    a.out = static_cast<double*>(out);
    series_table(std::make_integer_sequence<int, kFuncs>())[func](
        dim3(static_cast<unsigned>(S), step_tiles(T)), st, a);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = rows >= 1 ? (S + rows - 1) / rows : 0;
  const long long tiles = steps >= 1 ? (T + steps - 1) / steps : 0;
  if (rows < 1 || rows > kSpanBatch || steps < kGroupThreads ||
      steps > kMaxStepsPerThread * kGroupThreads ||
      steps % kGroupThreads != 0 || cap < 1 || cap > N ||
      blocks > 0x7fffffffLL || tiles > 65535 || S > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  SeriesArgs a{};
  a.src = RowSource{static_cast<const int32_t*>(ts),
                    static_cast<const double*>(vals),
                    static_cast<const int32_t*>(counts),
                    static_cast<const double*>(cv),
                    static_cast<const double*>(cmax),
                    static_cast<const double*>(mean),
                    static_cast<const int32_t*>(slots),
                    static_cast<const int32_t*>(mpi),
                    0,
                    N};
  a.g = g;
  a.S = S;
  a.ldo = ldo;
  a.T = T;
  a.rows = rows;
  a.steps = steps;
  a.cap = cap;
  a.out = static_cast<double*>(out);
  return static_cast<int>(
      series_pass_table(std::make_integer_sequence<int, kFuncs>())[func](
          dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)),
          static_cast<size_t>(kStages * stage_bytes(cap)), st, a));
}

// B15's row scan over the D shards of one card (desc: make_shards):
// mpi, slots and mean per row of the concatenation, n_irregular (zeroed
// here first) counting the counter funcs' irregular rows.
extern "C" int vm_time_shards_scan(int D, const long long* desc,
                                   const void* cts, const void* cvals,
                                   const void* counts, const void* src,
                                   int N, int min_ts, int step, int instant,
                                   int counter, void* mpi, void* slots,
                                   void* n_irregular, void* mean,
                                   void* stream) {
  ShardBlocks b;
  if (!make_shards(D, desc, cts, cvals, counts, src, N, 0, &b))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long S = b.row0[D];
  const cudaError_t e = cudaMemsetAsync(n_irregular, 0, sizeof(int32_t),
                                        static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess || S <= 0) return static_cast<int>(e);
  shard_scan<<<warp_blocks(S), kPrepThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      b, min_ts, step, instant, counter, static_cast<int32_t*>(mpi),
      static_cast<int32_t*>(slots), static_cast<int32_t*>(n_irregular),
      static_cast<double*>(mean));
  return static_cast<int>(cudaGetLastError());
}

// B15's scratch pass over the same shards' irregular rows.
extern "C" int vm_time_shards_prep(int D, const long long* desc,
                                   const void* cts, const void* cvals,
                                   const void* counts, const void* src,
                                   int N, const void* slots, void* cv,
                                   void* cmax, void* stream) {
  ShardBlocks b;
  if (!make_shards(D, desc, cts, cvals, counts, src, N, 0, &b))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long S = b.row0[D];
  if (S <= 0) return 0;
  shard_prep<<<warp_blocks(S), kPrepThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int32_t*>(slots), static_cast<double*>(cv),
      static_cast<double*>(cmax));
  return static_cast<int>(cudaGetLastError());
}

// B15's series pass over the same shards -> each shard's [rows, T] block
// (desc's output and row stride): B5's staged pass (staged = 1: `rows`
// rows and `steps` steps a block, stages of `cap` samples) or the global
// search (staged = 0: rows 1, steps kGroupThreads), as b5_plan says for
// the card's rows of N columns; cv ... mean are the scan's.
extern "C" int vm_time_shards_series(
    int D, const long long* desc, const void* cts, const void* cvals,
    const void* counts, const void* src, int N, const void* cv,
    const void* cmax, const void* slots, const void* mpi, const void* mean,
    int T, int min_ts, int step, int lookback, double start_s, int func,
    int staged, int rows, int steps, int cap, void* stream) {
  if (T <= 0) return 0;
  ShardArgs a{};
  if (func < 0 || func >= kFuncs || rows < 1 || rows > kSpanBatch ||
      steps < kGroupThreads || steps > kMaxStepsPerThread * kGroupThreads ||
      steps % kGroupThreads != 0 || (staged && (cap < 1 || cap > N)) ||
      !make_shards(D, desc, cts, cvals, counts, src, N, rows, &a.b))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = a.b.unit0[D];
  const long long tiles = (T + steps - 1) / steps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cv = static_cast<const double*>(cv);
  a.cmax = static_cast<const double*>(cmax);
  a.mean = static_cast<const double*>(mean);
  a.slots = static_cast<const int32_t*>(slots);
  a.mpi = static_cast<const int32_t*>(mpi);
  a.g = make_grid(0, min_ts, step, lookback, start_s);
  a.T = T;
  a.staged = staged;
  a.rows = rows;
  a.steps = steps;
  a.cap = cap;
  return static_cast<int>(
      shard_pass_table(std::make_integer_sequence<int, kFuncs>())[func](
          dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)),
          staged ? static_cast<size_t>(kStages * stage_bytes(cap)) : 0,
          static_cast<cudaStream_t>(stream), a));
}

// B12's plan for S rows of n columns: *blocks to launch and the global
// scratch in bytes they need (see decode_plan).
extern "C" int vm_decode_rollup_plan(long long S, int n, int func,
                                     int force_global, int* blocks,
                                     long long* scratch_bytes) {
  *blocks = 0;
  *scratch_bytes = 0;
  if (S <= 0 || n <= 0) return 0;
  if (func < 0 || func >= kFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodePlan p;
  const int rc = decode_plan(S, n, func, force_global, &p);
  if (rc != 0) return rc;
  *blocks = p.blocks;
  *scratch_bytes = p.slot_bytes * p.blocks;
  return 0;
}

// B12 over S rows -> out [S, T]; `scratch` holds the bytes
// vm_decode_rollup_plan asked for, for the same S, n, func, force_global.
extern "C" int vm_decode_rollup(
    const void* ts_first, const void* ts_fd, const void* ts_d2,
    int ts_d2_bytes, int ts_d2w, const void* val_first, const void* val_fd,
    const void* val_d2, int val_d2_bytes, int val_d2w, const void* scale,
    const void* counts, long long S, int n, int T, int min_ts, int step,
    int lookback, double start_s, int instant, int func, int force_global,
    void* scratch, void* out, void* stream) {
  if (S <= 0 || n <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b : {ts_d2_bytes, val_d2_bytes})
    if (b != 1 && b != 2 && b != 4)
      return static_cast<int>(cudaErrorInvalidValue);
  DecodePlan p;
  const int rc = decode_plan(S, n, func, force_global, &p);
  if (rc != 0) return rc;
  DecodeArgs a;
  a.ts_first = static_cast<const int32_t*>(ts_first);
  a.ts_fd = static_cast<const int32_t*>(ts_fd);
  a.ts_d2 = ts_d2;
  a.ts_d2_bytes = ts_d2_bytes;
  a.ts_d2w = ts_d2w;
  a.val_first = static_cast<const int32_t*>(val_first);
  a.val_fd = static_cast<const int32_t*>(val_fd);
  a.val_d2 = val_d2;
  a.val_d2_bytes = val_d2_bytes;
  a.val_d2w = val_d2w;
  a.scale = static_cast<const double*>(scale);
  a.counts = static_cast<const int32_t*>(counts);
  a.S = S;
  a.n = n;
  const DecodeKernel k =
      decode_table(std::make_integer_sequence<int, kFuncs>())[func];
  k<<<static_cast<unsigned>(p.blocks), p.threads, p.smem_bytes,
      static_cast<cudaStream_t>(stream)>>>(
      a, T, make_grid(0, min_ts, step, lookback, start_s), instant, p.smem_ws,
      static_cast<unsigned char*>(scratch), p.slot_bytes,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
