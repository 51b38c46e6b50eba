// K2 rollup_aggregate_tile: fused aggr(rollup(m[window])) -> [G, T],
// B5 rollup_tile: the per-series rollup -> [S, T], B9
// fleet_rollup_aggregate_tile: K2 over a stack of B streams -> [B, G, T],
// B12 decode_and_rollup: K1's row decode fused into B5 -> [S, T], and
// B13's per-shard pass: K2's group walk writing its moments -> [M, G, T].
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
// window by binary search on the sorted row and reads the samples it needs
// directly; one device function, series_value, computes every func for
// all three kernels.
//
// Launches:
//  1. rollup_scan, one warp per row: the row's maxPrevInterval mpi
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
//  3. K2: rollup_groups, one block per (group, 128-step tile), one thread
//     per step: loops over the group's member rows in ascending row order
//     (a stable sort of the group ids, computed once per tile by the
//     caller), evaluates series_value and accumulates cnt/s1/s2/min/max in
//     registers, then finalizes.  No [S, T] intermediate is written and no
//     float atomics are used, so a result is the same on every run.
//     B5: rollup_series, one block per (row, 128-step tile), writes
//     series_value to [S, T].
//     B9: fleet_rollup_groups, K2's pass with a stream axis: one block per
//     (stream, group, 128-step tile).  The block reads its stream's shift,
//     min_ts and aggregate code from [B] arrays and walks the stream's
//     group members from a [B, S] order and [B, G + 1] starts (built once
//     per upload of the bucket: a member's group ids are fixed while it
//     lives).  The row scan and the scratch pass take the B x S rows as one
//     tile, with the shift and min_ts of each row's stream.  The reference
//     computes all eight aggregates and gathers one (:694-700); the block
//     finalizes only its stream's, with the same NaN where cnt is 0, so
//     padded rows (counts 0), padded groups and padded slots come out NaN.
//     A group of more than R = chunk members (FLEET_CHUNK, 64) is split
//     into chunks of R consecutive members, one block each: one group of
//     8192 rows was 8 x 3 blocks on 132 SMs, each thread walking 8192 rows;
//     in chunks it is 8 x 128 x 3, as many (row, step) walks as the
//     by-instance bucket's 8 x 256 x 3 blocks of 32 rows.  A chunk's block writes its moments to a partial slot
//     (wrapper-allocated [5, B x slots, T]; the layout numbers each
//     stream's chunks, slot0) and fleet_fold, a second launch, merges a
//     group's chunks in ascending chunk order with moments_merge and
//     finalizes them, B13's combine (mesh.cu).  A second launch rather than
//     a cluster fold: a group's chunk count is not bounded by a cluster's
//     16 blocks, and the fold reads ~1 MB.  Chunk boundaries depend only on
//     the group's own size, so a stream shard (B14) gets B9's bits; count,
//     group, min and max equal K2's single pass bit for bit (extrema keep
//     the first of equal values in ascending order), the sums differ only
//     in association.  Groups of at most R members keep the single pass,
//     and a bucket with none larger launches no fold.
//
//  4. B12 (replaces victoriametrics_tpu/ops/device_decode.py:
//     decode_and_rollup, decode_tiles then rollup_tile in one jit):
//     decode_rollup, one 256-thread block per row (grid-stride over the
//     rows, as many blocks as the card holds at once).  The block decodes
//     the row's two delta planes with K1's decode_row (decode.cuh) into a
//     workspace, runs scan_row and, for an irregular counter row,
//     prep_row on it (the functions rollup_scan and rollup_prep run), and
//     its threads evaluate series_value<F> for the row's steps.  The
//     decoded tile is never written, and the output equals K1 then B5 bit
//     for bit.  The workspace is the row's values and timestamps (12 B
//     per column) in dynamic shared memory up to the opt-in limit (above
//     48 KB through cudaFuncSetAttribute), else a global scratch slot per
//     resident block; cv and cmax always sit in the block's scratch slot,
//     so the scratch is blocks x n columns, never S x n.
//  5. B13's per-shard pass (replaces the partial_group_moments half of
//     victoriametrics_tpu/parallel/mesh.py:sharded_rollup_aggregate):
//     rollup_group_moments, K2's block and group walk, writing the
//     aggregate's moments (moments.cuh, in MOMENTS order) to [M, G, T];
//     mesh.cu combines the shards.
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
// column and plane) and writes [S, T]; B13's pass writes [M, G, T].
// The scan pass reads the values once (8 B/sample) for the counter funcs
// and stddev/stdvar only; the series pass reads about 2 log2(N) + window
// timestamps and values per (series, step) from L1/L2, since a block's 128
// threads walk the same row.  The design keeps every intermediate of the
// [S, T] rollup in registers; its distance from the byte bound is recorded
// in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

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

// True when a value breaks regularity: NaN, -0.0, or below its
// predecessor (a counter reset).
__device__ __forceinline__ bool irregular_at(const double* __restrict__ vrow,
                                             int i) {
  const double v = vrow[i];
  if (v != v || __double_as_longlong(v) == kNegZeroBits) return true;
  return i >= 1 && v < vrow[i - 1];
}

// The row scan of one row, run by every lane of one warp: returns (on
// every lane) whether the row is irregular when `counter`, writes the
// mean of its valid samples to *mean when `mean` is given, and its
// maxPrevInterval to *mpi (lane 0).  K2, B5 and B9 scan their rows with
// rollup_scan below, B12 the row it has just decoded.
__device__ bool scan_row(const int32_t* trow, const double* vrow, int c,
                         int N, int32_t shift, int32_t min_ts, int32_t step,
                         int instant, int counter, double* mean,
                         int32_t* mpi) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  bool irregular = false;
  if (counter) {
    for (int base = 0; base < c && !irregular; base += 32) {
      const int i = base + lane;
      irregular = __any_sync(full, i < c && irregular_at(vrow, i));
    }
  }
  if (mean != nullptr) {
    double s = 0.0;
    for (int i = lane; i < c; i += 32) s += vrow[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(full, s, o);
    if (lane == 0) *mean = s / static_cast<double>(c > 1 ? c : 1);
  }
  if (lane != 0) return irregular;
  if (instant) {
    *mpi = step;
    return irregular;
  }
  // 0.6 quantile of the last <= 20 intervals among samples >= min_ts
  const int base = c - 21 > 0 ? c - 21 : 0;
  int32_t tv[21];
  bool ok[21];
  for (int k = 0; k < 21; ++k) {
    const int idx = base + k;
    const int cl = idx < N - 1 ? idx : N - 1;
    tv[k] = shifted(trow[cl], shift);
    ok[k] = idx < c && tv[k] >= min_ts;
  }
  float d[20];
  int n = 0;
  for (int k = 0; k < 20; ++k) {
    if (ok[k] && ok[k + 1]) {
      const float x = static_cast<float>(wsub(tv[k + 1], tv[k]));
      int p = n++;
      while (p > 0 && d[p - 1] > x) {  // insertion sort, ascending
        d[p] = d[p - 1];
        --p;
      }
      d[p] = x;
    }
  }
  int32_t si = 0;
  if (n >= 1) {
    const float rank = __double2float_rn(0.6 * static_cast<double>(n - 1));
    const int lo_i = static_cast<int>(floorf(rank));
    const int hi_i = static_cast<int>(ceilf(rank));
    const float v_lo = d[lo_i];
    const float v_hi = d[hi_i];
    const float q = __fadd_rn(
        v_lo, __fmul_rn(__fsub_rn(rank, static_cast<float>(lo_i)),
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
  *mpi = r;
  return irregular;
}

// One warp per row: regularity (slot -1, or a scratch slot) when
// `counter`, the row mean when `mean` is given, and mpi.
// `shifts` / `min_tss` (B9): the values of each stream of rows_per_stream
// rows, in place of the scalars.
__global__ void __launch_bounds__(kPrepThreads)
rollup_scan(const int32_t* __restrict__ ts, const double* __restrict__ vals,
            const int32_t* __restrict__ counts, long long S, int N,
            int32_t shift, int32_t min_ts, const int32_t* __restrict__ shifts,
            const int32_t* __restrict__ min_tss, long long rows_per_stream,
            int32_t step, int instant, int counter,
            int32_t* __restrict__ mpi, int32_t* __restrict__ slots,
            int32_t* __restrict__ n_irregular, double* __restrict__ mean) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // uniform across the warp
  if (shifts != nullptr) {
    const long long b = row / rows_per_stream;
    shift = shifts[b];
    min_ts = min_tss[b];
  }
  const int c = min(counts[row], N);
  const long long off = row * static_cast<long long>(N);
  const bool irregular = scan_row(
      ts + off, vals + off, c, N, shift, min_ts, step, instant, counter,
      mean != nullptr ? mean + row : nullptr, mpi + row);
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
rollup_prep(const double* __restrict__ vals,
            const int32_t* __restrict__ counts,
            const int32_t* __restrict__ slots,
            const double* __restrict__ v0, long long S, int N,
            double* __restrict__ cv, double* __restrict__ cmax) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  if (row >= S) return;  // uniform across the warp
  const int slot = slots[row];
  if (slot < 0) return;  // regular row: cv = cmax = values
  const long long soff = static_cast<long long>(slot) * N;
  prep_row(vals + row * static_cast<long long>(N), min(counts[row], N),
           v0 != nullptr, v0 != nullptr ? v0[row] : 0.0, cv + soff,
           cmax + soff);
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

// The per-series rollup value at step t: the branches of
// device_rollup.py:rollup_tile, operation for operation.  NaN = no value.
// The func is a template argument, so each kernel instance reads only the
// samples its func needs.
template <int F>
__device__ __forceinline__ double series_value(const Row& r, const Grid& g,
                                               int t) {
  const int32_t grid = static_cast<int32_t>(static_cast<uint32_t>(t) *
                                            static_cast<uint32_t>(g.step));
  const int32_t lo_t = wsub(grid, g.lookback);
  const int32_t sh = g.shift;
  const int hi = count_le(r.ts, 0, r.c, sh, grid);
  const int lo = count_le(r.ts, 0, hi, sh, lo_t);
  if (hi <= lo) return qnan();  // empty window
  const int n = hi - lo;
  const int32_t t_prev_i = lo >= 1 ? shifted(r.ts[lo - 1], sh) : kI32Min;
  const bool has_prev = lo >= 1 && t_prev_i >= g.min_ts;
  const bool two = n >= 2;
  const double nw = static_cast<double>(n);
  const double t_last = static_cast<double>(shifted(r.ts[hi - 1], sh));
  // read only on the branches that use it
  const auto t_first = [&]() {
    return static_cast<double>(shifted(r.ts[lo], sh));
  };
  const double t_prev = static_cast<double>(t_prev_i);
  // prevValue only within maxPrevInterval of the window start
  const bool has_gprev = has_prev && t_prev_i > wsub(lo_t, r.mpi);
  switch (F) {
    case kCount: return nw;
    case kPresent: return 1.0;
    case kSum:
    case kAvg: {
      double s = 0.0;
      for (int i = lo; i < hi; ++i) s += r.v[i];
      return F == kSum ? s : s / nw;
    }
    case kStddev:
    case kStdvar: {
      double s1 = 0.0, s2 = 0.0;
      for (int i = lo; i < hi; ++i) {
        const double x = r.v[i] - r.mean;
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
        m = F == kMin ? nan_min(m, r.v[i]) : nan_max(m, r.v[i]);
      return m;
    }
    case kTfirst: return t_first() / 1e3 + g.start_s;
    case kTlast:
    case kTimestamp: return t_last / 1e3 + g.start_s;
    case kLag: return (static_cast<double>(grid) - t_last) / 1e3;
    case kFirst: return r.v[lo];
    case kLast:
    case kDefault: return r.v[hi - 1];
    case kChanges: {
      double s = 0.0;
      for (int i = lo; i < hi; ++i)
        if (i >= 1 && r.v[i] != r.v[i - 1]) s += 1.0;
      const double boundary = lo >= 1 && r.v[lo] != r.v[lo - 1] ? 1.0 : 0.0;
      return s - (has_prev ? 0.0 : boundary);
    }
    case kDelta: {
      const double v_first = r.v[lo];
      const double d = two ? r.v[lo + 1] - v_first : 0.0;
      const bool born = fabs(v_first + r.v0) < 10.0 * (fabs(d) + 1.0);
      const double base = has_prev ? r.v[lo - 1] : (born ? -r.v0 : v_first);
      return r.v[hi - 1] - base;
    }
    case kIdelta: {
      if (!(two || has_gprev)) return qnan();
      const double prev = two ? r.v[hi - 2] : r.v[lo - 1];
      return r.v[hi - 1] - prev;
    }
    case kDerivFast: {
      if (!(has_gprev || two)) return qnan();
      const double base_v = has_gprev ? r.v[lo - 1] : r.v[lo];
      const double base_t = has_gprev ? t_prev : t_first();
      const double dt = (t_last - base_t) / 1e3;
      return dt > 0.0 ? (r.v[hi - 1] - base_v) / dt : qnan();
    }
    case kDeriv: {
      if (!two) return qnan();
      double st = 0.0, stt = 0.0, sv = 0.0, stv = 0.0;
      for (int i = lo; i < hi; ++i) {
        const double ts_s = static_cast<double>(shifted(r.ts[i], sh)) / 1e3;
        st += ts_s;
        stt += ts_s * ts_s;
        sv += r.v[i];
        stv += ts_s * r.v[i];
      }
      const double t0 = t_first() / 1e3;
      const double st_ = st - nw * t0;
      const double stt_ = stt - 2.0 * t0 * st + nw * t0 * t0;
      const double stv_ = stv - t0 * sv;
      const double den = nw * stt_ - st_ * st_;
      return den != 0.0 ? (nw * stv_ - st_ * sv) / den : qnan();
    }
    case kLifetime: {
      const double tf =
          has_prev ? static_cast<double>(shifted(r.ts[0], sh)) : t_first();
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
  const double c_last = r.cm[hi - 1];
  const double c_prev = lo >= 1 ? r.cm[lo - 1] : -INFINITY;
  if (F == kIncrease || F == kIncreasePure) {
    if (has_prev) return c_last - c_prev;
    if (F == kIncreasePure) return c_last - (-r.v0);
    // new-series baseline: a counter born inside the window counts from 0
    double c_first = INFINITY;
    for (int i = lo; i < hi; ++i) c_first = nan_min(c_first, r.cv[i]);
    const double d = two ? r.cv[lo + 1] - c_first : 0.0;
    const bool born = fabs(c_first + r.v0) < 10.0 * (fabs(d) + 1.0);
    return c_last - (born ? -r.v0 : c_first);
  }
  if (!(has_gprev || two)) return qnan();
  if (F == kRate) {
    double dt, dv;
    if (has_gprev) {
      dt = (t_last - t_prev) / 1e3;
      dv = c_last - c_prev;
    } else {
      double c_first = INFINITY;
      for (int i = lo; i < hi; ++i) c_first = nan_min(c_first, r.cv[i]);
      dt = (t_last - t_first()) / 1e3;
      dv = c_last - c_first;
    }
    return dt > 0.0 ? dv / dt : qnan();
  }
  // irate: the last two samples
  const double c_l2 = two ? r.cv[hi - 2] : c_prev;
  const double t_l2 =
      two ? static_cast<double>(shifted(r.ts[hi - 2], sh)) : t_prev;
  const double dt = (t_last - t_l2) / 1e3;
  return dt > 0.0 ? (c_last - c_l2) / dt : qnan();
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

template <int F>
__global__ void __launch_bounds__(kGroupThreads)
rollup_groups(Tile a, const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, int T, Grid g, int aggr,
              double* __restrict__ out) {
  const long long grp = blockIdx.x;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  out[grp * T + t] = group_value<F>(a, order, starts[grp], starts[grp + 1], 0,
                                    g, aggr, t);
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

// B9's fold, one thread per (stream, group, step) of a chunked group: its
// chunks' moments merged in ascending chunk order, as B13's combine folds
// its shards (mesh.cu combine_moments), then finalized by the stream's
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
  const long long pl = ch.plane;
  const double* p = ch.partial + (b * ch.slots + ch.slot0[bg]) * T + t;
  Moments acc = moments_empty();
  int c = 0;
  // kFoldBatch chunks' loads in flight before their merges, in order
  for (; c + kFoldBatch <= n; c += kFoldBatch, p += kFoldBatch * T) {
    Moments q[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      const double* x = p + u * T;
      q[u] = Moments{x[0], x[pl], x[2 * pl], x[3 * pl], x[4 * pl]};
    }
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) moments_merge(acc, q[u]);
  }
  for (; c < n; ++c, p += T)
    moments_merge(acc, Moments{p[0], p[pl], p[2 * pl], p[3 * pl], p[4 * pl]});
  out[bg * T + t] = finalize_moments(acc, aggrs[b]);
}

// B13's per-shard pass: K2's group walk, writing the aggregate's moments
// (moment_count of them, in their stored order) as [M, G, T] instead of
// finalizing them.
template <int F>
__global__ void __launch_bounds__(kGroupThreads)
rollup_group_moments(Tile a, const int32_t* __restrict__ order,
                     const int32_t* __restrict__ starts, int G, int T,
                     Grid g, int aggr, double* __restrict__ out) {
  const long long grp = blockIdx.x;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  const Moments m = group_moments<F>(a, order, starts[grp], starts[grp + 1],
                                     0, g, t);
  const long long plane = static_cast<long long>(G) * T;
  for (int k = 0; k < moment_count(aggr); ++k)
    out[k * plane + grp * T + t] = moment_get(m, aggr, k);
}

// B5: row r's steps go to out[r * ldo + t] (ldo = T for a whole [S, T]
// output; B15 writes a time shard's block of a wider one).
template <int F>
__global__ void __launch_bounds__(kGroupThreads)
rollup_series(Tile a, int T, long long ldo, Grid g,
              double* __restrict__ out) {
  const long long r = blockIdx.x;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  out[r * ldo + t] = series_value<F>(tile_row(a, r), g, t);
}

// B12 decode_and_rollup: one block of kDecodeThreads threads per row
// (grid-stride over the rows).  The block decodes the row's two delta
// planes with K1's row decode into a workspace, scans it (mpi, mean,
// regularity) and, for an irregular counter row, writes cv and cmax, each
// with the functions K2 and B5 use; then its threads compute
// series_value<F> for the row's steps.  The workspace is the row's
// values and timestamps in dynamic shared memory (12 B per column) when
// they fit the opt-in limit, else a global scratch slot per block; cv and
// cmax (counter funcs only) always sit in the block's scratch slot, so
// the scratch is blocks x n, never S x n.
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

template <int F>
__global__ void __launch_bounds__(kDecodeThreads)
decode_rollup(DecodeArgs a, int T, Grid g, int instant, int smem_ws,
              unsigned char* __restrict__ scratch, long long slot_bytes,
              double* __restrict__ out) {
  extern __shared__ double smem[];
  __shared__ uint32_t warp_sums[kDecodeWarps];
  __shared__ int32_t s_mpi;
  __shared__ double s_mean;
  __shared__ int s_irregular;
  constexpr bool kCounter = F <= kIrate;
  constexpr bool kCentred = F == kStddev || F == kStdvar;
  const int n = a.n;
  unsigned char* slot = scratch + blockIdx.x * slot_bytes;
  double* cv = reinterpret_cast<double*>(slot);
  double* cmax = cv + n;
  double* v = smem_ws ? smem : (kCounter ? cmax + n
                                          : reinterpret_cast<double*>(slot));
  int32_t* tsr = reinterpret_cast<int32_t*>(v + n);
  for (long long row = blockIdx.x; row < a.S; row += gridDim.x) {
    const int cnt = a.counts[row];
    decode_row_any(a.ts_d2_bytes, static_cast<uint32_t>(a.ts_first[row]),
                   static_cast<uint32_t>(a.ts_fd[row]),
                   static_cast<const unsigned char*>(a.ts_d2) +
                       row * a.ts_d2w * a.ts_d2_bytes,
                   n, cnt, 0.0, tsr, nullptr, warp_sums);
    decode_row_any(a.val_d2_bytes, static_cast<uint32_t>(a.val_first[row]),
                   static_cast<uint32_t>(a.val_fd[row]),
                   static_cast<const unsigned char*>(a.val_d2) +
                       row * a.val_d2w * a.val_d2_bytes,
                   n, 0, a.scale[row], nullptr, v, warp_sums);
    __syncthreads();
    const int c = min(cnt, n);
    if (threadIdx.x < 32) {
      const bool irregular = scan_row(tsr, v, c, n, g.shift, g.min_ts,
                                      g.step, instant, kCounter,
                                      kCentred ? &s_mean : nullptr, &s_mpi);
      if (kCounter && irregular) prep_row(v, c, false, 0.0, cv, cmax);
      if (threadIdx.x == 0) s_irregular = irregular;
    }
    __syncthreads();
    Row r;
    r.ts = tsr;
    r.v = v;
    r.cv = kCounter && s_irregular ? cv : v;
    r.cm = kCounter && s_irregular ? cmax : v;
    r.c = c;
    r.mpi = s_mpi;
    r.mean = kCentred ? s_mean : 0.0;
    r.v0 = 0.0;
    for (int t = threadIdx.x; t < T; t += kDecodeThreads)
      out[row * T + t] = series_value<F>(r, g, t);
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

// The arguments of one series pass, K2's, B5's or B9's.
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
void launch_groups(dim3 grid, cudaStream_t st, const PassArgs& a) {
  rollup_groups<F><<<grid, kGroupThreads, 0, st>>>(
      a.tile, a.order, a.starts, a.T, a.g, a.aggr, a.out);
}

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

template <int F>
void launch_moments(dim3 grid, cudaStream_t st, const PassArgs& a) {
  rollup_group_moments<F><<<grid, kGroupThreads, 0, st>>>(
      a.tile, a.order, a.starts, a.G, a.T, a.g, a.aggr, a.out);
}

using Launch = void (*)(dim3, cudaStream_t, const PassArgs&);

// One launcher per func code, indexed by the code.
template <int... F>
const Launch* groups_table(std::integer_sequence<int, F...>) {
  static const Launch table[] = {&launch_groups<F>...};
  return table;
}

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

template <int... F>
const Launch* moments_table(std::integer_sequence<int, F...>) {
  static const Launch table[] = {&launch_moments<F>...};
  return table;
}

// B12's launch plan: the workspace in shared memory when the row's values
// and timestamps fit the opt-in limit (and `force_global` is 0), the grid
// the blocks resident on the card at once (at most S), and the global
// scratch those blocks need.
struct DecodePlan {
  int blocks, smem_ws;
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(k), kDecodeThreads,
      p->smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  p->blocks = static_cast<int>(S < resident ? S : resident);
  return 0;
}

unsigned step_tiles(int T) {
  return static_cast<unsigned>((T + kGroupThreads - 1) / kGroupThreads);
}

int scan(const void* ts, const void* vals, const void* counts, long long S,
         int N, int shift, int min_ts, const void* shifts,
         const void* min_tss, long long rows_per_stream, int step,
         int instant, int counter, void* mpi, void* slots, void* n_irregular,
         void* mean, void* stream) {
  if (S <= 0) return 0;
  const long long per_block = kPrepThreads / 32;
  const unsigned blocks = static_cast<unsigned>((S + per_block - 1) /
                                                per_block);
  rollup_scan<<<blocks, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const double*>(vals),
      static_cast<const int32_t*>(counts), S, N, shift, min_ts,
      static_cast<const int32_t*>(shifts),
      static_cast<const int32_t*>(min_tss), rows_per_stream, step, instant,
      counter, static_cast<int32_t*>(mpi), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(n_irregular), static_cast<double*>(mean));
  return static_cast<int>(cudaGetLastError());
}

int prep(const void* vals, const void* counts, const void* slots,
         const void* v0, long long S, int N, void* cv, void* cmax,
         void* stream) {
  if (S <= 0) return 0;
  const long long per_block = kPrepThreads / 32;
  const unsigned blocks = static_cast<unsigned>((S + per_block - 1) /
                                                per_block);
  rollup_prep<<<blocks, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(vals), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(slots), static_cast<const double*>(v0), S,
      N, static_cast<double*>(cv), static_cast<double*>(cmax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vm_rollup_scan(const void* ts, const void* vals,
                              const void* counts, long long S, int N,
                              int shift, int min_ts, int step, int instant,
                              int counter, void* mpi, void* slots,
                              void* n_irregular, void* mean, void* stream) {
  return scan(ts, vals, counts, S, N, shift, min_ts, nullptr, nullptr, 1,
              step, instant, counter, mpi, slots, n_irregular, mean, stream);
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
  return scan(ts, vals, counts, B * S, N, 0, 0, shifts, min_tss, S, step,
              instant, counter, mpi, slots, n_irregular, mean, stream);
}

extern "C" int vm_rollup_prep(const void* vals, const void* counts,
                              const void* slots, long long S, int N,
                              void* cv, void* cmax, void* stream) {
  return prep(vals, counts, slots, nullptr, S, N, cv, cmax, stream);
}

// The scratch pass of a [B, S, N] stack, rebased by the [B, S] v0 plane.
extern "C" int vm_fleet_rollup_prep(const void* vals, const void* counts,
                                    const void* slots, const void* v0,
                                    long long B, long long S, int N, void* cv,
                                    void* cmax, void* stream) {
  return prep(vals, counts, slots, v0, B * S, N, cv, cmax, stream);
}

extern "C" int vm_rollup_groups(const void* ts, const void* vals,
                                const void* cv, const void* cmax,
                                const void* slots, const void* counts,
                                const void* mpi, const void* mean,
                                const void* order, const void* starts,
                                long long G, int N, int T, int shift,
                                int min_ts, int step, int lookback,
                                double start_s, int func, int aggr, void* out,
                                void* stream) {
  if (G <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{};
  a.tile = make_tile(ts, vals, cv, cmax, slots, counts, mpi, mean, nullptr,
                     N);
  a.order = static_cast<const int32_t*>(order);
  a.starts = static_cast<const int32_t*>(starts);
  a.T = T;
  a.g = make_grid(shift, min_ts, step, lookback, start_s);
  a.aggr = aggr;
  a.out = static_cast<double*>(out);
  groups_table(std::make_integer_sequence<int, kFuncs>())[func](
      dim3(static_cast<unsigned>(G), step_tiles(T)),
      static_cast<cudaStream_t>(stream), a);
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

extern "C" int vm_rollup_series(const void* ts, const void* vals,
                                const void* cv, const void* cmax,
                                const void* slots, const void* counts,
                                const void* mpi, const void* mean,
                                long long S, int N, int T, int shift,
                                int min_ts, int step, int lookback,
                                double start_s, int func, void* out,
                                long long ldo, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{};
  a.tile = make_tile(ts, vals, cv, cmax, slots, counts, mpi, mean, nullptr,
                     N);
  a.T = T;
  a.ldo = ldo;
  a.g = make_grid(shift, min_ts, step, lookback, start_s);
  a.out = static_cast<double*>(out);
  series_table(std::make_integer_sequence<int, kFuncs>())[func](
      dim3(static_cast<unsigned>(S), step_tiles(T)),
      static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// B13's per-shard pass over one shard's tile -> out [M, G, T], M =
// moment_count(aggr).
extern "C" int vm_rollup_group_moments(
    const void* ts, const void* vals, const void* cv, const void* cmax,
    const void* slots, const void* counts, const void* mpi, const void* mean,
    const void* order, const void* starts, long long G, int N, int T,
    int shift, int min_ts, int step, int lookback, double start_s, int func,
    int aggr, void* out, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  if (func < 0 || func >= kFuncs || aggr < aSum || aggr > aGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{};
  a.tile = make_tile(ts, vals, cv, cmax, slots, counts, mpi, mean, nullptr,
                     N);
  a.order = static_cast<const int32_t*>(order);
  a.starts = static_cast<const int32_t*>(starts);
  a.G = static_cast<int>(G);
  a.T = T;
  a.g = make_grid(shift, min_ts, step, lookback, start_s);
  a.aggr = aggr;
  a.out = static_cast<double*>(out);
  moments_table(std::make_integer_sequence<int, kFuncs>())[func](
      dim3(static_cast<unsigned>(G), step_tiles(T)),
      static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
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
  k<<<static_cast<unsigned>(p.blocks), kDecodeThreads, p.smem_bytes,
      static_cast<cudaStream_t>(stream)>>>(
      a, T, make_grid(0, min_ts, step, lookback, start_s), instant, p.smem_ws,
      static_cast<unsigned char*>(scratch), p.slot_bytes,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
