// K2 rollup_aggregate_tile: fused aggr(rollup(m[window])) -> [G, T].
//
// Replaces victoriametrics_tpu/ops/device_rollup.py:rollup_aggregate_tile,
// a jax.jit program of rollup_tile (the rate / increase / increase_pure /
// irate branches over _masked_window_reduce, _remove_counter_resets and
// _max_prev_interval_tile) followed by partial_group_moments and
// finalize_group_moments.  On the TPU the window reduce is a dense
// [S, 256-chunk, T] compare-and-reduce, because gathers are slow there.
// Here each (series, step) finds its window by binary search on the
// sorted row and reads the few samples it needs directly.
//
// Two or three launches:
//  1. rollup_scan, one warp per row: the row's maxPrevInterval mpi
//     (_max_prev_interval_tile), and whether the row is regular: no NaN,
//     no -0.0 and no decrease on its valid prefix.  On a regular row the
//     reset-corrected counter cv (_remove_counter_resets) and its running
//     maximum cmax both equal the values themselves, so the group pass
//     reads the tile's values directly.  Each irregular row takes a slot
//     (an atomic counter; slots only address scratch, so their order does
//     not reach the result).
//  2. rollup_prep, only when some row is irregular: one warp per irregular
//     row writes cv and cmax into its slot of an [irregular rows, N]
//     scratch pair.  Clean counters need no scratch at all; a row with a
//     reset or a NaN costs 16 B per column.
//  3. rollup_groups, one block per (group, 128-step tile), one thread per
//     step: loops over the group's member rows in ascending row order (a
//     stable sort of the group ids, computed once per tile by the caller),
//     evaluates the series value with the reference's formulas and
//     accumulates cnt/s1/s2/min/max in registers, then finalizes.  No
//     [S, T] intermediate is written and no float atomics are used, so a
//     result is the same on every run.
//
// Faithfulness to the reference:
//  * c_last and c_prev are max-reductions of cv over "ts <= bound" in the
//    reference; they equal cv[hi-1] / cv[lo-1] only when cv never
//    decreases, which a negative value after a reset breaks.  So they are
//    read from the running maximum cmax, and c_first (a min over the
//    window) is a loop over the window's samples.
//  * jnp.max / jnp.min propagate NaN where CUDA's fmax / fmin drop it:
//    nan_max / nan_min below propagate.
//  * cv is values + (prefix sum of drops), which turns -0.0 into +0.0; a
//    row holding -0.0 is therefore irregular and goes through the scratch.
//  * mpi is float32 arithmetic in the reference: 0.6 * (n - 1) in float64
//    cast to float32, a float32 quantile interpolation, truncation to
//    int32, then the int32 jitter table.  The library is built with
//    --fmad=false so no multiply-add is contracted.
//  * Windows are searched within [0, counts[row]); timestamps are shifted
//    by `shift` in wrapping int32 arithmetic like the reference's
//    ts - shift.
//
// Bound: bytes.  The function must read each valid sample's timestamp and
// value once (12 B/sample) and write [G, T] float64.  The scan pass reads
// the values once (8 B/sample) and writes nothing per sample on regular
// rows; the group pass reads about 2 log2(N) + window timestamps and values
// per (series, step) from L1/L2, since a block's 128 threads walk the same
// row.  The design keeps every intermediate of the [S, T] rollup in
// registers; its distance from the byte bound is recorded in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrepThreads = 256;
constexpr int kGroupThreads = 128;
constexpr int32_t kI32Min = -2147483647 - 1;
constexpr long long kNegZeroBits =
    static_cast<long long>(0x8000000000000000ULL);

enum Func { kRate = 0, kIncrease = 1, kIncreasePure = 2, kIrate = 3 };
enum Aggr {
  kSum = 0, kCount = 1, kAvg = 2, kMin = 3, kMax = 4, kStddev = 5,
  kStdvar = 6, kGroup = 7
};

__device__ __forceinline__ double qnan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ double nan_max(double a, double b) {
  if (a != a || b != b) return qnan();
  return a > b ? a : b;
}

__device__ __forceinline__ double nan_min(double a, double b) {
  if (a != a || b != b) return qnan();
  return a < b ? a : b;
}

// ts - shift with int32 wraparound.
__device__ __forceinline__ int32_t shifted(int32_t t, int32_t shift) {
  return static_cast<int32_t>(static_cast<uint32_t>(t) -
                              static_cast<uint32_t>(shift));
}

// True when a value breaks regularity: NaN, -0.0, or below its
// predecessor (a counter reset).
__device__ __forceinline__ bool irregular_at(const double* __restrict__ vrow,
                                             int i) {
  const double v = vrow[i];
  if (v != v || __double_as_longlong(v) == kNegZeroBits) return true;
  return i >= 1 && v < vrow[i - 1];
}

// One warp per row: regularity (slot -1, or a scratch slot) and mpi.
__global__ void __launch_bounds__(kPrepThreads)
rollup_scan(const int32_t* __restrict__ ts, const double* __restrict__ vals,
            const int32_t* __restrict__ counts, long long S, int N,
            int32_t shift, int32_t min_ts, int32_t step, int instant,
            int32_t* __restrict__ mpi, int32_t* __restrict__ slots,
            int32_t* __restrict__ n_irregular) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // uniform across the warp
  const unsigned full = 0xffffffffu;
  const int c = min(counts[row], N);
  const long long off = row * static_cast<long long>(N);
  const int32_t* trow = ts + off;
  const double* vrow = vals + off;
  bool irregular = false;
  for (int base = 0; base < c && !irregular; base += 32) {
    const int i = base + lane;
    irregular = __any_sync(full, i < c && irregular_at(vrow, i));
  }
  if (lane != 0) return;
  slots[row] = irregular ? atomicAdd(n_irregular, 1) : -1;
  if (instant) {
    mpi[row] = step;
    return;
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
      const int32_t dt = static_cast<int32_t>(
          static_cast<uint32_t>(tv[k + 1]) - static_cast<uint32_t>(tv[k]));
      const float x = static_cast<float>(dt);
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
  mpi[row] = r;
}

// One warp per irregular row: cv and cmax over the row's valid prefix,
// into the row's scratch slot.
__global__ void __launch_bounds__(kPrepThreads)
rollup_prep(const double* __restrict__ vals,
            const int32_t* __restrict__ counts,
            const int32_t* __restrict__ slots, long long S, int N,
            double* __restrict__ cv, double* __restrict__ cmax) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // uniform across the warp
  const int slot = slots[row];
  if (slot < 0) return;  // regular row: cv = cmax = values
  const unsigned full = 0xffffffffu;
  const int c = min(counts[row], N);
  const double* vrow = vals + row * static_cast<long long>(N);
  const long long soff = static_cast<long long>(slot) * N;
  double carry_sum = 0.0;
  double carry_max = -INFINITY;
  for (int base = 0; base < c; base += 32) {
    const int i = base + lane;
    double v = 0.0, drop = 0.0;
    if (i < c) {
      v = vrow[i];
      if (i >= 1) {
        const double prev = vrow[i - 1];
        if (v < prev) drop = (prev - v) * 8.0 < prev ? prev - v : prev;
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
      cv[soff + i] = cvv;
      cmax[soff + i] = m;
    }
    carry_max = __shfl_sync(full, m, 31);
  }
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

// min of cv over the window [lo, hi), NaN-propagating.
__device__ __forceinline__ double window_min(const double* __restrict__ cvrow,
                                             int lo, int hi) {
  double m = INFINITY;
  for (int i = lo; i < hi; ++i) m = nan_min(m, cvrow[i]);
  return m;
}

// The per-series rollup value at one step: the rate / increase /
// increase_pure / irate branches of device_rollup.py:rollup_tile.  c_first
// (the window loop) is read only on the branches that use it.
__device__ double series_value(const int32_t* __restrict__ trow,
                               const double* __restrict__ cvrow,
                               const double* __restrict__ cmrow, int c,
                               int32_t mpi, int32_t shift, int32_t min_ts,
                               int32_t grid, int32_t lo_t, int func) {
  const int hi = count_le(trow, 0, c, shift, grid);
  const int lo = count_le(trow, 0, hi, shift, lo_t);
  if (hi <= lo) return qnan();  // empty window
  const int32_t t_prev_i = lo >= 1 ? shifted(trow[lo - 1], shift) : kI32Min;
  const bool has_prev = lo >= 1 && t_prev_i >= min_ts;
  const bool two = hi - lo >= 2;
  const double c_last = cmrow[hi - 1];
  const double c_prev = lo >= 1 ? cmrow[lo - 1] : -INFINITY;
  if (func == kIncrease || func == kIncreasePure) {
    if (has_prev) return c_last - c_prev;
    if (func == kIncreasePure) return c_last - (-0.0);
    // new-series baseline: a counter born inside the window counts from 0
    const double c_first = window_min(cvrow, lo, hi);
    const double d = two ? cvrow[lo + 1] - c_first : 0.0;
    const bool born = fabs(c_first + 0.0) < 10.0 * (fabs(d) + 1.0);
    return c_last - (born ? -0.0 : c_first);
  }
  // prevValue only within maxPrevInterval of the window start
  const int32_t gate = static_cast<int32_t>(static_cast<uint32_t>(lo_t) -
                                            static_cast<uint32_t>(mpi));
  const bool has_gprev = has_prev && t_prev_i > gate;
  if (!(has_gprev || two)) return qnan();
  const double t_last = static_cast<double>(shifted(trow[hi - 1], shift));
  const double t_prev = static_cast<double>(t_prev_i);
  if (func == kRate) {
    double dt, dv;
    if (has_gprev) {
      dt = (t_last - t_prev) / 1e3;
      dv = c_last - c_prev;
    } else {
      dt = (t_last - static_cast<double>(shifted(trow[lo], shift))) / 1e3;
      dv = c_last - window_min(cvrow, lo, hi);
    }
    return dt > 0.0 ? dv / dt : qnan();
  }
  // irate: the last two samples
  const double c_l2 = two ? cvrow[hi - 2] : c_prev;
  const double t_l2 =
      two ? static_cast<double>(shifted(trow[hi - 2], shift)) : t_prev;
  const double dt = (t_last - t_l2) / 1e3;
  return dt > 0.0 ? (c_last - c_l2) / dt : qnan();
}

__global__ void __launch_bounds__(kGroupThreads)
rollup_groups(const int32_t* __restrict__ ts,
              const double* __restrict__ vals, const double* __restrict__ cv,
              const double* __restrict__ cmax,
              const int32_t* __restrict__ slots,
              const int32_t* __restrict__ counts,
              const int32_t* __restrict__ mpi,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, int N, int T,
              int32_t shift, int32_t min_ts, int32_t step, int32_t lookback,
              int func, int aggr, double* __restrict__ out) {
  const long long g = blockIdx.x;
  const int t = blockIdx.y * kGroupThreads + threadIdx.x;
  if (t >= T) return;
  const int32_t grid = static_cast<int32_t>(static_cast<uint32_t>(t) *
                                            static_cast<uint32_t>(step));
  const int32_t lo_t = static_cast<int32_t>(static_cast<uint32_t>(grid) -
                                            static_cast<uint32_t>(lookback));
  double cnt = 0.0, s1 = 0.0, s2 = 0.0;
  double mn = INFINITY, mx = -INFINITY;
  const int k_end = starts[g + 1];
  for (int k = starts[g]; k < k_end; ++k) {
    const long long r = order[k];
    const long long off = r * static_cast<long long>(N);
    const int slot = slots[r];
    const long long soff = static_cast<long long>(slot) * N;
    const double* cvrow = slot < 0 ? vals + off : cv + soff;
    const double* cmrow = slot < 0 ? vals + off : cmax + soff;
    const double v = series_value(ts + off, cvrow, cmrow, min(counts[r], N),
                                  mpi[r], shift, min_ts, grid, lo_t, func);
    if (v != v) continue;  // NaN: series absent at this step
    cnt += 1.0;
    s1 += v;
    s2 += v * v;
    mn = v < mn ? v : mn;
    mx = v > mx ? v : mx;
  }
  double res;
  switch (aggr) {
    case kSum: res = s1; break;
    case kCount: res = cnt; break;
    case kAvg: res = s1 / cnt; break;
    case kMin: res = mn; break;
    case kMax: res = mx; break;
    case kStddev:
    case kStdvar: {
      const double mean = s1 / cnt;
      const double var = nan_max(s2 / cnt - mean * mean, 0.0);
      res = aggr == kStddev ? sqrt(var) : var;
      break;
    }
    default: res = 1.0; break;  // group
  }
  out[g * T + t] = cnt > 0.0 ? res : qnan();
}

}  // namespace

extern "C" int vm_rollup_scan(const void* ts, const void* vals,
                              const void* counts, long long S, int N,
                              int shift, int min_ts, int step, int instant,
                              void* mpi, void* slots, void* n_irregular,
                              void* stream) {
  if (S <= 0) return 0;
  const long long per_block = kPrepThreads / 32;
  const unsigned blocks = static_cast<unsigned>((S + per_block - 1) /
                                                per_block);
  rollup_scan<<<blocks, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const double*>(vals),
      static_cast<const int32_t*>(counts), S, N, shift, min_ts, step,
      instant, static_cast<int32_t*>(mpi), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(n_irregular));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vm_rollup_prep(const void* vals, const void* counts,
                              const void* slots, long long S, int N,
                              void* cv, void* cmax, void* stream) {
  if (S <= 0) return 0;
  const long long per_block = kPrepThreads / 32;
  const unsigned blocks = static_cast<unsigned>((S + per_block - 1) /
                                                per_block);
  rollup_prep<<<blocks, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(vals), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(slots), S, N, static_cast<double*>(cv),
      static_cast<double*>(cmax));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vm_rollup_groups(const void* ts, const void* vals,
                                const void* cv, const void* cmax,
                                const void* slots, const void* counts,
                                const void* mpi, const void* order,
                                const void* starts, long long G, int N, int T,
                                int shift, int min_ts, int step, int lookback,
                                int func, int aggr, void* out, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(G),
                  static_cast<unsigned>((T + kGroupThreads - 1) /
                                        kGroupThreads));
  rollup_groups<<<grid, kGroupThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const double*>(vals),
      static_cast<const double*>(cv), static_cast<const double*>(cmax),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(mpi), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(starts), N, T, shift, min_ts, step,
      lookback, func, aggr, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
