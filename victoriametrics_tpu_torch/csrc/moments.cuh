// The group moments of the fused aggregates: what K2 and B9 accumulate
// over a group's rows (rollup.cu group_value), what B13's per-shard pass
// writes (rollup.cu rollup_group_moments) and what its cross-shard combine
// folds and finalizes (mesh.cu combine_moments).  One definition, so the
// sharded and the unsharded aggregate finalize with the same operations.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Aggregate codes, AGGR_FUNCS in ops/device_rollup.py.
enum Aggr {
  aSum = 0, aCount = 1, aAvg = 2, aMin = 3, aMax = 4, aStddev = 5,
  aStdvar = 6, aGroup = 7
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

// partial_group_moments of one (group, step): the live rows' count, sum,
// sum of squares, minimum and maximum.  A minimum or maximum keeps the
// first of equal values (v < mn ? v : mn), so folding rows, or shards of
// consecutive rows, in ascending order gives the same bits.
struct Moments {
  double cnt, s1, s2, mn, mx;
};

__device__ __forceinline__ Moments moments_empty() {
  return Moments{0.0, 0.0, 0.0, INFINITY, -INFINITY};
}

__device__ __forceinline__ void moments_add(Moments& m, double v) {
  m.cnt += 1.0;
  m.s1 += v;
  m.s2 += v * v;
  m.mn = v < m.mn ? v : m.mn;
  m.mx = v > m.mx ? v : m.mx;
}

// Fold the moments of the next shard into `m`: sums add, extrema keep the
// first of equal values.
__device__ __forceinline__ void moments_merge(Moments& m, const Moments& p) {
  m.cnt += p.cnt;
  m.s1 += p.s1;
  m.s2 += p.s2;
  m.mn = p.mn < m.mn ? p.mn : m.mn;
  m.mx = p.mx > m.mx ? p.mx : m.mx;
}

// finalize_group_moments: the aggregate from its moments, NaN where no
// row is live.
__device__ __forceinline__ double finalize_moments(const Moments& m,
                                                   int aggr) {
  double res;
  switch (aggr) {
    case aSum: res = m.s1; break;
    case aCount: res = m.cnt; break;
    case aAvg: res = m.s1 / m.cnt; break;
    case aMin: res = m.mn; break;
    case aMax: res = m.mx; break;
    case aStddev:
    case aStdvar: {
      const double m1 = m.s1 / m.cnt;
      const double var = nan_max(m.s2 / m.cnt - m1 * m1, 0.0);
      res = aggr == aStddev ? sqrt(var) : var;
      break;
    }
    default: res = 1.0; break;  // group
  }
  return m.cnt > 0.0 ? res : qnan();
}

// The moments an aggregate keeps, in their stored order (MOMENTS in
// ops/device_rollup.py): cnt first, then s1 (and s2), or min, or max.
__host__ __device__ __forceinline__ int moment_count(int aggr) {
  switch (aggr) {
    case aSum:
    case aAvg:
    case aMin:
    case aMax: return 2;
    case aStddev:
    case aStdvar: return 3;
    default: return 1;  // count, group
  }
}

__device__ __forceinline__ double moment_get(const Moments& m, int aggr,
                                             int k) {
  if (k == 0) return m.cnt;
  if (k == 2) return m.s2;
  return aggr == aMin ? m.mn : aggr == aMax ? m.mx : m.s1;
}

__device__ __forceinline__ void moment_set(Moments& m, int aggr, int k,
                                           double v) {
  if (k == 0) m.cnt = v;
  else if (k == 2) m.s2 = v;
  else if (aggr == aMin) m.mn = v;
  else if (aggr == aMax) m.mx = v;
  else m.s1 = v;
}

}  // namespace
