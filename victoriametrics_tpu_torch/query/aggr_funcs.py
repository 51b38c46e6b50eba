"""Aggregate functions (reference app/vmselect/promql/aggr.go:20-58, 37
functions + MetricsQL extras).

Each aggregate takes the stacked values matrix [S, T] of one group (NaN =
absent) plus optional scalar/string args, and returns either one row [T]
(simple aggregates) or a list of (extra_labels, row) for multi-output
aggregates (quantiles, count_values) or per-series selections (topk family,
limitk, outliers) which return masks instead.

The port's copy of ``victoriametrics_tpu/query/aggr_funcs.py``, whole.
"""

from __future__ import annotations

import numpy as np

nan = np.nan

with np.errstate(all="ignore"):
    pass


def _nan_all(m: np.ndarray) -> np.ndarray:
    return np.isnan(m).all(axis=0)


def _guard(fn):
    def wrapped(m, *args):
        with np.errstate(all="ignore"):
            out = fn(m, *args)
        out = np.asarray(out, dtype=np.float64)
        out[_nan_all(m)] = nan
        return out
    return wrapped


@_guard
def a_sum(m):
    return np.nansum(m, axis=0)


@_guard
def a_min(m):
    return np.nanmin(m, axis=0)


@_guard
def a_max(m):
    return np.nanmax(m, axis=0)


@_guard
def a_avg(m):
    return np.nanmean(m, axis=0)


@_guard
def a_count(m):
    return (~np.isnan(m)).sum(axis=0).astype(np.float64)


@_guard
def a_stddev(m):
    return np.nanstd(m, axis=0)


@_guard
def a_stdvar(m):
    return np.nanvar(m, axis=0)


@_guard
def a_group(m):
    return np.ones(m.shape[1])


@_guard
def a_median(m):
    return np.nanmedian(m, axis=0)


@_guard
def a_sum2(m):
    return np.nansum(m * m, axis=0)


@_guard
def a_geomean(m):
    cnt = (~np.isnan(m)).sum(axis=0)
    return np.exp(np.nansum(np.log(m), axis=0) / np.maximum(cnt, 1))


@_guard
def a_distinct(m):
    out = np.zeros(m.shape[1])
    for j in range(m.shape[1]):
        col = m[:, j]
        out[j] = np.unique(col[~np.isnan(col)]).size
    return out


@_guard
def a_mode(m):
    out = np.full(m.shape[1], nan)
    for j in range(m.shape[1]):
        col = m[:, j]
        col = col[~np.isnan(col)]
        if col.size:
            vals, counts = np.unique(col, return_counts=True)
            out[j] = vals[np.argmax(counts)]
    return out


def a_quantile(m, phi: float):
    if np.isnan(phi):
        return np.full(m.shape[1], nan)
    with np.errstate(all="ignore"):
        out = np.full(m.shape[1], nan)
        ok = ~_nan_all(m)
        if ok.any():
            out[ok] = np.nanquantile(m[:, ok], min(max(phi, 0), 1), axis=0)
        if phi < 0:
            out[ok] = -np.inf
        if phi > 1:
            out[ok] = np.inf
    return out


def _guard_matrix(fn):
    # matrix-shaped results: all-NaN COLUMNS go NaN (per-axis, not per-row)
    def wrapped(m, *args):
        with np.errstate(all="ignore"):
            out = np.asarray(fn(m, *args), dtype=np.float64)
        out[:, _nan_all(m)] = nan
        return out
    return wrapped


@_guard_matrix
def a_zscore(m):
    mean = np.nanmean(m, axis=0)
    sd = np.nanstd(m, axis=0)
    return (m - mean) / np.where(sd > 0, sd, nan)   # returns matrix!


@_guard_matrix
def a_share(m):
    # aggr.go:462 aggrFuncShare: negative points are EXCLUDED from the sum
    # and their own share is NaN
    ok = ~np.isnan(m) & (m >= 0)
    s = np.where(ok, m, 0.0).sum(axis=0)
    return np.where(ok, m / s, nan)                 # returns matrix!

SIMPLE = {
    "sum": a_sum, "min": a_min, "max": a_max, "avg": a_avg,
    "count": a_count, "stddev": a_stddev, "stdvar": a_stdvar,
    "group": a_group, "median": a_median, "sum2": a_sum2,
    "geomean": a_geomean, "distinct": a_distinct, "mode": a_mode,
}

# matrix-preserving aggregates: output one series per input series
PER_SERIES = {"zscore": a_zscore, "share": a_share}


def series_rank_metric(kind: str, m: np.ndarray) -> np.ndarray:
    """Whole-series statistic for topk_*/bottomk_* selection."""
    with np.errstate(all="ignore"):
        if kind == "avg":
            return np.nanmean(m, axis=1)
        if kind == "min":
            return np.nanmin(m, axis=1)
        if kind == "max":
            return np.nanmax(m, axis=1)
        if kind == "median":
            return np.nanmedian(m, axis=1)
        if kind == "last":
            out = np.full(m.shape[0], nan)
            for i in range(m.shape[0]):
                row = m[i]
                ok = np.flatnonzero(~np.isnan(row))
                if ok.size:
                    out[i] = row[ok[-1]]
            return out
    raise ValueError(f"unknown rank kind {kind}")


def topk_mask_per_ts(m: np.ndarray, k: int, bottom: bool) -> np.ndarray:
    """Prometheus-style per-timestamp topk: mask [S, T] of kept samples."""
    S, T = m.shape
    k = max(int(k), 0)
    mask = np.zeros((S, T), dtype=bool)
    if k == 0:
        return mask
    # ties keep the LOWEST series index (deterministic, and identical to
    # jax.lax.top_k so the device selection path agrees bit-for-bit)
    key = np.where(np.isnan(m), -np.inf if not bottom else np.inf, m)
    order = np.argsort(key if bottom else -key, axis=0, kind="stable")
    sel = order[:k]
    for j in range(T):
        mask[sel[:, j], j] = True
    mask &= ~np.isnan(m)
    return mask
