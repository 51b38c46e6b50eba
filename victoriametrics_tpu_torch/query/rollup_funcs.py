"""Rollup function registry (reference app/vmselect/promql/rollup.go:24-110,
87 functions).

Two tiers:
- ORACLE_FUNCS: vectorized via ops/rollup_np (and the TPU kernels in
  ops/device_rollup for the device path) — the hot subset.
- GENERIC_FUNCS: per-window NumPy callables run by `generic_rollup`, covering
  the long tail. Window signature: fn(w_vals, w_ts, prev_v, prev_t, t_end,
  args) -> float, with NaN for "no value". Window = (t-d, t], prev = last
  sample at or before the window start (doInternal semantics).

Some functions yield multiple output series per input (rollup(),
rollup_candlestick(), aggr_over_time(), quantiles_over_time()): these are
MULTI_FUNCS and return [(label_tag, fn)] expansions.

The port's copy of ``victoriametrics_tpu/query/rollup_funcs.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..ops import rollup_np
from ..ops.rollup_np import RollupConfig

ORACLE_FUNCS = set(rollup_np.CORE_SUPPORTED)

nan = float("nan")


def _quantile(phi: float, vals: np.ndarray) -> float:
    if vals.size == 0:
        return nan
    if phi < 0:
        return -np.inf
    if phi > 1:
        return np.inf
    return float(np.quantile(vals, phi))


def _remove_resets(v: np.ndarray) -> np.ndarray:
    return rollup_np.remove_counter_resets(v)


# -- generic single-output windows ------------------------------------------

def _w_quantile(w, t, pv, pt, te, args):
    return _quantile(args[0], w)


def _w_median(w, t, pv, pt, te, args):
    return _quantile(0.5, w)


def _w_mad(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    med = np.median(w)
    return float(np.median(np.abs(w - med)))


def _w_iqr(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    q25, q75 = np.quantile(w, [0.25, 0.75])
    return float(q75 - q25)


def _w_zscore(w, t, pv, pt, te, args):
    """rollup.go:2361 rollupZScoreOverTime: gated on lag <= scrape interval,
    and (last - avg) == 0 short-circuits to 0 before dividing by stddev."""
    if w.size == 0:
        return nan
    if pv is not None:
        prev_ts, n = pt, t.size
    else:
        if t.size < 2:
            return nan
        prev_ts, n = t[0], t.size - 1
    scrape_interval = (t[-1] - prev_ts) / 1e3 / n
    lag = (te - t[-1]) / 1e3
    if lag > scrape_interval:
        return nan
    d = w[-1] - w.mean()
    if d == 0:
        return 0.0
    sd = w.std()
    return float(d / sd) if sd > 0 else nan


def _w_range(w, t, pv, pt, te, args):
    return float(w.max() - w.min()) if w.size else nan


def _w_distinct(w, t, pv, pt, te, args):
    return float(np.unique(w[~np.isnan(w)]).size) if w.size else nan


def _w_geomean(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    return float(np.exp(np.log(np.abs(w) + 0.0).mean())) if (w > 0).all() \
        else float(np.power(np.abs(np.prod(w)), 1.0 / w.size))


def _w_sum2(w, t, pv, pt, te, args):
    return float((w * w).sum()) if w.size else nan


def _w_tmin(w, t, pv, pt, te, args):
    return float(t[np.argmin(w)] / 1e3) if w.size else nan


def _w_tmax(w, t, pv, pt, te, args):
    return float(t[np.argmax(w)] / 1e3) if w.size else nan


def _w_resets(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    seq = w if pv is None else np.concatenate([[pv], w])
    return float((np.diff(seq) < 0).sum())


def _w_increases(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    seq = w if pv is None else np.concatenate([[pv], w])
    return float((np.diff(seq) > 0).sum())


def _w_decreases(w, t, pv, pt, te, args):
    return _w_resets(w, t, pv, pt, te, args)


def _w_integrate(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    vs, ts_ = w, t
    if pv is not None:
        vs = np.concatenate([[pv], w])
        ts_ = np.concatenate([[pt], t])
    if vs.size < 2:
        return 0.0
    dt = np.diff(ts_) / 1e3
    return float((vs[:-1] * dt).sum())


def _w_rate_over_sum(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    dt = (t[-1] - (pt if pt is not None else t[0])) / 1e3
    return float(w.sum() / dt) if dt > 0 else nan


def _w_count_eq(w, t, pv, pt, te, args):
    return float((w == args[0]).sum()) if w.size else nan


def _w_count_ne(w, t, pv, pt, te, args):
    return float((w != args[0]).sum()) if w.size else nan


def _w_count_le(w, t, pv, pt, te, args):
    return float((w <= args[0]).sum()) if w.size else nan


def _w_count_gt(w, t, pv, pt, te, args):
    return float((w > args[0]).sum()) if w.size else nan


def _w_share_le(w, t, pv, pt, te, args):
    return float((w <= args[0]).mean()) if w.size else nan


def _w_share_gt(w, t, pv, pt, te, args):
    return float((w > args[0]).mean()) if w.size else nan


def _w_share_eq(w, t, pv, pt, te, args):
    return float((w == args[0]).mean()) if w.size else nan


def _w_sum_eq(w, t, pv, pt, te, args):
    return float(w[w == args[0]].sum()) if w.size else nan


def _w_sum_le(w, t, pv, pt, te, args):
    return float(w[w <= args[0]].sum()) if w.size else nan


def _w_sum_gt(w, t, pv, pt, te, args):
    return float(w[w > args[0]].sum()) if w.size else nan


def _w_predict_linear(w, t, pv, pt, te, args):
    if w.size < 2:
        return nan
    t_s = (t - t[0]) / 1e3
    n = t_s.size
    st, sv = t_s.sum(), w.sum()
    stt, stv = (t_s * t_s).sum(), (t_s * w).sum()
    den = n * stt - st * st
    if den == 0:
        return nan
    k = (n * stv - st * sv) / den
    b = (sv - k * st) / n
    dt = (te - t[0]) / 1e3 + args[0]
    return float(k * dt + b)


def _w_holt_winters(w, t, pv, pt, te, args):
    sf, tf = args[0], args[1]
    if w.size < 2 or not (0 < sf < 1) or not (0 < tf < 1):
        return nan
    s = w[0]
    b = w[1] - w[0]
    for x in w[1:]:
        s_prev = s
        s = sf * x + (1 - sf) * (s + b)
        b = tf * (s - s_prev) + (1 - tf) * b
    return float(s)


def _w_mode(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    vals, counts = np.unique(w, return_counts=True)
    return float(vals[np.argmax(counts)])


def _w_ascent(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    seq = w if pv is None else np.concatenate([[pv], w])
    d = np.diff(seq)
    return float(d[d > 0].sum())


def _w_descent(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    seq = w if pv is None else np.concatenate([[pv], w])
    d = np.diff(seq)
    return float(-d[d < 0].sum())


def _w_changes_prometheus(w, t, pv, pt, te, args):
    # strict Prometheus semantics: no prev-value continuity
    if w.size == 0:
        return nan
    return float((np.diff(w) != 0).sum())


def _w_delta_prometheus(w, t, pv, pt, te, args):
    if w.size < 2:
        return nan
    return float(w[-1] - w[0])


def _w_increase_prometheus(w, t, pv, pt, te, args):
    if w.size < 2:
        return nan
    c = _remove_resets(w)
    return float(c[-1] - c[0])


def _w_ideriv(w, t, pv, pt, te, args):
    if w.size >= 2:
        dt = (t[-1] - t[-2]) / 1e3
        return float((w[-1] - w[-2]) / dt) if dt > 0 else nan
    if w.size == 1 and pv is not None:
        dt = (t[-1] - pt) / 1e3
        return float((w[-1] - pv) / dt) if dt > 0 else nan
    return nan


def _w_stale_samples(w, t, pv, pt, te, args):
    from ..ops import decimal as dec
    return float(dec.is_stale_nan(w).sum()) if w.size else nan


def _w_duration_over_time(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    max_gap = args[0] * 1e3 if args else nan
    d = np.diff(t).astype(np.float64)
    if args:
        d = d[d <= max_gap]
    return float(d.sum() / 1e3)


def _w_hoeffding_lower(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    avg, bound = _hoeffding(w, args[0])
    return float(max(avg - bound, 0.0))


def _w_hoeffding_upper(w, t, pv, pt, te, args):
    if w.size == 0:
        return nan
    avg, bound = _hoeffding(w, args[0])
    return float(avg + bound)


def _hoeffding(w, phi):
    rng = w.max() - w.min()
    if w.size < 2 or rng == 0 or not (0 < phi < 1):
        return float(w.mean()), 0.0
    bound = rng * np.sqrt(np.log(1.0 / (1 - phi)) / (2 * w.size))
    return float(w.mean()), float(bound)


def _w_tlast_change(w, t, pv, pt, te, args):
    # timestamp of the last value change (rollup.go:1669 rollupTlastChange)
    if w.size == 0:
        return nan
    last = w[-1]
    for i in range(w.size - 2, -1, -1):
        if w[i] != last:
            return float(t[i + 1]) / 1e3
    if pv is None or pv != last:
        return float(t[0]) / 1e3
    return nan


def _w_outlier_iqr(w, t, pv, pt, te, args):
    # last value when outside [q25-1.5iqr, q75+1.5iqr] (rollup.go:1427)
    if w.size < 2:
        return nan
    q25, q75 = np.quantile(w, [0.25, 0.75])
    iqr = 1.5 * (q75 - q25)
    v = float(w[-1])
    if v > q75 + iqr or v < q25 - iqr:
        return v
    return nan


# name -> (window_fn, n_extra_args, rollup_arg_index)
GENERIC_FUNCS = {
    "quantile_over_time": (_w_quantile, 1, 1),
    "median_over_time": (_w_median, 0, 0),
    "mad_over_time": (_w_mad, 0, 0),
    "iqr_over_time": (_w_iqr, 0, 0),
    "zscore_over_time": (_w_zscore, 0, 0),
    "range_over_time": (_w_range, 0, 0),
    "distinct_over_time": (_w_distinct, 0, 0),
    "geomean_over_time": (_w_geomean, 0, 0),
    "sum2_over_time": (_w_sum2, 0, 0),
    "tmin_over_time": (_w_tmin, 0, 0),
    "tmax_over_time": (_w_tmax, 0, 0),
    "resets": (_w_resets, 0, 0),
    "increases_over_time": (_w_increases, 0, 0),
    "decreases_over_time": (_w_decreases, 0, 0),
    "integrate": (_w_integrate, 0, 0),
    "rate_over_sum": (_w_rate_over_sum, 0, 0),
    "count_eq_over_time": (_w_count_eq, 1, 0),
    "count_ne_over_time": (_w_count_ne, 1, 0),
    "count_le_over_time": (_w_count_le, 1, 0),
    "count_gt_over_time": (_w_count_gt, 1, 0),
    "share_le_over_time": (_w_share_le, 1, 0),
    "share_gt_over_time": (_w_share_gt, 1, 0),
    "share_eq_over_time": (_w_share_eq, 1, 0),
    "sum_eq_over_time": (_w_sum_eq, 1, 0),
    "sum_le_over_time": (_w_sum_le, 1, 0),
    "sum_gt_over_time": (_w_sum_gt, 1, 0),
    "predict_linear": (_w_predict_linear, 1, 0),
    "holt_winters": (_w_holt_winters, 2, 0),
    "double_exponential_smoothing": (_w_holt_winters, 2, 0),
    "mode_over_time": (_w_mode, 0, 0),
    "ascent_over_time": (_w_ascent, 0, 0),
    "descent_over_time": (_w_descent, 0, 0),
    "changes_prometheus": (_w_changes_prometheus, 0, 0),
    "delta_prometheus": (_w_delta_prometheus, 0, 0),
    "increase_prometheus": (_w_increase_prometheus, 0, 0),
    "ideriv": (_w_ideriv, 0, 0),
    "stale_samples_over_time": (_w_stale_samples, 0, 0),
    "duration_over_time": (_w_duration_over_time, 1, 0),
    "hoeffding_bound_lower": (_w_hoeffding_lower, 1, 1),
    "hoeffding_bound_upper": (_w_hoeffding_upper, 1, 1),
    "timestamp_with_name": (None, 0, 0),   # alias of timestamp, keeps name
    "tlast_change_over_time": (_w_tlast_change, 0, 0),
    "outlier_iqr_over_time": (_w_outlier_iqr, 0, 0),
}

# multi-output rollups: name -> list of (rollup_tag, oracle-or-generic name)
MULTI_FUNCS = {
    "rollup": [("min", None), ("max", None), ("avg", None)],
    "rollup_rate": [("min", None), ("max", None), ("avg", None)],
    "rollup_increase": [("min", None), ("max", None), ("avg", None)],
    "rollup_delta": [("min", None), ("max", None), ("avg", None)],
    "rollup_deriv": [("min", None), ("max", None), ("avg", None)],
    "rollup_candlestick": [("open", "first_over_time"),
                           ("close", "last_over_time"),
                           ("high", "max_over_time"),
                           ("low", "min_over_time")],
    "rollup_scrape_interval": [("min", None), ("max", None), ("avg", None)],
}


def _deriv_values(vals: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """rollup.go:976 derivValues: replace each value with the derivative of
    the pair (i, i+1), assigned to the LEFT index; the last value repeats the
    last derivative; duplicate timestamps reuse the previous derivative."""
    v = np.asarray(vals, dtype=np.float64).copy()
    if v.size <= 1:
        if v.size == 1:
            v[0] = 0.0
        return v
    dts = np.diff(ts)
    if np.all(dts > 0):
        d = np.diff(v) / (dts / 1e3)
        v[:-1] = d
        v[-1] = d[-1]
        return v
    prev_deriv, prev_val, prev_ts = 0.0, v[0], ts[0]
    out = v.copy()
    for i in range(1, v.size):
        if ts[i] == prev_ts:
            out[i - 1] = prev_deriv
            continue
        prev_deriv = (v[i] - prev_val) / ((ts[i] - prev_ts) / 1e3)
        out[i - 1] = prev_deriv
        prev_val, prev_ts = v[i], ts[i]
    out[-1] = prev_deriv
    return out


def _delta_values(vals: np.ndarray) -> np.ndarray:
    """rollup.go:960 deltaValues: pairwise delta assigned to the LEFT index,
    last value repeats the last delta."""
    v = np.asarray(vals, dtype=np.float64).copy()
    if v.size <= 1:
        if v.size == 1:
            v[0] = 0.0
        return v
    d = np.diff(v)
    v[:-1] = d
    v[-1] = d[-1]
    return v


def _interval_values(ts: np.ndarray) -> np.ndarray:
    """rollup_scrape_interval preprocessing (rollup.go:478): seconds between
    adjacent samples; the leading NaN is overwritten with the 2nd interval."""
    v = np.empty(ts.shape, dtype=np.float64)
    if v.size == 0:
        return v
    v[0] = np.nan
    if v.size > 1:
        v[1:] = np.diff(ts) / 1e3
        v[0] = v[1]
    return v


# pre-transform applied to the whole series before min/max/avg windowing
# (rollup.go:413-495 appendRollupConfigs + preFunc chain)
PRE_ROLLUP_FUNCS = frozenset((
    "rollup", "rollup_rate", "rollup_deriv", "rollup_increase",
    "rollup_delta", "rollup_scrape_interval"))


def _candlestick(kind: str, ts: np.ndarray, vals: np.ndarray,
                 cfg: RollupConfig) -> np.ndarray:
    """rollup_candlestick OHLC (rollup.go:2209-2283 + eval.go:943): windows
    are shifted one step FORWARD (`offset -step` auto-applied), samples at
    the window end are excluded, and `open` is the last sample at/before the
    window start when it lies within the window length. The one-step
    forward grid shift (`offset -step`, eval.go:943) is applied by the
    EVALUATOR via a shifted EvalConfig so the inner subquery grid shifts
    with it."""
    out_ts = cfg.out_timestamps()
    window = cfg.lookback
    lo = np.searchsorted(ts, out_ts - window, side="right")
    hi = np.searchsorted(ts, out_ts, side="left")  # drop ts >= currTimestamp
    out = np.full(out_ts.size, np.nan)
    for j in range(out_ts.size):
        a, b = lo[j], hi[j]
        w = vals[a:b]
        first = nan
        if a >= 1 and ts[a - 1] + window >= out_ts[j]:
            first = float(vals[a - 1])
        if kind == "open":
            out[j] = first if first == first else (w[0] if w.size else nan)
        elif kind == "close":
            out[j] = w[-1] if w.size else first
        elif kind == "high":
            if first == first:
                out[j] = max(first, w.max()) if w.size else first
            else:
                out[j] = w.max() if w.size else nan
        elif kind == "low":
            if first == first:
                out[j] = min(first, w.min()) if w.size else first
            else:
                out[j] = w.min() if w.size else nan
    return out


def _pre_rollup(func: str, ts: np.ndarray, vals: np.ndarray,
                cfg: RollupConfig, args: tuple) -> np.ndarray:
    agg = args[0] if args and isinstance(args[0], str) else "avg"
    v = np.asarray(vals, dtype=np.float64)
    if func in ("rollup_rate", "rollup_increase"):
        v = rollup_np.remove_counter_resets(v)
    if func in ("rollup_rate", "rollup_deriv"):
        v = _deriv_values(v, ts)
    elif func in ("rollup_increase", "rollup_delta"):
        v = _delta_values(v)
    elif func == "rollup_scrape_interval":
        v = _interval_values(ts)
    return rollup_np.rollup(f"{agg}_over_time", ts, v, cfg)

# funcs whose implicit window expands to cover >=2 samples
# (rollup.go:204 rollupFuncsCanAdjustWindow; default_rollup excluded here
# because our default_rollup already uses the full lookback_delta window)
ADJUSTABLE_WINDOW_FUNCS = frozenset("""
deriv deriv_fast ideriv irate rate rate_over_sum rollup
rollup_candlestick rollup_deriv rollup_rate rollup_scrape_interval
scrape_interval timestamp
""".split())


# canonical implementations live in ops/rollup_np.py (the window walkers
# there share them for prevValue gating); re-exported here for the
# adjusted-window machinery and tests
scrape_interval_estimate = rollup_np.scrape_interval_estimate
max_prev_interval = rollup_np.max_prev_interval


def adjusted_window_ms(func: str, ts: np.ndarray, step: int) -> int:
    """The implicit lookbehind for rate/deriv-style funcs: at least the
    series' (inflated) scrape interval so windows hold >=2 samples
    (rollup.go:747-751)."""
    w = step
    if func in ADJUSTABLE_WINDOW_FUNCS:
        mpi = max_prev_interval(scrape_interval_estimate(ts, step))
        if w < mpi:
            w = mpi
    return w


def adjusted_windows(func: str, window: int, step: int, ts_list
                     ) -> list[int] | None:
    """Per-series adjusted windows for an implicit lookbehind, or None
    when no adjustment applies (explicit window / non-adjustable func)."""
    if window != 0 or func not in ADJUSTABLE_WINDOW_FUNCS or not ts_list:
        return None
    S = len(ts_list)
    if S >= 64:
        # batched: only the last <=21 samples of each series matter, so pack
        # the tails and run the vectorized estimator once (bit-compatible
        # with the per-series path)
        tails = [np.asarray(ts)[-21:] for ts in ts_list]
        counts = np.fromiter((t.size for t in tails), np.int64, count=S)
        t2 = np.full((S, 21), np.iinfo(np.int64).max, dtype=np.int64)
        t2[np.arange(21)[None, :] < counts[:, None]] = np.concatenate(tails)
        mpi = rollup_np.max_prev_interval_batch(
            rollup_np.scrape_interval_estimate_batch(t2, counts, step))
        return np.maximum(mpi, step).tolist()
    return [adjusted_window_ms(func, ts, step) for ts in ts_list]


# funcs that keep the metric name in results (rollup.go keepMetricName set)
KEEP_METRIC_NAMES = frozenset("""
avg_over_time default_rollup first_over_time geomean_over_time
hoeffding_bound_lower hoeffding_bound_upper holt_winters iqr_over_time
last_over_time max_over_time median_over_time min_over_time mode_over_time
predict_linear quantile_over_time quantiles_over_time rollup
rollup_candlestick timestamp_with_name double_exponential_smoothing
""".split())

ROLLUP_FUNC_NAMES = (ORACLE_FUNCS | set(GENERIC_FUNCS) | set(MULTI_FUNCS)
                     | {"aggr_over_time", "quantiles_over_time",
                        "absent_over_time", "rate_prometheus",
                        "count_values_over_time", "histogram_over_time"})


def generic_rollup(fn, ts: np.ndarray, vals: np.ndarray, cfg: RollupConfig,
                   args: tuple = ()) -> np.ndarray:
    """Apply a per-window function over one series (the long-tail path)."""
    out_ts = cfg.out_timestamps()
    lo = np.searchsorted(ts, out_ts - cfg.lookback, side="right")
    hi = np.searchsorted(ts, out_ts, side="right")
    out = np.full(out_ts.size, np.nan)
    # prevValue is seeded only when the sample before the window lies within
    # maxPrevInterval of the window start (rollup.go:781 doInternal)
    mpi = rollup_np._max_prev_interval_for(np.asarray(ts), cfg)
    for j in range(out_ts.size):
        a, b = lo[j], hi[j]
        if b <= a and a == 0:
            continue
        pv = pt = None
        if a >= 1 and ts[a - 1] > out_ts[j] - cfg.lookback - mpi:
            pv = float(vals[a - 1])
            pt = int(ts[a - 1])
        if b <= a:
            continue
        out[j] = fn(vals[a:b], ts[a:b], pv, pt, int(out_ts[j]), args)
    return out


def rollup_series(func: str, ts: np.ndarray, vals: np.ndarray,
                  cfg: RollupConfig, args: tuple = ()) -> np.ndarray:
    """Single-series rollup dispatch: oracle fast path else generic."""
    if func == "timestamp_with_name":
        func = "timestamp"
    if func == "absent_over_time":
        # 1 for empty windows, NaN otherwise (rollup.go:1755 rollupAbsent;
        # the cross-series collapse happens in eval)
        cnt = rollup_np.rollup("count_over_time", ts, vals, cfg)
        return np.where(np.isnan(cnt), 1.0, np.nan)
    if func in PRE_ROLLUP_FUNCS:
        return _pre_rollup(func, ts, vals, cfg, args)
    if func == "rollup_candlestick":
        return _candlestick(args[0] if args else "close", ts, vals, cfg)
    if func == "rate_prometheus":
        # delta_prometheus / window_seconds (rollup.go:1946)
        c = rollup_np.remove_counter_resets(vals)
        d = generic_rollup(_w_delta_prometheus, ts, c, cfg, args)
        return d / (cfg.lookback / 1e3)
    if func in ORACLE_FUNCS:
        return rollup_np.rollup(func, ts, vals, cfg)
    spec = GENERIC_FUNCS.get(func)
    if spec is None:
        raise ValueError(f"unknown rollup function {func!r}")
    fn, _, _ = spec
    return generic_rollup(fn, ts, vals, cfg, args)
