"""NumPy reference semantics for windowed rollup functions.

This module is the ORACLE: it defines, in plain NumPy over one series at a
time, the exact semantics of each rollup function. The CUDA kernels behind
ops/device_rollup.py must match it bit-for-bit (up to float assoc order), and
the host fallback path uses it directly.

Semantics follow the reference's rollup model (app/vmselect/promql/
rollup.go:688-960, doInternal window walk + removeCounterResets): for each
output timestamp ``t`` in [start, end] stepping by ``step``, the window is
``(t - window, t]``. Functions additionally see the "real previous value" —
the last sample at or before the window start — which powers
delta/increase/rate continuity across windows. Empty windows yield NaN
(gap semantics); staleness markers end a series segment.

The port's copy of ``victoriametrics_tpu/ops/rollup_np.py``, whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .decimal import STALE_NAN_BITS


@dataclasses.dataclass(frozen=True)
class RollupConfig:
    """Static window grid: all values unix ms."""
    start: int
    end: int
    step: int
    window: int  # lookbehind; 0 means "use step"

    @property
    def lookback(self) -> int:
        return self.window if self.window > 0 else self.step

    def out_timestamps(self) -> np.ndarray:
        return np.arange(self.start, self.end + 1, self.step, dtype=np.int64)


def scrape_interval_estimate(ts: np.ndarray, default_ms: int) -> int:
    """0.6 quantile of the last 20 sample intervals (rollup.go:871
    getScrapeInterval)."""
    if ts.size < 2:
        return default_ms
    tail = ts[-21:]
    intervals = np.diff(tail).astype(np.float64)
    if intervals.size == 0:
        return default_ms
    si = int(np.quantile(intervals, 0.6))
    return si if si > 0 else default_ms


def max_prev_interval(scrape_interval: int) -> int:
    """Jitter headroom over the scrape interval (rollup.go:899
    getMaxPrevInterval)."""
    si = scrape_interval
    if si <= 2_000:
        return si + 4 * si
    if si <= 4_000:
        return si + 2 * si
    if si <= 8_000:
        return si + si
    if si <= 16_000:
        return si + si // 2
    if si <= 32_000:
        return si + si // 4
    return si + si // 8


def _max_prev_interval_for(ts: np.ndarray, cfg: "RollupConfig") -> int:
    """rollup.go:720-728: instant queries use step; range queries estimate
    the scrape interval and inflate it for jitter tolerance. The sample just
    before the window seeds prevValue only when it is within this interval
    of the window start."""
    if cfg.start >= cfg.end:
        return cfg.step
    return max_prev_interval(scrape_interval_estimate(ts, cfg.step))


def scrape_interval_estimate_batch(ts2: np.ndarray, counts: np.ndarray,
                                   default_ms: int) -> np.ndarray:
    """Vectorized scrape_interval_estimate over padded (S, N) rows —
    bit-compatible with the scalar version (same 0.6-quantile with numpy's
    linear interpolation, same int() truncation)."""
    S, N = ts2.shape
    k = np.minimum(counts, 21)                    # tail length per row
    start = counts - k
    idx = np.clip(start[:, None] + np.arange(21)[None, :], 0, max(N - 1, 0))
    tail = np.take_along_axis(ts2, idx, axis=1)
    iv = np.diff(tail, axis=1).astype(np.float64)  # (S, 20)
    n_iv = k - 1                                   # valid intervals per row
    valid = np.arange(20)[None, :] < n_iv[:, None]
    iv = np.where(valid, iv, np.inf)
    iv.sort(axis=1)
    m = np.maximum(n_iv, 1).astype(np.float64)
    pos = 0.6 * (m - 1)
    flo = np.floor(pos).astype(np.int64)
    frac = pos - flo
    a = np.take_along_axis(iv, np.clip(flo, 0, 19)[:, None], axis=1)[:, 0]
    b = np.take_along_axis(iv, np.clip(flo + 1, 0, 19)[:, None],
                           axis=1)[:, 0]
    # replicate numpy's _lerp branch (t >= 0.5 computes from b) bit-exactly
    with np.errstate(invalid="ignore"):
        b = np.where(frac > 0, b, a)
        d = b - a
        q = np.where(frac >= 0.5, b - d * (1.0 - frac), a + d * frac)
    si = np.where(np.isfinite(q), q, 0.0).astype(np.int64)
    return np.where((counts < 2) | (n_iv < 1) | (si <= 0), default_ms, si)


def max_prev_interval_batch(si: np.ndarray) -> np.ndarray:
    """Vectorized max_prev_interval (rollup.go:899)."""
    si = np.asarray(si, dtype=np.int64)
    extra = np.select(
        [si <= 2_000, si <= 4_000, si <= 8_000, si <= 16_000, si <= 32_000],
        [4 * si, 2 * si, si, si // 2, si // 4], si // 8)
    return si + extra



def remove_counter_resets(values: np.ndarray) -> np.ndarray:
    """Monotonize a counter series: whenever v[i] < v[i-1] (reset), add the
    lost base back so deltas across resets count from the reset value
    (rollup.go:921 removeCounterResets analog). A drop where the new value
    is still >1/8 of the previous one is a "partial reset" (only the lost
    amount is added back); otherwise it's a full reset (the whole previous
    value is added back, so the counter continues from where it was)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0 or v.shape[-1] == 0:
        return v.copy()
    if v.ndim <= 2:
        try:  # single-pass native kernel (bit-exact with the path below)
            from .. import native as _native
            if _native.available():
                return _native.counter_resets_2d(v)
        except (ImportError, OSError, AttributeError, ValueError):
            pass  # any native-layer trouble falls back to the numpy path
    d = np.diff(v, axis=-1)
    prev = v[..., :-1]
    drop = np.where(d < 0, np.where(-d * 8 < prev, -d, prev), 0.0)
    # reset correction: cumulative sum of drops, shifted to apply from the
    # resetting sample onward
    zeros = np.zeros(v.shape[:-1] + (1,), dtype=np.float64)
    corr = np.concatenate([zeros, np.cumsum(drop, axis=-1)], axis=-1)
    return v + corr


def _new_series_base(w: np.ndarray) -> float:
    """delta/increase baseline for a series whose first sample lies INSIDE
    the window (no sample precedes it): assume the counter was born at 0 —
    a histogram bucket or error counter appearing at value k carries k
    events — unless the first value dwarfs the first in-window step, which
    marks an already-running counter surfacing mid-window (churn, index
    rotation); then it is the baseline (rollup.go:2129 rollupDelta)."""
    d = float(w[1] - w[0]) if w.size > 1 else 0.0
    return 0.0 if abs(w[0]) < 10.0 * (abs(d) + 1.0) else float(w[0])


def _window_bounds(ts: np.ndarray, cfg: RollupConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per output step: [start_idx, end_idx) half-open index range of samples
    inside (t-window, t]."""
    out_ts = cfg.out_timestamps()
    lo = np.searchsorted(ts, out_ts - cfg.lookback, side="right")
    hi = np.searchsorted(ts, out_ts, side="right")
    return lo, hi


def rollup(func: str, ts: np.ndarray, values: np.ndarray, cfg: RollupConfig
           ) -> np.ndarray:
    """Apply one rollup function over a single series. ts must be sorted."""
    ts = np.asarray(ts, dtype=np.int64)
    v = np.asarray(values, dtype=np.float64)
    out_ts = cfg.out_timestamps()
    T = out_ts.size
    out = np.full(T, np.nan)
    lo, hi = _window_bounds(ts, cfg)
    have = hi > lo

    if func in ("count_over_time", "present_over_time", "changes"):
        pass  # handled below without needing per-window values

    corrected = remove_counter_resets(v) if func in (
        "rate", "increase", "irate", "increase_pure") else v

    # prevValue gating (rollup.go:781): the sample before the window seeds
    # prevValue only when within maxPrevInterval of the window start. The
    # delta/increase/changes family keeps the ungated sample — it doubles as
    # realPrevValue, which rollup.go uses ungated when LookbackDelta is 0.
    mpi = _max_prev_interval_for(ts, cfg)

    for j in range(T):
        a, b = lo[j], hi[j]
        prev_idx = a - 1  # last sample at or before window start (realPrev)
        gated_prev = prev_idx if (
            prev_idx >= 0 and ts[prev_idx] > out_ts[j] - cfg.lookback - mpi
        ) else -1
        if func == "count_over_time":
            out[j] = (b - a) if b > a else np.nan
            continue
        if func == "present_over_time":
            out[j] = 1.0 if b > a else np.nan
            continue
        if not have[j]:
            continue
        w = v[a:b]
        cw = corrected[a:b]
        tw = ts[a:b]
        if func == "sum_over_time":
            out[j] = w.sum()
        elif func == "min_over_time":
            out[j] = w.min()
        elif func == "max_over_time":
            out[j] = w.max()
        elif func == "avg_over_time":
            out[j] = w.mean()
        elif func == "stddev_over_time":
            out[j] = w.std()
        elif func == "stdvar_over_time":
            out[j] = w.var()
        elif func == "first_over_time":
            out[j] = w[0]
        elif func == "last_over_time" or func == "default_rollup":
            out[j] = w[-1]
        elif func == "tfirst_over_time":
            out[j] = tw[0] / 1e3
        elif func == "tlast_over_time" or func == "timestamp":
            out[j] = tw[-1] / 1e3
        elif func == "changes":
            prev = v[prev_idx] if prev_idx >= 0 else None
            seq = w if prev is None else np.concatenate([[prev], w])
            out[j] = float((np.diff(seq) != 0).sum())
            if prev is None and w.size:
                out[j] += 0  # first appearance is not a change
        elif func == "delta":
            base = v[prev_idx] if prev_idx >= 0 else _new_series_base(w)
            out[j] = w[-1] - base
        elif func in ("increase", "increase_pure"):
            if prev_idx >= 0:
                base = corrected[prev_idx]
            elif func == "increase_pure":
                base = 0.0  # rollup.go:2169 rollupIncreasePure
            else:
                base = _new_series_base(cw)
            out[j] = cw[-1] - base
        elif func == "rate":
            if gated_prev >= 0:
                dt = (tw[-1] - ts[gated_prev]) / 1e3
                dv = cw[-1] - corrected[gated_prev]
            elif b - a >= 2:
                dt = (tw[-1] - tw[0]) / 1e3
                dv = cw[-1] - cw[0]
            else:
                continue
            out[j] = dv / dt if dt > 0 else np.nan
        elif func == "irate":
            if b - a >= 2:
                dt = (tw[-1] - tw[-2]) / 1e3
                dv = cw[-1] - cw[-2]
            elif gated_prev >= 0:
                dt = (tw[-1] - ts[gated_prev]) / 1e3
                dv = cw[-1] - corrected[gated_prev]
            else:
                continue
            out[j] = dv / dt if dt > 0 else np.nan
        elif func == "idelta":
            if b - a >= 2:
                out[j] = w[-1] - w[-2]
            elif gated_prev >= 0:
                out[j] = w[-1] - v[gated_prev]
        elif func == "deriv_fast":
            if gated_prev >= 0:
                dt = (tw[-1] - ts[gated_prev]) / 1e3
                out[j] = (w[-1] - v[gated_prev]) / dt if dt > 0 else np.nan
            elif b - a >= 2:
                dt = (tw[-1] - tw[0]) / 1e3
                out[j] = (w[-1] - w[0]) / dt if dt > 0 else np.nan
        elif func == "deriv":
            # least-squares slope per second over window samples
            if b - a >= 2:
                t_s = (tw - tw[0]) / 1e3
                n = t_s.size
                st, sv = t_s.sum(), w.sum()
                stt, stv = (t_s * t_s).sum(), (t_s * w).sum()
                den = n * stt - st * st
                out[j] = (n * stv - st * sv) / den if den != 0 else np.nan
        elif func == "lag":
            out[j] = (out_ts[j] - tw[-1]) / 1e3
        elif func == "lifetime":
            first = ts[0] if prev_idx >= 0 else tw[0]
            out[j] = (tw[-1] - first) / 1e3
        elif func == "scrape_interval":
            if prev_idx >= 0:
                out[j] = (tw[-1] - ts[prev_idx]) / 1e3 / (b - a)
            elif b - a >= 2:
                out[j] = (tw[-1] - tw[0]) / 1e3 / (b - a - 1)
        else:
            raise ValueError(f"unsupported numpy rollup func {func!r}")
    return out


# Core funcs: per-series oracle above + device kernels in
# ops/device_rollup (DEVICE_FUNCS there mirrors this tuple).
CORE_SUPPORTED = (
    "count_over_time", "present_over_time", "sum_over_time", "min_over_time",
    "max_over_time", "avg_over_time", "stddev_over_time", "stdvar_over_time",
    "first_over_time", "last_over_time", "default_rollup", "tfirst_over_time",
    "tlast_over_time", "timestamp", "changes", "delta", "increase",
    "increase_pure", "rate", "irate", "idelta", "deriv", "deriv_fast", "lag",
    "lifetime", "scrape_interval",
)

# Long-tail funcs vectorized ONLY in rollup_batch_packed (per-series
# semantics live in query/rollup_funcs.GENERIC_FUNCS; differential-tested
# side by side). Cumsum/gather formulations unless noted.
EXTENDED_SUPPORTED = (
    "sum2_over_time", "range_over_time", "geomean_over_time",
    "count_eq_over_time", "count_ne_over_time", "count_le_over_time",
    "count_gt_over_time", "share_eq_over_time", "share_le_over_time",
    "share_gt_over_time", "sum_eq_over_time", "sum_le_over_time",
    "sum_gt_over_time", "resets", "increases_over_time",
    "decreases_over_time", "ascent_over_time", "descent_over_time",
    "integrate", "duration_over_time", "rate_over_sum", "ideriv",
    "changes_prometheus", "delta_prometheus", "increase_prometheus",
    "rate_prometheus", "predict_linear", "zscore_over_time",
    "hoeffding_bound_lower", "hoeffding_bound_upper", "timestamp_with_name",
    # windowed order statistics (chunked (S, Tc, W) gather + nan-reductions)
    "quantile_over_time", "median_over_time", "mad_over_time",
    "iqr_over_time", "outlier_iqr_over_time", "tmin_over_time",
    "tmax_over_time", "distinct_over_time", "mode_over_time",
    "tlast_change_over_time",
)

# Every rollup the batched (vectorized multi-series) path understands.
SUPPORTED = CORE_SUPPORTED + EXTENDED_SUPPORTED

# exact positional-arg count per func (absent = 0 args)
ARG_COUNTS = {
    "quantile_over_time": 1, "count_eq_over_time": 1,
    "count_ne_over_time": 1, "count_le_over_time": 1,
    "count_gt_over_time": 1, "share_eq_over_time": 1,
    "share_le_over_time": 1, "share_gt_over_time": 1,
    "sum_eq_over_time": 1, "sum_le_over_time": 1, "sum_gt_over_time": 1,
    "predict_linear": 1, "hoeffding_bound_lower": 1,
    "hoeffding_bound_upper": 1,
}


def batch_supported(func: str, args: tuple = ()) -> bool:
    """True when rollup_batch/rollup_batch_packed can run (func, args):
    the eval gates call this instead of `not args and func in SUPPORTED`."""
    if func not in SUPPORTED:
        return False
    want = ARG_COUNTS.get(func, 0)
    if func == "duration_over_time":
        if len(args) > 1:
            return False
    elif len(args) != want:
        return False
    return all(isinstance(a, (int, float, np.integer, np.floating))
               for a in args)


def rollup_batch(func: str, series: list, cfg: RollupConfig,
                 args: tuple = ()):
    """Vectorized multi-series rollup: one (S, T) computation instead of a
    per-series/per-window Python loop — the host-side analog of the device
    tile kernels (ops/device_rollup.py). `series` is a list of (ts, values)
    pairs, each time-sorted.

    Returns an (S, T) float64 array, or None when the inputs need the exact
    per-series path (NaN values poison the cumsum formulation).
    Semantics are bit-compatible with rollup() above (tested side by side).
    """
    if func not in SUPPORTED:
        return None
    S = len(series)
    out_ts = cfg.out_timestamps()
    T = out_ts.size
    if S == 0:
        return np.full((0, T), np.nan)
    arrs_ts = [np.asarray(ts) for ts, _ in series]
    counts = np.fromiter((a.size for a in arrs_ts), dtype=np.int64, count=S)
    N = int(counts.max())
    if N == 0:
        return np.full((S, T), np.nan)
    pad = np.iinfo(np.int64).max
    if bool((counts == N).all()):
        # uniform lengths (the common scrape-grid case): one concatenate +
        # reshape instead of S row assignments
        ts2 = np.ascontiguousarray(
            np.concatenate(arrs_ts).reshape(S, N).astype(np.int64,
                                                         copy=False))
        v2 = np.concatenate([np.asarray(v, dtype=np.float64)
                             for _, v in series]).reshape(S, N)
    else:
        mask = np.arange(N)[None, :] < counts[:, None]
        ts2 = np.full((S, N), pad, dtype=np.int64)
        ts2[mask] = np.concatenate(arrs_ts)
        v2 = np.zeros((S, N), dtype=np.float64)
        v2[mask] = np.concatenate([np.asarray(v, dtype=np.float64)
                                   for _, v in series])
    return rollup_batch_packed(func, ts2, v2, counts, cfg, args)


def rollup_batch_packed(func: str, ts2: np.ndarray, v2: np.ndarray,
                        counts: np.ndarray, cfg: RollupConfig,
                        args: tuple = ()):
    """rollup_batch over pre-packed padded columns: ts2 (S, N) int64 padded
    with INT64_MAX, v2 (S, N) float64 (padding ignored), counts (S,).
    Entry point for callers that already hold packed columns (the columnar
    fetch path), skipping the per-series repack."""
    if not batch_supported(func, args):
        return None
    if func == "timestamp_with_name":
        func = "timestamp"  # same values; eval keeps the metric name
    S, N = ts2.shape
    out_ts = cfg.out_timestamps()
    T = out_ts.size
    if S == 0 or N == 0:
        return np.full((S, T), np.nan)
    # padding is 0.0 by layout contract, so one flat pass suffices.
    # NaN *and* +/-Inf poison the cumsum formulation (inf-inf = nan for
    # every window downstream); the per-series loop is exact
    if not np.isfinite(v2).all():
        return None

    w_lo = out_ts - cfg.lookback
    first_row = ts2[0]
    if bool((counts == counts[0]).all()) and \
            bool((ts2 == first_row[None, :]).all()):
        # every series shares one timestamp grid (common scrape schedule):
        # two searchsorteds total instead of 2*S
        row = first_row[:counts[0]]
        lo = np.broadcast_to(np.searchsorted(row, w_lo, side="right"),
                             (S, T))
        hi = np.broadcast_to(np.searchsorted(row, out_ts, side="right"),
                             (S, T))
    else:
        lo = np.empty((S, T), dtype=np.int64)
        hi = np.empty((S, T), dtype=np.int64)
        for s in range(S):
            row = ts2[s, :counts[s]]
            lo[s] = np.searchsorted(row, w_lo, side="right")
            hi[s] = np.searchsorted(row, out_ts, side="right")
    have = hi > lo
    nwin = hi - lo                       # samples per window
    prev = lo - 1                        # last sample at/before window start
    has_prev = prev >= 0

    def mpi_batch():
        # per-series maxPrevInterval prevValue gate for the deriv family —
        # must stay bit-compatible with rollup() above (same gating rule)
        if cfg.start >= cfg.end:
            return np.full(S, cfg.step, dtype=np.int64)
        return max_prev_interval_batch(
            scrape_interval_estimate_batch(ts2, counts, cfg.step))

    def gated_prev_mask():
        t_prev_raw = np.take_along_axis(ts2, np.clip(prev, 0, N - 1), axis=1)
        return has_prev & (t_prev_raw > w_lo[None, :] - mpi_batch()[:, None])

    out = np.full((S, T), np.nan)

    # flat-index gathers: np.take on precomputed flat indices is ~4x faster
    # than take_along_axis; index arrays repeat across gathers, so the flat
    # form is memoized per identity
    _row_base = (np.arange(S, dtype=np.int64) * N)[:, None]
    _flat_idx: dict = {}
    _flat_arr: dict = {}

    # the memo entries keep a reference to the KEY array: an id() of a freed
    # temporary could be recycled by a later allocation and serve stale
    # indices
    def _fidx(idx):
        hit = _flat_idx.get(id(idx))
        if hit is None:
            hit = (idx, np.clip(idx, 0, N - 1) + _row_base)
            _flat_idx[id(idx)] = hit
        return hit[1]

    def _farr(a):  # flat view; copies once iff the input is a sliced view
        hit = _flat_arr.get(id(a))
        if hit is None:
            hit = (a, np.ascontiguousarray(a).reshape(-1))
            _flat_arr[id(a)] = hit
        return hit[1]

    def gather(arr2d, idx, fill=0.0):
        return np.take(_farr(arr2d), _fidx(idx))

    last_i = np.clip(hi - 1, 0, N - 1)

    if func == "count_over_time":
        return np.where(nwin > 0, nwin.astype(np.float64), np.nan)
    if func == "present_over_time":
        return np.where(have, 1.0, np.nan)

    if func in ("sum_over_time", "avg_over_time", "stddev_over_time",
                "stdvar_over_time"):
        c1 = np.concatenate([np.zeros((S, 1)), np.cumsum(v2, axis=1)], axis=1)
        s1 = np.take_along_axis(c1, hi, axis=1) - \
            np.take_along_axis(c1, lo, axis=1)
        if func == "sum_over_time":
            return np.where(have, s1, np.nan)
        cnt = np.where(nwin > 0, nwin, 1).astype(np.float64)
        if func == "avg_over_time":
            return np.where(have, s1 / cnt, np.nan)
        # center per series before the E[x^2]-E[x]^2 cumsums: variance is
        # shift-invariant and this kills the catastrophic cancellation
        shift = v2[:, :1]
        vc = v2 - shift
        c1c = np.concatenate([np.zeros((S, 1)), np.cumsum(vc, axis=1)],
                             axis=1)
        s1c = np.take_along_axis(c1c, hi, axis=1) - \
            np.take_along_axis(c1c, lo, axis=1)
        c2 = np.concatenate([np.zeros((S, 1)), np.cumsum(vc * vc, axis=1)],
                            axis=1)
        s2 = np.take_along_axis(c2, hi, axis=1) - \
            np.take_along_axis(c2, lo, axis=1)
        var = np.maximum(s2 / cnt - (s1c / cnt) ** 2, 0.0)
        return np.where(have, np.sqrt(var) if func == "stddev_over_time"
                        else var, np.nan)

    if func in ("min_over_time", "max_over_time"):
        red = np.minimum if func == "min_over_time" else np.maximum
        fill = np.inf if func == "min_over_time" else -np.inf
        for s in range(S):
            # one pad element so hi == N is a valid reduceat index; [a,b)
            # pairs land on even slots, inter-window segments are discarded
            arr = np.concatenate([v2[s], [fill]])
            idx = np.stack([lo[s], hi[s]], axis=1).reshape(-1)
            r = red.reduceat(arr, idx)[::2]
            out[s] = np.where(have[s], r, np.nan)
        return out

    if func == "first_over_time":
        return np.where(have, gather(v2, lo), np.nan)
    if func in ("last_over_time", "default_rollup"):
        return np.where(have, gather(v2, last_i), np.nan)
    if func == "tfirst_over_time":
        return np.where(have, gather(ts2, lo) / 1e3, np.nan)
    if func in ("tlast_over_time", "timestamp"):
        return np.where(have, gather(ts2, last_i) / 1e3, np.nan)
    if func == "lag":
        return np.where(have, (out_ts[None, :] - gather(ts2, last_i)) / 1e3,
                        np.nan)
    if func == "lifetime":
        first = np.where(has_prev, ts2[:, :1], gather(ts2, lo))
        return np.where(have, (gather(ts2, last_i) - first) / 1e3, np.nan)
    if func == "scrape_interval":
        t_last = gather(ts2, last_i)
        t_prev = gather(ts2, np.maximum(prev, 0))
        t_first = gather(ts2, lo)
        with np.errstate(all="ignore"):
            r_prev = (t_last - t_prev) / 1e3 / nwin
            r_self = (t_last - t_first) / 1e3 / np.maximum(nwin - 1, 1)
        res = np.where(has_prev, r_prev,
                       np.where(nwin >= 2, r_self, np.nan))
        return np.where(have, res, np.nan)
    if func == "changes":
        ind = np.zeros((S, N))
        ind[:, 1:] = (np.diff(v2, axis=1) != 0).astype(np.float64)
        # mask changes into the padded region
        col = np.arange(N)[None, :]
        ind[col >= counts[:, None]] = 0.0
        cz = np.concatenate([np.zeros((S, 1)), np.cumsum(ind, axis=1)],
                            axis=1)  # cz[k] = sum ind[0..k-1], ind[0] = 0
        # window [a,b): with prev the compared pairs are i in [a,b), without
        # they are i in [1,b) — both reduce to cz[b] - cz[a]
        return np.where(have,
                        np.take_along_axis(cz, hi, axis=1) -
                        np.take_along_axis(cz, lo, axis=1), np.nan)

    # counter / derivative family — fused native window-walk when available
    # (reset-correction + two-pointer windows in one C pass per row)
    if func in ("rate", "increase", "increase_pure", "delta", "deriv_fast",
                "irate", "idelta"):
        try:
            from .. import native as _native
            has_native = _native.available()
        except Exception:
            has_native = False
        if has_native:
            mpi = (mpi_batch() if func in ("rate", "deriv_fast", "irate",
                                           "idelta")
                   else np.zeros(S, dtype=np.int64))  # ungated funcs
            return _native.rollup_counter_2d(
                func, ts2, v2, counts, cfg.start, cfg.end, cfg.step,
                cfg.lookback, mpi)

    # numpy fallback: each branch gathers only what it needs
    # (a gather is a full (S, T) pass — 9 unconditional ones dominated this
    # function's profile before)
    needs_reset = func in ("rate", "increase", "irate", "increase_pure")
    if needs_reset:
        cw2 = remove_counter_resets(v2)
    else:
        cw2 = v2
    pidx = np.maximum(prev, 0)

    with np.errstate(all="ignore"):
        if func in ("delta", "increase", "increase_pure"):
            arr = v2 if func == "delta" else cw2
            a_first = gather(arr, lo)
            if func == "increase_pure":
                nb = np.zeros_like(a_first)  # always born at 0
            else:
                # vectorized _new_series_base (see rollup() above)
                second = gather(arr, np.clip(lo + 1, 0, N - 1))
                d = np.where(nwin >= 2, second - a_first, 0.0)
                nb = np.where(np.abs(a_first) < 10.0 * (np.abs(d) + 1.0),
                              0.0, a_first)
            base = np.where(has_prev, gather(arr, pidx), nb)
            return np.where(have, gather(arr, last_i) - base, np.nan)
        if func in ("rate", "deriv_fast"):
            arr = cw2 if func == "rate" else v2
            has_gated_prev = gated_prev_mask()
            t_last = gather(ts2, last_i)
            a_last = gather(arr, last_i)
            dt = np.where(has_gated_prev, t_last - gather(ts2, pidx),
                          t_last - gather(ts2, lo)) / 1e3
            dv = np.where(has_gated_prev, a_last - gather(arr, pidx),
                          a_last - gather(arr, lo))
            ok = have & (has_gated_prev | (nwin >= 2))
            res = np.where(dt > 0, dv / dt, np.nan)
            return np.where(ok, res, np.nan)
        if func in ("irate", "idelta"):
            arr = cw2 if func == "irate" else v2
            has_gated_prev = gated_prev_mask()
            i2 = np.clip(hi - 2, 0, N - 1)
            a_last = gather(arr, last_i)
            a_pen = gather(arr, i2)
            a_prev = gather(arr, pidx)
            two = nwin >= 2
            if func == "idelta":
                res = np.where(two, a_last - a_pen,
                               np.where(has_gated_prev, a_last - a_prev,
                                        np.nan))
                return np.where(have, res, np.nan)
            t_last = gather(ts2, last_i)
            t_pen = gather(ts2, i2)
            t_prev = gather(ts2, pidx)
            dt = np.where(two, t_last - t_pen, t_last - t_prev) / 1e3
            dv = np.where(two, a_last - a_pen, a_last - a_prev)
            ok = have & (two | has_gated_prev)
            res = np.where(dt > 0, dv / dt, np.nan)
            return np.where(ok, res, np.nan)
        if func == "deriv":
            # least-squares slope; shift t by cfg.start for numerics
            t_rel = (ts2 - cfg.start) / 1e3
            t_rel = np.where(np.arange(N)[None, :] < counts[:, None],
                             t_rel, 0.0)
            ct = np.concatenate([np.zeros((S, 1)), np.cumsum(t_rel, axis=1)],
                                axis=1)
            ctt = np.concatenate([np.zeros((S, 1)),
                                  np.cumsum(t_rel * t_rel, axis=1)], axis=1)
            cv = np.concatenate([np.zeros((S, 1)), np.cumsum(v2, axis=1)],
                                axis=1)
            ctv = np.concatenate([np.zeros((S, 1)),
                                  np.cumsum(t_rel * v2, axis=1)], axis=1)

            def wsum(c):
                return (np.take_along_axis(c, hi, axis=1) -
                        np.take_along_axis(c, lo, axis=1))
            n = nwin.astype(np.float64)
            st, sv, stt, stv = wsum(ct), wsum(cv), wsum(ctt), wsum(ctv)
            den = n * stt - st * st
            res = np.where(den != 0, (n * stv - st * sv) / den, np.nan)
            return np.where(have & (nwin >= 2), res, np.nan)

    # ---- long-tail family (GENERIC_FUNCS semantics, vectorized) ----------
    # Per-series twins: query/rollup_funcs.py window callables run under
    # generic_rollup, whose prevValue is mpi-gated — every prev use below
    # goes through gated_prev_mask() to match bit-for-bit.
    validc = np.arange(N)[None, :] < counts[:, None]

    def cum0(x):
        return np.concatenate([np.zeros((S, 1)), np.cumsum(x, axis=1)],
                              axis=1)

    def wsum_of(c):
        return (np.take_along_axis(c, hi, axis=1) -
                np.take_along_axis(c, lo, axis=1))

    def window_min_max():
        mn_w = np.empty((S, T))
        mx_w = np.empty((S, T))
        for s in range(S):
            arr_mn = np.concatenate([v2[s], [np.inf]])
            arr_mx = np.concatenate([v2[s], [-np.inf]])
            idx = np.stack([lo[s], hi[s]], axis=1).reshape(-1)
            mn_w[s] = np.minimum.reduceat(arr_mn, idx)[::2]
            mx_w[s] = np.maximum.reduceat(arr_mx, idx)[::2]
        return mn_w, mx_w

    with np.errstate(all="ignore"):
        if func == "sum2_over_time":
            return np.where(have, wsum_of(cum0(v2 * v2)), np.nan)

        if func == "range_over_time":
            mn_w, mx_w = window_min_max()
            return np.where(have, mx_w - mn_w, np.nan)

        if func in ("count_eq_over_time", "count_ne_over_time",
                    "count_le_over_time", "count_gt_over_time",
                    "share_eq_over_time", "share_le_over_time",
                    "share_gt_over_time", "sum_eq_over_time",
                    "sum_le_over_time", "sum_gt_over_time"):
            x = float(args[0])
            kind = func.split("_")[1]
            ind = {"eq": v2 == x, "ne": v2 != x, "le": v2 <= x,
                   "gt": v2 > x}[kind] & validc
            if func.startswith("sum_"):
                s = wsum_of(cum0(np.where(ind, v2, 0.0)))
            else:
                s = wsum_of(cum0(ind.astype(np.float64)))
                if func.startswith("share_"):
                    s = s / np.where(nwin > 0, nwin, 1)
            return np.where(have, s, np.nan)

        if func in ("resets", "increases_over_time", "decreases_over_time",
                    "ascent_over_time", "descent_over_time"):
            d = np.diff(v2, axis=1)
            e = np.zeros((S, N))
            if func in ("resets", "decreases_over_time"):
                e[:, 1:] = (d < 0).astype(np.float64)
            elif func == "increases_over_time":
                e[:, 1:] = (d > 0).astype(np.float64)
            elif func == "ascent_over_time":
                e[:, 1:] = np.maximum(d, 0.0)
            else:  # descent_over_time
                e[:, 1:] = np.maximum(-d, 0.0)
            e[~validc] = 0.0
            ce = cum0(e)
            gprev = gated_prev_mask()
            start = np.minimum(lo + np.where(gprev, 0, 1), hi)
            s = np.take_along_axis(ce, hi, axis=1) - \
                np.take_along_axis(ce, start, axis=1)
            return np.where(have, s, np.nan)

        if func == "integrate":
            # e[i] = v[i-1] * dt(i-1, i): the prev-pair term rides e[lo]
            e = np.zeros((S, N))
            e[:, 1:] = v2[:, :-1] * (np.diff(ts2, axis=1) / 1e3)
            e[~validc] = 0.0
            ce = cum0(e)
            gprev = gated_prev_mask()
            start = np.minimum(lo + np.where(gprev, 0, 1), hi)
            s = np.take_along_axis(ce, hi, axis=1) - \
                np.take_along_axis(ce, start, axis=1)
            return np.where(have, s, np.nan)

        if func == "duration_over_time":
            e = np.zeros((S, N))
            dms = np.diff(ts2, axis=1).astype(np.float64)
            if args:
                dms = np.where(dms <= float(args[0]) * 1e3, dms, 0.0)
            e[:, 1:] = dms / 1e3
            e[~validc] = 0.0
            ce = cum0(e)
            start = np.minimum(lo + 1, hi)  # strictly in-window pairs
            s = np.take_along_axis(ce, hi, axis=1) - \
                np.take_along_axis(ce, start, axis=1)
            return np.where(have, s, np.nan)

        if func == "rate_over_sum":
            s1 = wsum_of(cum0(v2))
            gprev = gated_prev_mask()
            t_last = gather(ts2, last_i)
            t_base = np.where(gprev, gather(ts2, pidx), gather(ts2, lo))
            dt = (t_last - t_base) / 1e3
            return np.where(have & (dt > 0), s1 / dt, np.nan)

        if func == "geomean_over_time":
            if bool(((v2 == 0) & validc).any()):
                return None  # log-sum form breaks on zeros: per-series path
            lg = np.where(validc, np.log(np.abs(v2)), 0.0)
            s = wsum_of(cum0(lg))
            return np.where(have,
                            np.exp(s / np.where(nwin > 0, nwin, 1)), np.nan)

        if func == "ideriv":
            i2 = np.clip(hi - 2, 0, N - 1)
            two = nwin >= 2
            v_last = gather(v2, last_i)
            t_last = gather(ts2, last_i)
            dt2 = (t_last - gather(ts2, i2)) / 1e3
            dv2 = v_last - gather(v2, i2)
            gprev = gated_prev_mask()
            dt1 = (t_last - gather(ts2, pidx)) / 1e3
            dv1 = v_last - gather(v2, pidx)
            r2 = np.where(dt2 > 0, dv2 / dt2, np.nan)
            r1 = np.where(dt1 > 0, dv1 / dt1, np.nan)
            res = np.where(two, r2,
                           np.where((nwin == 1) & gprev, r1, np.nan))
            return np.where(have, res, np.nan)

        if func == "changes_prometheus":
            ind = np.zeros((S, N))
            ind[:, 1:] = (np.diff(v2, axis=1) != 0).astype(np.float64)
            ind[~validc] = 0.0
            cz = cum0(ind)
            start = np.minimum(lo + 1, hi)
            s = np.take_along_axis(cz, hi, axis=1) - \
                np.take_along_axis(cz, start, axis=1)
            return np.where(have, s, np.nan)

        if func in ("delta_prometheus", "increase_prometheus",
                    "rate_prometheus"):
            arr = v2 if func == "delta_prometheus" \
                else remove_counter_resets(v2)
            d = gather(arr, last_i) - gather(arr, lo)
            if func == "rate_prometheus":
                d = d / (cfg.lookback / 1e3)
            return np.where(have & (nwin >= 2), d, np.nan)

        if func == "predict_linear":
            t_rel = np.where(validc, (ts2 - cfg.start) / 1e3, 0.0)
            vv = np.where(validc, v2, 0.0)
            ct_, ctt = cum0(t_rel), cum0(t_rel * t_rel)
            cv_, ctv = cum0(vv), cum0(t_rel * vv)
            n = nwin.astype(np.float64)
            st, sv = wsum_of(ct_), wsum_of(cv_)
            stt, stv = wsum_of(ctt), wsum_of(ctv)
            den = n * stt - st * st
            k = np.where(den != 0, (n * stv - st * sv) / den, np.nan)
            u0 = gather(ts2, lo)
            b = sv / np.where(n > 0, n, 1) - \
                k * (st / np.where(n > 0, n, 1) - (u0 - cfg.start) / 1e3)
            dt = (out_ts[None, :] - u0) / 1e3 + float(args[0])
            res = k * dt + b
            return np.where(have & (nwin >= 2) & (den != 0), res, np.nan)

        if func == "zscore_over_time":
            s1 = wsum_of(cum0(v2))
            n = np.where(nwin > 0, nwin, 1).astype(np.float64)
            avg = s1 / n
            shift = v2[:, :1]
            vc = np.where(validc, v2 - shift, 0.0)
            s1c = wsum_of(cum0(vc))
            s2c = wsum_of(cum0(vc * vc))
            var = np.maximum(s2c / n - (s1c / n) ** 2, 0.0)
            sd = np.sqrt(var)
            v_last = gather(v2, last_i)
            t_last = gather(ts2, last_i)
            gprev = gated_prev_mask()
            t_first = gather(ts2, lo)
            # scrape interval per _w_zscore: prev -> (t_last-pt)/n over n
            # samples; else (t_last-t[0])/(n-1), needing >= 2 samples
            si = np.where(gprev, (t_last - gather(ts2, pidx)) / 1e3 / n,
                          (t_last - t_first) / 1e3 /
                          np.maximum(nwin - 1, 1))
            lag = (out_ts[None, :] - t_last) / 1e3
            ok = have & (gprev | (nwin >= 2)) & (lag <= si)
            d = v_last - avg
            res = np.where(d == 0, 0.0, np.where(sd > 0, d / sd, np.nan))
            return np.where(ok, res, np.nan)

        if func in ("hoeffding_bound_lower", "hoeffding_bound_upper"):
            phi = float(args[0])
            s1 = wsum_of(cum0(v2))
            n = np.where(nwin > 0, nwin, 1).astype(np.float64)
            avg = s1 / n
            mn_w, mx_w = window_min_max()
            rng = mx_w - mn_w
            if 0 < phi < 1:
                bound = np.where(
                    (nwin >= 2) & (rng != 0),
                    rng * np.sqrt(np.log(1.0 / (1 - phi)) / (2 * n)), 0.0)
            else:
                bound = np.zeros((S, T))
            if func == "hoeffding_bound_lower":
                res = np.maximum(avg - bound, 0.0)
            else:
                res = avg + bound
            return np.where(have, res, np.nan)

        if func in ("quantile_over_time", "median_over_time",
                    "mad_over_time", "iqr_over_time",
                    "outlier_iqr_over_time", "tmin_over_time",
                    "tmax_over_time", "distinct_over_time",
                    "mode_over_time", "tlast_change_over_time"):
            return _order_stat_batch(func, args, ts2, v2, counts, cfg,
                                     out_ts, lo, hi, nwin, have, last_i,
                                     pidx, gated_prev_mask, gather)

    return None


def _order_stat_batch(func, args, ts2, v2, counts, cfg, out_ts, lo, hi,
                      nwin, have, last_i, pidx, gated_prev_mask, gather):
    """Windowed order statistics: windows are materialized as a chunked
    (S, Tc, W) gather (NaN-padded) and reduced with nan-aware numpy ops —
    the vectorized analog of per-window np.quantile/unique loops. Chunks
    are sized to a flat element budget so wide windows degrade to smaller
    T slices instead of blowing memory."""
    S, N = ts2.shape
    T = out_ts.size
    phi = None
    if func == "quantile_over_time":
        phi = float(args[0])
        if phi < 0:
            return np.where(have, -np.inf, np.nan)
        if phi > 1:
            return np.where(have, np.inf, np.nan)
    out = np.full((S, T), np.nan)
    col_w = nwin.max(axis=0)  # worst-case window width per output step
    budget = 4_000_000  # flat elements per chunk (~32MB f64)
    t0 = 0
    import warnings
    with np.errstate(all="ignore"), warnings.catch_warnings():
        # empty windows are legitimately all-NaN slices; `have` masks them
        warnings.simplefilter("ignore", RuntimeWarning)
        while t0 < T:
            w = int(col_w[t0])
            t1 = t0 + 1
            wmax = max(w, 1)
            while t1 < T:
                nw = max(wmax, int(col_w[t1]))
                if S * (t1 + 1 - t0) * nw > budget:
                    break
                wmax = nw
                t1 += 1
            tc = slice(t0, t1)
            if col_w[tc].max() == 0:
                t0 = t1
                continue
            idx = lo[:, tc, None] + np.arange(wmax)[None, None, :]
            valid = idx < hi[:, tc, None]
            flat = np.clip(idx, 0, N - 1) + \
                (np.arange(S, dtype=np.int64) * N)[:, None, None]
            wv = np.where(valid, np.take(v2.reshape(-1), flat), np.nan)
            _order_stat_chunk(func, phi, out, tc, wv, valid, ts2, flat,
                              v2, counts, lo, hi, nwin, have, last_i,
                              pidx, gated_prev_mask, gather)
            t0 = t1
    return np.where(have, out, np.nan)


def _order_stat_chunk(func, phi, out, tc, wv, valid, ts2, flat, v2,
                      counts, lo, hi, nwin, have, last_i, pidx,
                      gated_prev_mask, gather):
    S = out.shape[0]

    def q_sorted(sv, p):
        # np.quantile's linear interpolation over the first m valid (sorted)
        # entries per window; NaN padding sorts to the end. nanquantile
        # itself degrades to apply_along_axis on NaN-bearing 3-D input
        # (~1000x slower) — this is the vectorized equivalent.
        m = nwin[:, tc]
        pos = p * np.maximum(m - 1, 0)
        j0 = np.floor(pos).astype(np.int64)
        frac = pos - j0
        j1 = np.minimum(j0 + 1, np.maximum(m - 1, 0))
        a = np.take_along_axis(sv, j0[:, :, None], axis=2)[:, :, 0]
        b = np.take_along_axis(sv, j1[:, :, None], axis=2)[:, :, 0]
        return a * (1 - frac) + b * frac

    if func in ("quantile_over_time", "median_over_time"):
        out[:, tc] = q_sorted(np.sort(wv, axis=2),
                              phi if func == "quantile_over_time" else 0.5)
    elif func == "mad_over_time":
        med = q_sorted(np.sort(wv, axis=2), 0.5)
        out[:, tc] = q_sorted(np.sort(np.abs(wv - med[:, :, None]), axis=2),
                              0.5)
    elif func == "iqr_over_time":
        sv = np.sort(wv, axis=2)
        out[:, tc] = q_sorted(sv, 0.75) - q_sorted(sv, 0.25)
    elif func == "outlier_iqr_over_time":
        sv = np.sort(wv, axis=2)
        q25, q75 = q_sorted(sv, 0.25), q_sorted(sv, 0.75)
        iqr = 1.5 * (q75 - q25)
        v_last = gather(v2, last_i)[:, tc]
        hit = (v_last > q75 + iqr) | (v_last < q25 - iqr)
        out[:, tc] = np.where((nwin[:, tc] >= 2) & hit, v_last, np.nan)
    elif func in ("tmin_over_time", "tmax_over_time"):
        fill = np.inf if func == "tmin_over_time" else -np.inf
        wf = np.where(valid, wv, fill)
        j = (np.argmin(wf, axis=2) if func == "tmin_over_time"
             else np.argmax(wf, axis=2))
        tflat = np.take(ts2.reshape(-1),
                        np.take_along_axis(flat, j[:, :, None],
                                           axis=2)[:, :, 0])
        out[:, tc] = tflat / 1e3
    elif func == "distinct_over_time":
        sv = np.sort(wv, axis=2)  # NaN sorts to the end
        fresh = np.ones(sv.shape, bool)
        fresh[:, :, 1:] = sv[:, :, 1:] != sv[:, :, :-1]
        out[:, tc] = (fresh & ~np.isnan(sv)).sum(axis=2)
    elif func == "mode_over_time":
        sv = np.sort(wv, axis=2)
        W = sv.shape[2]
        newrun = np.ones(sv.shape, bool)
        newrun[:, :, 1:] = sv[:, :, 1:] != sv[:, :, :-1]
        pos = np.arange(W)
        first = np.maximum.accumulate(np.where(newrun, pos, 0), axis=2)
        # run length at each position's run start = (next run start) - start;
        # count for position i = i - first[i] + 1, max at the run's END
        cnt = pos[None, None, :] - first + 1
        cnt = np.where(np.isnan(sv), -1, cnt)
        j = np.argmax(cnt, axis=2)
        out[:, tc] = np.take_along_axis(sv, j[:, :, None], axis=2)[:, :, 0]
    elif func == "tlast_change_over_time":
        v_last = gather(v2, last_i)[:, tc]
        neq = valid & (wv != v_last[:, :, None])
        W = wv.shape[2]
        jj = np.where(neq, np.arange(W)[None, None, :], -1).max(axis=2)
        changed = jj >= 0
        tflat = np.take(ts2.reshape(-1),
                        np.take_along_axis(flat,
                                           np.clip(jj + 1, 0, W - 1)
                                           [:, :, None], axis=2)[:, :, 0])
        t_first = gather(ts2, lo)[:, tc]
        gprev = gated_prev_mask()[:, tc]
        pv = gather(v2, pidx)[:, tc]
        no_change_val = np.where(~gprev | (pv != v_last),
                                 t_first / 1e3, np.nan)
        out[:, tc] = np.where(changed, tflat / 1e3, no_change_val)
