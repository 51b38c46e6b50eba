"""Sample deduplication (reference lib/storage/dedup.go:30-121).

Keeps one sample per dedup interval. Windows are right-inclusive at exact
interval multiples: a sample at k*interval closes the window ending there
(tsNext = (ts0+interval-1) - (ts0+interval-1) % interval in the reference).
The kept sample is the one with the highest timestamp in the window; on
equal timestamps the maximum value wins, always preferring a non-stale
value over a staleness marker (issues 3333, 10196).
Applied at merge time (final dedup) and query time.

The port's copy of ``victoriametrics_tpu/storage/dedup.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..ops import decimal as dec


def _buckets(timestamps: np.ndarray, interval_ms: int) -> np.ndarray:
    # right-inclusive window id: ceil(ts / interval), exact multiples map
    # to their own boundary
    return (timestamps + (interval_ms - 1)) // interval_ms


def needs_dedup(timestamps: np.ndarray, interval_ms: int) -> bool:
    if interval_ms <= 0 or timestamps.size < 2:
        return False
    d = np.diff(_buckets(timestamps, interval_ms))
    return bool((d == 0).any())


def deduplicate(timestamps: np.ndarray, values: np.ndarray, interval_ms: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """values may be float64 or int64 mantissas; rows must be time-sorted."""
    if not needs_dedup(timestamps, interval_ms):
        return timestamps, values
    buckets = _buckets(timestamps, interval_ms)
    # last index of each bucket run
    last = np.flatnonzero(np.diff(buckets, append=buckets[-1] + 1) != 0)
    keep_ts = timestamps[last]
    keep_vals = values[last].copy()
    # within a run ending at `last[i]`, if several samples share the max
    # timestamp, prefer the max non-stale value (stale only if all stale)
    starts = np.concatenate([[0], last[:-1] + 1])
    for i, (a, b) in enumerate(zip(starts, last + 1)):
        if b - a < 2:
            continue
        tmax = timestamps[b - 1]
        ties = np.flatnonzero(timestamps[a:b] == tmax) + a
        if ties.size < 2:
            continue
        vals = values[ties]
        if np.issubdtype(vals.dtype, np.floating):
            stale = dec.is_stale_nan(vals)
        else:
            stale = vals == dec.V_STALE_NAN
        # backward scan exactly as the reference: skip stale candidates,
        # a non-stale value always replaces a stale vPrev, otherwise only
        # strictly-greater values win (plain NaN never compares greater)
        vprev = vals[-1]
        vprev_stale = bool(stale[-1])
        for j in range(vals.size - 2, -1, -1):
            if stale[j]:
                continue
            if vprev_stale:
                vprev = vals[j]
                vprev_stale = False
            elif vals[j] > vprev:
                vprev = vals[j]
        keep_vals[i] = vprev
    return keep_ts, keep_vals
