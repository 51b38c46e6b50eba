"""ColumnarSeries: a search result as padded (S, N) host columns.

The port's copy of ``victoriametrics_tpu/storage/columnar.py:ColumnarSeries``
(the class only, not the block assembler): what a storage's
``search_columns`` returns and what the rolling append
(``query/cuda_engine._append_cols``) consumes.

Layout contract:
  ts     (S, N) int64, per-row sorted, padded with INT64_MAX
  vals   (S, N) float64, padding zeros
  counts (S,)   valid lengths
"""

from __future__ import annotations

import numpy as np

from ..ops.decimal import is_stale_nan

PAD_TS = np.iinfo(np.int64).max


class ColumnarSeries:
    """Padded columnar form of a search result; row order matches
    metric_ids/raw_names/metric_names."""

    __slots__ = ("metric_ids", "ts", "vals", "counts", "raw_names",
                 "metric_names", "stale_rows")

    def __init__(self, metric_ids, ts, vals, counts, raw_names=None,
                 metric_names=None, stale_rows=None):
        self.metric_ids = metric_ids
        self.ts = ts
        self.vals = vals
        self.counts = counts
        self.raw_names = raw_names
        self.metric_names = metric_names
        # None = no staleness markers anywhere; else (S,) bool
        self.stale_rows = stale_rows

    @classmethod
    def empty(cls) -> "ColumnarSeries":
        return cls(np.zeros(0, np.int64), np.zeros((0, 0), np.int64),
                   np.zeros((0, 0), np.float64), np.zeros(0, np.int64),
                   [], [])

    @property
    def n_series(self) -> int:
        return int(self.metric_ids.size)

    @property
    def n_samples(self) -> int:
        return int(self.counts.sum()) if self.counts.size else 0

    def drop_stale_nans(self):
        """Remove Prometheus staleness-marker samples in place (the
        eval-side dropStaleNaNs, batched)."""
        if self.stale_rows is None:
            return
        for s in np.flatnonzero(self.stale_rows):
            n = int(self.counts[s])
            keep = ~is_stale_nan(self.vals[s, :n])
            m = int(keep.sum())
            if m == n:
                continue
            self.ts[s, :m] = self.ts[s, :n][keep]
            self.vals[s, :m] = self.vals[s, :n][keep]
            self.ts[s, m:n] = PAD_TS
            self.vals[s, m:n] = 0.0
            self.counts[s] = m
        self.stale_rows = None
