"""Columnar series assembly: matched blocks -> padded (S, N) device-ready
columns in O(total_samples) vectorized passes.

This is the TPU-first replacement for the reference's per-series unpack
worker pool (app/vmselect/netstorage/netstorage.go:374-421): instead of
fanning per-series block unpacking across goroutines, ALL matched blocks are
decoded in one native call per part (part.read_blocks_columns) and scattered
into a padded (S, N) tile layout that the batched host rollup
(ops/rollup_np.rollup_batch_packed) and the device tile packer consume
without any per-series Python work.

Layout contract (shared with rollup_batch_packed and ops/device_rollup):
  ts    (S, N) int64, per-row sorted, padded with INT64_MAX
  vals  (S, N) float64, padding zeros (harmless for cumsum formulations)
  counts (S,) valid lengths

The port's copy of ``victoriametrics_tpu/storage/columnar.py``, whole.
"""

from __future__ import annotations

import numpy as np

PAD_TS = np.iinfo(np.int64).max


class ColumnarSeries:
    """Padded columnar form of a search result; row order matches
    metric_ids/raw_names/metric_names."""

    __slots__ = ("metric_ids", "ts", "vals", "counts", "raw_names",
                 "metric_names", "stale_rows", "dropped_rows", "ds_res",
                 "partial_res")

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
        # row indices (pre-drop numbering) removed as empty by the clip
        self.dropped_rows = None
        # downsampled-tier provenance (storage/downsample.py): coarsest
        # resolution actually served (0 = raw only), and whether a fetch
        # fell back to a tier coarser than the query's step allows
        self.ds_res = 0
        self.partial_res = False

    @classmethod
    def empty(cls) -> "ColumnarSeries":
        return cls(np.zeros(0, np.int64), np.zeros((0, 0), np.int64),
                   np.zeros((0, 0), np.float64), np.zeros(0, np.int64),
                   [], [])

    def compute_stale_rows(self) -> None:
        """Set stale_rows from the decoded values (staleness-marker
        presence per row; skips eval-side scans in the no-stale case)."""
        if not self.n_series:
            return
        from ..ops.decimal import is_stale_nan
        if bool(np.isnan(self.vals).any()):
            stale = is_stale_nan(self.vals)
            stale &= self.ts != PAD_TS
            rows = stale.any(axis=1)
            self.stale_rows = rows if bool(rows.any()) else None

    @property
    def n_series(self) -> int:
        return int(self.metric_ids.size)

    @property
    def n_samples(self) -> int:
        return int(self.counts.sum()) if self.counts.size else 0

    def ts_list(self) -> list[np.ndarray]:
        """Per-series timestamp views (for adjusted_windows etc.)."""
        c = self.counts
        return [self.ts[s, :c[s]] for s in range(self.n_series)]

    def to_series_list(self):
        """Materialize SeriesData views for per-series fallback paths."""
        from .storage import SeriesData
        out = []
        c = self.counts
        stale = self.stale_rows
        for s in range(self.n_series):
            n = int(c[s])
            sd = SeriesData(self.metric_names[s], self.ts[s, :n],
                            self.vals[s, :n], self.raw_names[s],
                            maybe_stale=bool(stale[s])
                            if stale is not None else False)
            out.append(sd)
        return out

    def drop_stale_nans(self):
        """Remove Prometheus staleness-marker samples in place (the
        eval-side dropStaleNaNs analog, but batched)."""
        if self.stale_rows is None:
            return
        from ..ops.decimal import is_stale_nan
        bad_rows = np.flatnonzero(self.stale_rows)
        for s in bad_rows:
            n = int(self.counts[s])
            stale = is_stale_nan(self.vals[s, :n])
            keep = ~stale
            m = int(keep.sum())
            if m == n:
                continue
            self.ts[s, :m] = self.ts[s, :n][keep]
            self.vals[s, :m] = self.vals[s, :n][keep]
            self.ts[s, m:n] = PAD_TS
            self.vals[s, m:n] = 0.0
            self.counts[s] = m
        self.stale_rows = None


def _ranges(cnts: np.ndarray, total: int) -> np.ndarray:
    """[0..c0) ++ [0..c1) ++ ... as one array."""
    excl = np.cumsum(cnts) - cnts
    return np.arange(total, dtype=np.int64) - np.repeat(excl, cnts)


def assemble(rows: np.ndarray, S: int, cnts: np.ndarray, ts_all: np.ndarray,
             vals_f: np.ndarray, min_ts: int, max_ts: int,
             dedup_interval_ms: int = 0,
             metric_ids: np.ndarray | None = None) -> ColumnarSeries:
    """Scatter per-block decoded samples into the padded (S, N) layout,
    then per-row sort-fix / range-clip / dedup — all mostly-vectorized with
    per-row work only on the (rare) rows that need it.

    `rows` assigns each block its target row (callers bake the final
    output ordering in here, so no post-assembly reorder pass is needed);
    `metric_ids` is the per-ROW id array (S,) carried through."""
    rows = np.asarray(rows, dtype=np.int64)
    cnts = np.asarray(cnts, dtype=np.int64)
    tot = int(cnts.sum())
    if metric_ids is None:
        metric_ids = np.zeros(S, np.int64)
    if S == 0 or tot == 0:
        return ColumnarSeries(metric_ids[:0], np.zeros((0, 0), np.int64),
                              np.zeros((0, 0), np.float64),
                              np.zeros(0, np.int64))
    blocks_per_row = np.bincount(rows, minlength=S)
    series_tot = np.bincount(rows, weights=cnts,
                             minlength=S).astype(np.int64)
    N = int(series_tot.max())
    from .. import native as _native
    single_block = bool((blocks_per_row <= 1).all())
    if _native.available():
        # one native pass: per-block memcpy into the padded layout (no
        # index arrays, no PAD prefill) — the scatter cost is pure sample
        # bandwidth for every block shape
        ts2, v2, _fill = _native.scatter_pad(
            np.ascontiguousarray(ts_all, np.int64),
            np.ascontiguousarray(vals_f, np.float64),
            cnts, rows, S, N, PAD_TS)
    elif single_block and tot == S * N:
        # one block per series, uniform length: a single row-scatter of the
        # reshaped decode output (the common scrape-grid case)
        ts2 = np.empty((S, N), dtype=np.int64)
        v2 = np.empty((S, N), dtype=np.float64)
        ts2[rows] = ts_all.reshape(-1, N)
        v2[rows] = vals_f.reshape(-1, N)
    else:
        order = np.argsort(rows, kind="stable")
        rows_o = rows[order]
        cnts_o = cnts[order]
        excl_o = np.cumsum(cnts_o) - cnts_o
        grp_first = np.searchsorted(rows_o, np.arange(S), side="left")
        base = excl_o[grp_first]            # samples before each series
        within = excl_o - base[rows_o]      # offset inside its series
        dest_start = rows_o * N + within
        local = _ranges(cnts_o, tot)
        dst_idx = np.repeat(dest_start, cnts_o) + local
        ts2 = np.full(S * N, PAD_TS, dtype=np.int64)
        v2 = np.zeros(S * N, dtype=np.float64)
        if bool((order == np.arange(order.size)).all()):
            ts2[dst_idx] = ts_all
            v2[dst_idx] = vals_f
        else:
            src_excl = np.cumsum(cnts) - cnts
            src_idx = np.repeat(src_excl[order], cnts_o) + local
            ts2[dst_idx] = ts_all[src_idx]
            v2[dst_idx] = vals_f[src_idx]
        ts2 = ts2.reshape(S, N)
        v2 = v2.reshape(S, N)
    counts = series_tot

    # per-row sortedness fix: only rows assembled from >1 block can violate
    multi = blocks_per_row > 1
    if multi.any():
        cand = np.flatnonzero(multi)
        sub = ts2[cand]
        disorder = (np.diff(sub, axis=1) < 0).any(axis=1)
        bad = cand[disorder]
        if bad.size:
            sub = ts2[bad]
            ordr = np.argsort(sub, axis=1, kind="stable")  # PAD sorts last
            ts2[bad] = np.take_along_axis(sub, ordr, axis=1)
            v2[bad] = np.take_along_axis(v2[bad], ordr, axis=1)

    # range clip (blocks overhang [min_ts, max_ts]); rows are sorted so the
    # kept region is contiguous
    lo_i = (ts2 < min_ts).sum(axis=1)
    hi_i = (ts2 <= max_ts).sum(axis=1)
    new_counts = hi_i - lo_i
    if bool((lo_i > 0).any()) or bool((new_counts < counts).any()):
        lo0 = int(lo_i[0])
        n0 = int(new_counts[0])
        if bool((lo_i == lo0).all()) and bool((new_counts == n0).all()):
            # shared scrape grid: the kept region is the same column slice
            # for every row — pure views, no copy
            ts2 = ts2[:, lo0:lo0 + n0]
            v2 = v2[:, lo0:lo0 + n0]
            N = n0
        else:
            idx = np.minimum(lo_i[:, None] + np.arange(N)[None, :], N - 1)
            ts2 = np.take_along_axis(ts2, idx, axis=1)
            v2 = np.take_along_axis(v2, idx, axis=1)
            tail = np.arange(N)[None, :] >= new_counts[:, None]
            ts2[tail] = PAD_TS
            v2[tail] = 0.0
        counts = new_counts

    # exact-duplicate timestamps (replica merges): keep the LAST sample of
    # each run, matching search_series semantics
    W = ts2.shape[1]
    dup_rows = ((ts2[:, 1:] == ts2[:, :-1]) &
                (ts2[:, 1:] != PAD_TS)).any(axis=1) if W > 1 else \
        np.zeros(S, bool)
    if dedup_interval_ms > 0 and W > 1:
        # batched needs_dedup: a row pays the per-row pass only when two
        # consecutive samples share a dedup bucket (ordinary well-spaced
        # scrapes stay fully vectorized)
        valid_next = np.arange(1, W)[None, :] < counts[:, None]
        b = (np.where(ts2 == PAD_TS, 0, ts2) + (dedup_interval_ms - 1)) \
            // dedup_interval_ms
        dup_rows |= ((b[:, 1:] == b[:, :-1]) & valid_next).any(axis=1)
    need_dedup = dedup_interval_ms > 0
    if dup_rows.any():
        from .dedup import deduplicate
        rows_iter = np.flatnonzero(dup_rows)
        if _native.available():
            # one GIL-released pass over the flagged rows (vm_dedup_rows):
            # interval dedup + exact-duplicate keep-last, compaction and
            # tail padding in place — bit-exact with the loop below (the
            # no-native oracle the equality tests diff against)
            counts = np.ascontiguousarray(counts, dtype=np.int64)
            _native.dedup_rows(ts2, v2, counts, rows_iter,
                               dedup_interval_ms if need_dedup else 0,
                               PAD_TS)
            rows_iter = ()
        for s in rows_iter:
            n = int(counts[s])
            t = ts2[s, :n]
            v = v2[s, :n]
            if need_dedup:
                t, v = deduplicate(t, v, dedup_interval_ms)
            if t.size > 1:
                keep = np.concatenate([t[1:] != t[:-1], [True]])
                if not keep.all():
                    t, v = t[keep], v[keep]
            m = t.size
            if m != n:  # only ever shrinks; shrunk t/v are fresh copies
                ts2[s, :m] = t
                v2[s, :m] = v
                ts2[s, m:n] = PAD_TS
                v2[s, m:n] = 0.0
                counts[s] = m

    # drop series left empty by the clip (callers' row-aligned lists are
    # rebuilt from metric_ids/empty_rows)
    empty_rows = None
    if bool((counts == 0).any()):
        keep = counts > 0
        empty_rows = np.flatnonzero(~keep)
        metric_ids, ts2, v2, counts = (metric_ids[keep], ts2[keep], v2[keep],
                                       counts[keep])
    # trim the padded width after clipping
    if counts.size:
        n_max = int(counts.max())
        if n_max < ts2.shape[1]:
            ts2 = ts2[:, :n_max]
            v2 = v2[:, :n_max]
    out = ColumnarSeries(metric_ids, ts2, v2, counts)
    out.dropped_rows = empty_rows
    return out
