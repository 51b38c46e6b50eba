"""Rollup result cache (reference app/vmselect/promql/
rollup_result_cache.go:39-364): caches range-query results keyed by
(query, step) so repeated/refreshing queries only compute the new tail,
merging cached prefixes with freshly computed suffixes.

Entries store ONE (S, T) float64 block per query on the entry's own
step-aligned grid plus parallel raw-name/MetricName lists; hits, merges
and puts are whole-block NumPy ops — no per-series marshal/unmarshal on
the steady-state path (that churn used to cost more than the tail fetch
itself). A hit requires the request grid to be phase-aligned with the
cached grid — the HTTP layer aligns start/end to the step (AdjustStartEnd
analog) so this always holds for dashboard refreshes. Backfill older than
the cached window resets the cache (ResetRollupResultCacheIfNeeded
analog).

Ring entries (VM_RESULT_CACHE_RING, default on): each entry's block lives
inside a larger buffer with reserved headroom columns/rows, and the entry
window is a (col_off, n_cols) view into it.  A rolling dashboard refresh
then merges IN PLACE: the fresh suffix columns are scattered into the
buffer, the start offset advances, and ``merge()`` returns read-only
zero-copy views over the buffer instead of reallocating a fresh (S, T)
block per refresh (the O(S*T) copy that used to dominate steady-state
serving).  When the window slides past the buffer's right edge the live
columns are compacted into a NEW buffer (amortized one column per
refresh); the old buffer is left intact so earlier hits' views stay
valid.  Contract: rows returned by an in-place ``merge()`` are read-only
views that stay stable for their whole lifetime — the entry keeps
weakrefs to the views it handed out, and a later merge that would
overwrite still-referenced columns (a concurrent refresh of the same key
racing an in-flight response serialization) compacts into a fresh buffer
instead of writing through the aliased one.  Sequential steady-state
refreshes drop the previous response before the next merge, so the
liveness check costs nothing there.  ``VM_RESULT_CACHE_RING=0`` restores
the full rebuild path exactly (the equality oracle).

The cache is bounded by BYTES as well as entries: ``max_bytes`` (env
``VM_RESULT_CACHE_MAX_BYTES``, default 1/8 of physical RAM — the
reference's cache sizing) LRU-evicts whole entries; the most recently
used entry is never evicted, so one over-budget entry degrades to a
bounded single-entry cache instead of thrashing.

The port's copy of ``victoriametrics_tpu/query/rollup_result_cache.py``,
whole.
"""

from __future__ import annotations

import itertools
import os
import threading
import time as _time
import weakref

import numpy as np

from ..storage.metric_name import MetricName
from ..utils import costacc as _costacc
from ..utils import flightrec as _flightrec
from ..utils import metrics as metricslib
from .types import EvalConfig, Timeseries

_instances: "weakref.WeakSet[RollupResultCache]" = weakref.WeakSet()
_CACHE_REQUESTS = metricslib.REGISTRY.counter(
    'vm_cache_requests_total{type="promql/rollupResult"}')
_CACHE_MISSES = metricslib.REGISTRY.counter(
    'vm_cache_misses_total{type="promql/rollupResult"}')
metricslib.REGISTRY.gauge(
    'vm_cache_entries{type="promql/rollupResult"}',
    callback=lambda: sum(c.entry_count() for c in list(_instances)))
metricslib.REGISTRY.gauge(
    'vm_cache_size_bytes{type="promql/rollupResult"}',
    callback=lambda: sum(c.size_bytes() for c in list(_instances)))
metricslib.REGISTRY.gauge(
    'vm_cache_max_size_bytes{type="promql/rollupResult"}',
    callback=lambda: sum(c.max_bytes for c in list(_instances)))
# steady-state merge health: wall time spent stitching prefix+suffix, and
# how many merges extended the entry in place vs rebuilt a fresh block
_MERGE_SECONDS = metricslib.REGISTRY.float_counter(
    "vm_rollup_cache_merge_seconds_total")
_INPLACE = metricslib.REGISTRY.counter("vm_rollup_cache_inplace_total")
_REBUILD = metricslib.REGISTRY.counter("vm_rollup_cache_rebuild_total")
# puts that skipped the per-series identity rebuild because the raw-name
# list was unchanged (distinct from _INPLACE: this also ticks on the
# ring-off oracle path, where every merge still rebuilds)
_PUT_REUSE = metricslib.REGISTRY.counter(
    "vm_rollup_cache_put_identity_reused_total")

# Cached series tails are clipped back by this much: the freshest points may
# still change (late samples within the flush window) — cacheTimestampOffset.
OFFSET_MS = 5 * 60_000

# ring-entry headroom: spare suffix columns consumed ~1 per rolling refresh
# (compaction copies the live window once every COL_HEADROOM refreshes) and
# spare row slots for series appearing mid-window
COL_HEADROOM = 64
ROW_HEADROOM = 8


def ring_enabled() -> bool:
    """Ring (in-place merge) entries on?  VM_RESULT_CACHE_RING=0 restores
    the rebuild-every-merge path exactly — the equality oracle."""
    return os.environ.get("VM_RESULT_CACHE_RING", "1") != "0"


def _default_max_bytes() -> int:
    """~1/8 of physical RAM (the reference's cache sizing); floor keeps
    tiny containers serviceable."""
    try:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        total = 8 << 30
    return max(total // 8, 64 << 20)


_storage_tokens = itertools.count(1)


def next_storage_token() -> int:
    """Unique per-storage-instance token for cache keys: id() could be
    reused after GC, silently serving another storage's entries."""
    return next(_storage_tokens)


def _copy_name(mn: MetricName) -> MetricName:
    return MetricName(mn.metric_group, list(mn.labels))


def _raw_of(ts: Timeseries, trust_raw: bool) -> bytes:
    """Series identity for cache keying. `trust_raw=True` is ONLY safe for
    rows the caller just built and has not exposed to any code that could
    mutate metric_name in place (the eval-level rollup path): transforms,
    binops and multi-output rollups edit labels in place, leaving ts.raw
    stale — distinct output series then collide on one raw and merge()
    stitches them wrongly. Post-transform callers (the HTTP-level cache)
    must pass trust_raw=False and pay the marshal."""
    if trust_raw and ts.raw is not None:
        return ts.raw
    return ts.metric_name.marshal()


class _Entry:
    """One cached block.  The live window is buf[:n_rows,
    col_off:col_off+n_cols] on the step grid anchored at c_start; rows
    beyond n_rows and columns outside the window are headroom/scratch.
    raws/names/idx are treated copy-on-append: mutations REBIND the lists
    so CacheHit snapshots stay stable."""

    __slots__ = ("c_start", "c_end", "step", "raws", "names", "idx",
                 "buf", "n_rows", "col_off", "gen", "served", "out_refs")

    def __init__(self, c_start, c_end, step, raws, names, buf, n_rows,
                 col_off):
        self.c_start = c_start
        self.c_end = c_end
        self.step = step
        self.raws = raws      # list[bytes], parallel to buf rows
        self.names = names    # list[MetricName], parallel to buf rows
        self.idx = {r: s for s, r in enumerate(raws)}
        self.buf = buf        # (row_cap, col_cap) float64
        self.n_rows = n_rows
        self.col_off = col_off
        self.gen = 0          # bumped on every mutation (hit validation)
        self.served = None    # (start, end, gen) stamp of an in-place merge
        self.out_refs = ()    # weakrefs to row views the last merge handed out

    @property
    def n_cols(self) -> int:
        return (self.c_end - self.c_start) // self.step + 1

    @property
    def vals(self) -> np.ndarray:
        """The live (S, n) window view."""
        return self.buf[:self.n_rows,
                        self.col_off:self.col_off + self.n_cols]

    def size_bytes(self) -> int:
        return self.buf.nbytes


def _new_entry(c_start: int, c_end: int, step: int, raws, names,
               vals: np.ndarray) -> _Entry:
    """Build an entry from a dense (S, n) block, reserving ring headroom
    when enabled (plain exact-size block otherwise)."""
    S, n = vals.shape
    if not ring_enabled():
        return _Entry(c_start, c_end, step, raws, names, vals, S, 0)
    rh = max(ROW_HEADROOM, S // 64)
    buf = np.empty((S + rh, n + COL_HEADROOM))
    buf[:S, :n] = vals
    return _Entry(c_start, c_end, step, raws, names, buf, S, 0)


class CacheHit:
    """A cache hit covering [ec.start, cov_end].  Snapshots the entry
    state at get() time (view + raw/name list refs + generation): the
    snapshot stays valid across later in-place merges because those only
    write columns beyond the then-final coverage, append rows beyond the
    snapshot, rebind (not mutate) the lists, and compact into fresh
    buffers."""

    __slots__ = ("entry", "key", "i0", "n", "gen", "view", "raws", "names")

    def __init__(self, entry: _Entry, key, i0: int, n: int):
        self.entry = entry
        self.key = key
        self.i0 = i0
        self.n = n
        self.gen = entry.gen
        v = entry.buf[:entry.n_rows,
                      entry.col_off + i0:entry.col_off + i0 + n].view()
        v.setflags(write=False)
        self.view = v
        self.raws = entry.raws
        self.names = entry.names

    def rows(self) -> list[Timeseries]:
        """Materialize as Timeseries (full-hit path). One block copy; the
        per-row views are handed out with fresh MetricName copies so
        caller mutation can't corrupt the entry."""
        vals = self.view.copy()
        return [Timeseries(_copy_name(self.names[s]), vals[s],
                           raw=self.raws[s])
                for s in range(len(self.raws))]


class RingBlock:
    """Fixed-row rolling (G, T) block with column headroom — the ring-cache
    entry machinery (headroom buffer + in-place column scatter + offset
    advance + weakref-guarded compaction) reused by the device plane for
    the host-side copy of the device-resident [G, T] aggregate.  Rows are
    groups (fixed identity, no churn), so this is `_Entry`/`merge()`
    stripped to its column mechanics: a rolling refresh writes only the
    freshly computed tail columns, re-serves the rest as zero-copy
    read-only row views, and compacts into a fresh buffer when headroom
    runs out or a still-alive earlier response aliases the buffer (the
    views-stable contract)."""

    __slots__ = ("buf", "G", "T", "col_off", "start", "end", "step",
                 "window", "out_refs")

    def __init__(self, out, start: int, end: int, step: int, window: int):
        out = np.asarray(out, dtype=np.float64)
        self.G, self.T = out.shape
        self.step = step
        self.window = window
        self.start = start
        self.end = end
        self.col_off = 0
        self.buf = np.empty((self.G, self.T + COL_HEADROOM))
        self.buf[:, :self.T] = out
        self.out_refs: tuple = ()

    def reset(self, out, start: int, end: int, step: int,
              window: int) -> None:
        """Reinitialize around a freshly computed full block (shape
        change, or an advance the sliding pattern doesn't cover).  The
        old buffer is left intact for any still-alive views."""
        self.__init__(out, start, end, step, window)

    def rows(self) -> list[np.ndarray]:
        """Read-only per-row views of the live window, remembered (by
        weakref) so a later in-place advance never writes through a row
        still held by an in-flight response."""
        win = self.buf[:, self.col_off:self.col_off + self.T].view()
        win.setflags(write=False)
        rows = [win[g] for g in range(self.G)]
        refs = [r for r in self.out_refs if r() is not None]
        refs.extend(weakref.ref(v) for v in rows)
        self.out_refs = tuple(refs)
        return rows

    def try_advance(self, start: int, end: int, step: int,
                    window: int) -> int | None:
        """Number of fresh tail columns needed to advance the window to
        [start, end] in the designed constant-shape sliding pattern
        (0 = pure re-serve), or None when the shape doesn't fit and the
        caller must recompute + reset().  Variable-length grids (suffix
        evals, narrowed ranges) deliberately don't fit — reused columns
        keep the estimates they were computed under, which is only the
        documented contract for the sliding-dashboard advance."""
        if step != self.step or window != self.window:
            return None
        if start < self.start or end < self.end:
            return None
        if (start - self.start) % step or \
                (start - self.start) != (end - self.end):
            return None
        if (end - start) // step + 1 != self.T:
            return None
        n_new = (end - self.end) // step
        if n_new >= self.T:
            return None  # disjoint windows: nothing reusable
        return n_new

    def commit(self, start: int, end: int, tail) -> list[np.ndarray]:
        """Advance in place per a successful try_advance: scatter the
        (G, n_new) tail columns, move the window offset, return fresh
        read-only row views.  When handed-out rows are still alive or the
        headroom is exhausted, the live columns compact into a FRESH
        buffer so earlier responses' views stay intact."""
        n_new = (end - self.end) // self.step
        shift = (start - self.start) // self.step
        col_off = self.col_off + shift
        alive = any(r() is not None for r in self.out_refs)
        if alive or col_off + self.T > self.buf.shape[1]:
            nb = np.empty((self.G, self.T + COL_HEADROOM))
            keep = self.T - n_new
            if keep:
                nb[:, :keep] = self.buf[
                    :, self.col_off + shift:self.col_off + self.T]
            self.buf = nb
            col_off = 0
            self.out_refs = ()
        if n_new:
            self.buf[:, col_off + self.T - n_new:col_off + self.T] = tail
        self.col_off = col_off
        self.start = start
        self.end = end
        return self.rows()


class RollupResultCache:
    def __init__(self, max_entries: int = 4096,
                 max_bytes: int | None = None):
        from collections import OrderedDict
        self._lock = threading.Lock()
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.max_entries = max_entries
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(
                    "VM_RESULT_CACHE_MAX_BYTES", "0"))
            except ValueError:
                max_bytes = 0
        if max_bytes <= 0:
            max_bytes = _default_max_bytes()
        self.max_bytes = max_bytes
        self._bytes = 0
        # per-instance thread-safe counters (the global vm_cache_* metrics
        # above aggregate over every live cache)
        self._hits = metricslib.Counter("hits")
        self._misses = metricslib.Counter("misses")
        _instances.add(self)

    @property
    def hits(self) -> int:
        return self._hits.get()

    @property
    def misses(self) -> int:
        return self._misses.get()

    def _key(self, ec: EvalConfig, q: str) -> tuple:
        # tenant MUST be part of the key (a shared entry would leak across
        # tenants), and so must the storage instance (one process can host
        # several storages: tests, embedded setups)
        token = getattr(ec.storage, "cache_token", None)
        return (token if token is not None else id(ec.storage),
                ec.tenant, q, ec.step)

    def _evict_locked(self) -> None:
        """LRU-evict until under both bounds; the most recently used entry
        survives even when alone over max_bytes (bounded either way)."""
        while (len(self._cache) > self.max_entries or
               self._bytes > self.max_bytes) and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._bytes -= old.size_bytes()

    def get(self, ec: EvalConfig, q: str, now_ms: int
            ) -> tuple[CacheHit | None, int]:
        """Returns (hit covering [ec.start, cov_end], first timestamp
        still to compute). (None, ec.start) on miss."""
        _CACHE_REQUESTS.inc()
        with self._lock:
            key = self._key(ec, q)
            e = self._cache.get(key)
            if e is None or e.c_start > ec.start or e.c_end < ec.start or \
                    (ec.start - e.c_start) % ec.step != 0:
                self._misses.inc()
                _CACHE_MISSES.inc()
                return None, ec.start
            self._cache.move_to_end(key)
            self._hits.inc()
            cov_end = min(e.c_end, ec.end)
            i0 = (ec.start - e.c_start) // ec.step
            n = (cov_end - ec.start) // ec.step + 1
            hit = CacheHit(e, key, i0, n)
        return hit, ec.start + n * ec.step

    def put(self, ec: EvalConfig, q: str, rows: list[Timeseries],
            now_ms: int, trust_raw: bool = True) -> None:
        t0 = _time.perf_counter()
        _costacc.restamp()
        try:
            self._put(ec, q, rows, now_ms, trust_raw)
        finally:
            _costacc.lap("cache:put", _time.perf_counter() - t0)

    def _put(self, ec: EvalConfig, q: str, rows: list[Timeseries],
             now_ms: int, trust_raw: bool = True) -> None:
        # don't cache the volatile tail
        cov_end_limit = now_ms - OFFSET_MS
        cov_end = ec.start + (
            (min(ec.end, cov_end_limit) - ec.start) // ec.step) * ec.step
        if cov_end < ec.start:
            return
        # NOTE: empty result sets ARE cached (zero-row entry) — a panel
        # over a dead selector must refresh tail-only, not re-scan the
        # full range every 30s
        n = (cov_end - ec.start) // ec.step + 1
        key = self._key(ec, q)
        ring = ring_enabled()
        if ring:
            with self._lock:
                e = self._cache.get(key)
                if e is not None and \
                        e.served == (ec.start, ec.end, e.gen):
                    # an in-place merge already finalized this entry for
                    # exactly this window (including the volatile-tail
                    # trim) — the put is a pure no-op
                    e.served = None
                    self._cache.move_to_end(key)
                    return
        # collapse duplicate identities (last row wins, matching the old
        # dict-keyed entries): keeping both would desync merge()'s
        # raw->row index and freeze one row's tail forever
        by_raw: dict[bytes, int] = {}
        for s, ts in enumerate(rows):
            by_raw[_raw_of(ts, trust_raw)] = s
        raws = list(by_raw.keys())
        sel = list(by_raw.values())
        vals = np.empty((len(raws), n))
        for j, s in enumerate(sel):
            v = rows[s].values
            vals[j, :] = v[:n] if v.size >= n else np.pad(
                v, (0, n - v.size), constant_values=np.nan)
        with self._lock:
            old = self._cache.get(key)
            # identity unchanged since the last put of this key: reuse
            # the existing (already-copied) MetricName list instead of
            # re-copying S names per steady-state refresh (entry lists
            # are rebound, never mutated, so sharing them is safe)
            names_src = old.names if old is not None and \
                old.raws == raws else None
        if names_src is not None:
            _PUT_REUSE.inc()
        else:
            names_src = [_copy_name(rows[s].metric_name) for s in sel]
        # the O(S*T) buffer allocation + copy happens OUTSIDE the cache
        # lock: a large first-eval put must not stall every other key's
        # get/merge behind a multi-hundred-MB memcpy
        e = _new_entry(ec.start, cov_end, ec.step, raws, names_src, vals)
        with self._lock:
            old = self._cache.get(key)
            if old is not None:
                self._bytes -= old.size_bytes()
            self._cache[key] = e
            self._bytes += e.size_bytes()
            self._cache.move_to_end(key)
            self._evict_locked()

    def merge(self, hit: CacheHit, fresh: list[Timeseries],
              ec: EvalConfig, new_start: int, trust_raw: bool = True,
              now_ms: int | None = None) -> list[Timeseries]:
        """Stitch the cached prefix block with freshly computed suffix
        rows.  Ring path: the suffix columns are written into the entry
        buffer in place, the entry window advances, and the returned rows
        are read-only zero-copy views (valid until the next merge of the
        same key).  Fallback/oracle path: block-at-a-time rebuild — the
        cached prefix is one 2D copy; only the (small) fresh suffix is
        touched per series."""
        t0 = _time.perf_counter()
        kind = "rebuild"
        try:
            # partial results must NEVER be committed: the in-place path
            # mutates the live entry before the caller's put() guard runs,
            # so the guard is applied here — a partial suffix takes the
            # pure rebuild path (served, never cached; same contract as
            # the skipped put)
            partial = ec._partial[0] or \
                getattr(ec.storage, "last_partial", False)
            if ring_enabled() and not partial:
                rows = self._merge_inplace(hit, fresh, ec, new_start,
                                           trust_raw, now_ms)
                if rows is not None:
                    _INPLACE.inc()
                    kind = "inplace"
                    return rows
            _REBUILD.inc()
            return self._merge_rebuild(hit, fresh, ec, new_start,
                                       trust_raw)
        finally:
            now = _time.perf_counter()
            _MERGE_SECONDS.inc(now - t0)
            # the inplace-vs-rebuild DECISION on the flight timeline: a
            # rebuild where inplace was expected is itself a latency clue
            _flightrec.rec("rcache:" + kind, t0, now - t0)
            _costacc.lap("cache:merge", now - t0)

    def _merge_inplace(self, hit: CacheHit, fresh: list[Timeseries],
                       ec: EvalConfig, new_start: int, trust_raw: bool,
                       now_ms: int | None):
        """Extend hit's entry in place for a rolling refresh; None when
        the shape doesn't fit (caller rebuilds).  Preconditions checked
        under the lock: the hit must still describe the live entry (same
        object, same generation — no concurrent merge/put/reset raced us),
        the hit must have covered the full cached tail, and every fresh
        row must be suffix-exact."""
        step = ec.step
        T = ec.n_points
        n_prefix = (new_start - ec.start) // step
        n_suffix = T - n_prefix
        if n_suffix <= 0 or n_prefix < 0:
            return None
        for ts in fresh:
            if ts.values.size != n_suffix:
                return None
        fresh_raws = [_raw_of(ts, trust_raw) for ts in fresh]
        if len(set(fresh_raws)) != len(fresh_raws):
            return None  # duplicate identities: rebuild's last-wins rules
        if now_ms is None:
            from ..utils import fasttime
            now_ms = fasttime.unix_ms()
        cov_end = ec.start + (
            (min(ec.end, now_ms - OFFSET_MS) - ec.start) // step) * step
        # the buffer writes run under the cache-wide lock: the scatter is
        # O(S * new columns) (the steady-state merge is exactly the new
        # work) and the compaction copy is amortized to one column per
        # refresh, but a concurrent get()/put() of ANOTHER key does wait
        # out the write.  A per-entry lock would shrink that window;
        # deliberately not done until it shows up in merge_seconds.
        with self._lock:
            e = self._cache.get(hit.key)
            if e is not hit.entry or e.gen != hit.gen:
                return None
            if new_start != e.c_end + step or ec.start < e.c_start or \
                    (ec.start - e.c_start) % step != 0:
                return None
            # advance: drop columns before the new window start
            col_off = e.col_off + (ec.start - e.c_start) // step
            new_raws = []
            new_names = []
            seen = e.idx
            for ts, raw in zip(fresh, fresh_raws):
                if raw not in seen:
                    new_raws.append(raw)
                    new_names.append(_copy_name(ts.metric_name))
            n_rows = e.n_rows + len(new_raws)
            buf = e.buf
            # rows handed out by the previous merge of this key still
            # alive (a concurrent refresh racing an in-flight response
            # serialization): writing the suffix through the shared
            # buffer would tear those rows mid-read, so compact into a
            # fresh buffer instead — the old one stays intact for them
            views_alive = any(r() is not None for r in e.out_refs)
            if views_alive or col_off + T > buf.shape[1] or \
                    n_rows > buf.shape[0]:
                # compact into a FRESH buffer (never memmove: earlier
                # hits' views into the old buffer must stay intact).
                # Dead rows — series whose entire remaining prefix is NaN
                # and that get no fresh data this merge — are dropped
                # here, so series churn cannot grow a hot entry without
                # bound (the rebuild path's all-NaN pruning, amortized to
                # once per COL_HEADROOM refreshes)
                pref = buf[:e.n_rows, col_off:col_off + n_prefix]
                keep = ~np.isnan(pref).all(axis=1)
                for raw in fresh_raws:
                    r = e.idx.get(raw)
                    if r is not None:
                        keep[r] = True
                if bool(keep.all()):
                    kept_src = None
                else:
                    kept_src = np.flatnonzero(keep)
                    # copy-on-write rebind: hit snapshots keep their lists
                    e.raws = [e.raws[i] for i in kept_src]
                    e.names = [e.names[i] for i in kept_src]
                    e.idx = {r: s for s, r in enumerate(e.raws)}
                    e.n_rows = int(kept_src.size)
                n_rows = e.n_rows + len(new_raws)
                nb = np.empty((n_rows + max(ROW_HEADROOM, n_rows // 64),
                               T + COL_HEADROOM))
                nb[:e.n_rows, :n_prefix] = \
                    pref if kept_src is None else pref[kept_src]
                self._bytes += nb.nbytes - buf.nbytes
                e.buf = buf = nb
                col_off = 0
            e.col_off = col_off
            e.c_start = ec.start
            if new_raws:
                # copy-on-append: rebind so hit snapshots keep their lists
                r0 = e.n_rows
                e.raws = e.raws + new_raws
                e.names = e.names + new_names
                for j, raw in enumerate(new_raws):
                    e.idx[raw] = r0 + j
                buf[r0:n_rows, col_off:col_off + n_prefix] = np.nan
                e.n_rows = n_rows
            span = slice(col_off + n_prefix, col_off + T)
            buf[:n_rows, span] = np.nan
            if fresh:
                rows_idx = np.fromiter((e.idx[r] for r in fresh_raws),
                                       np.int64, len(fresh))
                buf[rows_idx, span] = [ts.values for ts in fresh]
            e.gen += 1
            if cov_end < ec.start:
                # nothing final in the window (deep volatile tail): the
                # merged result is served but the entry can't cover it
                self._bytes -= e.size_bytes()
                del self._cache[hit.key]
            else:
                e.c_end = cov_end
                e.served = (ec.start, ec.end, e.gen)
                self._cache.move_to_end(hit.key)
                self._evict_locked()
            win = buf[:n_rows, col_off:col_off + T].view()
            win.setflags(write=False)
            # remember the handed-out row views: the next merge of this
            # key must not write through the buffer while any are alive
            row_views = [win[s] for s in range(n_rows)]
            e.out_refs = [weakref.ref(v) for v in row_views]
            raws = e.raws
            names = e.names
        return [Timeseries(_copy_name(names[s]), row_views[s], raw=raws[s])
                for s in range(len(raws))]

    def _merge_rebuild(self, hit: CacheHit, fresh: list[Timeseries],
                       ec: EvalConfig, new_start: int,
                       trust_raw: bool) -> list[Timeseries]:
        T = ec.n_points
        n_prefix = min((new_start - ec.start) // ec.step, hit.n)
        S_c = len(hit.raws)
        idx = {raw: s for s, raw in enumerate(hit.raws)}
        fresh_raws = [_raw_of(ts, trust_raw) for ts in fresh]
        raws = list(hit.raws)
        names = [_copy_name(nm) for nm in hit.names]
        for ts, raw in zip(fresh, fresh_raws):
            if raw not in idx:  # dedupe: two fresh rows may share a raw
                idx[raw] = len(raws)
                raws.append(raw)
                names.append(_copy_name(ts.metric_name))
        S = len(raws)
        vals = np.full((S, T), np.nan)
        vals[:S_c, :n_prefix] = hit.view[:, :n_prefix]
        for ts, raw in zip(fresh, fresh_raws):
            s = idx[raw]
            v = ts.values
            m = v.size
            vals[s, T - m:] = v if m <= T else v[-T:]
        return [Timeseries(names[s], vals[s], raw=raws[s])
                for s in range(S)]

    def entry_count(self) -> int:
        # locked: a /metrics scrape must not iterate under concurrent
        # put()/evict mutation
        with self._lock:
            return len(self._cache)

    def size_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def reset(self):
        with self._lock:
            self._cache.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._cache), "hits": self.hits,
                    "misses": self.misses, "bytes": self._bytes,
                    "max_bytes": self.max_bytes}


GLOBAL = RollupResultCache()
