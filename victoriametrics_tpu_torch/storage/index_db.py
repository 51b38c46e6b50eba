"""Inverted index over the mergeset (reference lib/storage/index_db.go).

Nine key namespaces (index_db.go:35-71 analog), all items in one mergeset
table, 1-byte namespace prefix. T = tenant prefix accountID(4B BE)
projectID(4B BE) (marshalCommonPrefix analog) — metricID-keyed namespaces
are global because metricIDs are unique across tenants:

  0  T metricName(marshaled)        -> TSID          per-tenant registry
  1  T tag(k 0x01 v) 0x00 metricID  -> (exists)      posting lists
  2  metricID(8B BE)                -> TSID
  3  metricID(8B BE)                -> metricName
  4  metricID(8B BE)                -> (deleted)     tombstones
  5  T date(4B BE) metricID         -> (exists)      per-day series
  6  T date(4B BE) tag 0x00 metricID-> (exists)      per-day postings
  7  T date(4B BE) metricName       -> TSID          per-day registry
  8  T                              -> (exists)      tenant listing

The metric group is indexed as tag key b"" (like the reference). Values use
the escaped metric-name encoding so 0x00/0x01 separators are unambiguous and
prefix scans work.

Set algebra over posting lists uses sorted uint64 numpy arrays — the
uint64set analog; intersections/unions/subtractions are vectorized.

The port's copy of ``victoriametrics_tpu/storage/index_db.py``, whole.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..devtools import faultinject
from ..devtools.locktrace import make_lock
from ..devtools.racetrace import traced_fields
from ..utils import metrics as metricslib
from ..utils.workingset import WorkingSetCache
from .mergeset import Table
from .metric_name import MetricName, escape, unescape
from .tag_filters import TagFilter
from .tsid import TSID

# posting-cache traffic, reference vm_cache_{requests,misses}_total shape
# (global across IndexDB instances; per-instance counts come from the
# read-only filter_cache_* property shims)
_FILTER_CACHE_REQUESTS = metricslib.REGISTRY.counter(
    'vm_cache_requests_total{type="indexdb/tagFilters"}')
_FILTER_CACHE_MISSES = metricslib.REGISTRY.counter(
    'vm_cache_misses_total{type="indexdb/tagFilters"}')

NS_NAME_TO_TSID = b"\x00"
NS_TAG_TO_MID = b"\x01"
NS_MID_TO_TSID = b"\x02"
NS_MID_TO_NAME = b"\x03"
NS_DELETED = b"\x04"
NS_DATE_TO_MID = b"\x05"
NS_DATE_TAG_TO_MID = b"\x06"
NS_DATE_NAME_TO_TSID = b"\x07"
NS_TENANTS = b"\x08"

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_TEN = struct.Struct(">II")  # accountID, projectID


def tenant_prefix(tenant) -> bytes:
    return _TEN.pack(tenant[0], tenant[1])

MS_PER_DAY = 86_400_000


def date_of_ms(ts_ms: int) -> int:
    return ts_ms // MS_PER_DAY


def _tag_key_bytes(key: bytes, value: bytes) -> bytes:
    return escape(key) + b"\x01" + escape(value) + b"\x00"


@traced_fields("_deleted", "_gen", "_filter_cache", "_filter_cache_prev",
               "_tsids_result_cache")
class IndexDB:
    """One index table + in-memory caches.

    Caches (reference lib/storage/index_db.go:306-361 analogs):
    - metricID->MetricName / metricID->TSID maps: entries are immutable
      once created (append-only LSM), so they never go stale; bounded by
      two-generation rotation at MAX_ID_CACHE (workingsetcache analog —
      no multi-million-entry wipe on the hot path, the working set
      survives each rotation).
    - tagFilters->metricIDs posting cache: keyed by (filters, date range),
      invalidated via a generation counter bumped on every index write —
      steady-state ingest (no new series) leaves the generation stable.
      Also generation-rotated on overflow instead of cleared.
    """

    MAX_ID_CACHE = 1 << 20
    MAX_FILTER_CACHE = 1024

    def __init__(self, path: str):
        self.path = path
        # global table in its own subdir: the month tables live under
        # months/ and must not be scanned as parts of the global table
        self.table = Table(os.path.join(path, "global"))
        # per-month tables hold the per-day namespaces (5/6/7) so retention
        # can drop a month's index with its data partition (the reference's
        # per-partition indexDB, storage.go:1094); the global table keeps
        # the registry namespaces (0/2/3/4/8) and undated postings (1).
        self._month_tables: dict[str, Table] = {}
        months_dir = os.path.join(path, "months")
        if os.path.isdir(months_dir):
            for name in sorted(os.listdir(months_dir)):
                if len(name) == 7 and name[4] == "_":
                    self._month_tables[name] = Table(
                        os.path.join(months_dir, name))
        self._lock = make_lock("storage.IndexDB._lock")
        self._deleted = self._load_deleted()
        self._gen = 0
        self._name_cache = WorkingSetCache(self.MAX_ID_CACHE,
                                           "indexdb.name_cache")
        self._tsid_cache = WorkingSetCache(self.MAX_ID_CACHE,
                                           "indexdb.tsid_cache")
        self._filter_cache: "dict[tuple, tuple[int, np.ndarray]]" = {}
        self._filter_cache_prev: "dict[tuple, tuple[int, np.ndarray]]" = {}
        self._tsids_result_cache: "dict[tuple, tuple[int, list]]" = {}
        # registry-backed traffic counters with per-instance shims (the
        # legacy filter_cache_requests/filter_cache_hits attributes are
        # read-only properties over these)
        self._filter_cache_requests = metricslib.Counter("requests")
        self._filter_cache_hits = metricslib.Counter("hits")

    @property
    def filter_cache_requests(self) -> int:
        return self._filter_cache_requests.get()

    @property
    def filter_cache_hits(self) -> int:
        return self._filter_cache_hits.get()

    def close(self):
        self.table.close()
        for t in self._month_tables.values():
            t.close()

    def flush(self):
        self.table.flush_to_disk()
        for t in self._month_tables.values():
            t.flush_to_disk()

    @staticmethod
    def _month_of_date(date: int) -> str:
        import datetime as _dt
        d = _dt.datetime.fromtimestamp(date * 86_400,
                                       tz=_dt.timezone.utc)
        return f"{d.year:04d}_{d.month:02d}"

    def _day_table(self, date: int) -> Table:
        """Month table for writes (created on demand)."""
        name = self._month_of_date(date)
        # racy-by-design fast path of a double-checked create: a stale
        # miss re-checks under _lock; a published Table is immutable here
        t = self._month_tables.get(name)  # vmt: disable=VMT015
        if t is None:
            with self._lock:
                t = self._month_tables.get(name)
                if t is None:
                    t = Table(os.path.join(self.path, "months", name))
                    self._month_tables[name] = t
        return t

    def _day_table_ro(self, date: int) -> Table | None:
        """Month table for reads: None when the month has no index (never
        written or dropped by retention) — reads must not create dirs."""
        return self._month_tables.get(self._month_of_date(date))

    def snapshot_month_tables(self) -> list:
        with self._lock:
            return list(self._month_tables.items())

    def quarantined(self) -> list[dict]:
        """Open-time integrity quarantines across the global table and
        every month table (recovery parity: the indexdb stores get the
        same loud torn-part handling as data parts)."""
        with self._lock:
            tables = [self.table] + list(self._month_tables.values())
        return [q for t in tables for q in t.quarantined]

    def drop_months_before(self, min_valid_ts: int) -> int:
        """Drop whole month index tables older than retention (the
        per-partition indexDB rotation; returns count)."""
        import shutil
        min_month = self._month_of_date(min_valid_ts // MS_PER_DAY)
        dropped = 0
        with self._lock:
            for name in list(self._month_tables):
                if name < min_month:
                    t = self._month_tables.pop(name)
                    t.close()
                    # crashpoint: dying between unlist and rmtree leaves
                    # the month dir on disk — it is rediscovered (and
                    # re-dropped) at the next open, never half-deleted
                    # under a live table object
                    faultinject.fire("indexdb:rotate")
                    shutil.rmtree(t.path, ignore_errors=True)
                    dropped += 1
                    self._gen += 1
        return dropped

    def _bump_gen(self):
        with self._lock:
            self._gen += 1

    def _cache_ids(self, cache: WorkingSetCache, key: int, value) -> None:
        # two-generation rotation on overflow (no wipe): see WorkingSetCache
        cache.put(key, value)

    # -- writes ------------------------------------------------------------

    def create_indexes_for_metric(self, mn: MetricName, tsid: TSID) -> None:
        """Global (date-independent) indexes for a new series
        (createGlobalIndexes, index_db.go:428 analog). The tenant rides in
        the TSID (account_id/project_id)."""
        ten = _TEN.pack(tsid.account_id, tsid.project_id)
        name_raw = mn.marshal()
        tsid_b = tsid.marshal()
        mid = _U64.pack(tsid.metric_id)
        items = [
            NS_NAME_TO_TSID + ten + name_raw + b"\x00" + tsid_b,
            NS_MID_TO_TSID + mid + tsid_b,
            NS_MID_TO_NAME + mid + name_raw,
            NS_TAG_TO_MID + ten + _tag_key_bytes(b"", mn.metric_group) + mid,
            NS_TENANTS + ten,
        ]
        for k, v in mn.labels:
            items.append(NS_TAG_TO_MID + ten + _tag_key_bytes(k, v) + mid)
        self.table.add_items(items)
        self._bump_gen()

    def create_per_day_indexes(self, mn: MetricName, tsid: TSID, date: int) -> None:
        """(date, X) indexes binding the series to one day
        (updatePerDateData analog, storage.go:2261)."""
        ten = _TEN.pack(tsid.account_id, tsid.project_id)
        d = ten + _U32.pack(date)
        mid = _U64.pack(tsid.metric_id)
        items = [
            NS_DATE_TO_MID + d + mid,
            NS_DATE_NAME_TO_TSID + d + mn.marshal() + b"\x00" + tsid.marshal(),
            NS_DATE_TAG_TO_MID + d + _tag_key_bytes(b"", mn.metric_group) + mid,
        ]
        for k, v in mn.labels:
            items.append(NS_DATE_TAG_TO_MID + d + _tag_key_bytes(k, v) + mid)
        self._day_table(date).add_items(items)
        self._bump_gen()

    def delete_series_by_ids(self, metric_ids: np.ndarray) -> int:
        items = [NS_DELETED + _U64.pack(int(m)) for m in metric_ids]
        self.table.add_items(items)
        with self._lock:
            self._deleted = np.union1d(self._deleted, metric_ids)
        self._bump_gen()
        return len(items)

    # -- point lookups -----------------------------------------------------

    def get_tsid_by_name(self, mn_marshaled: bytes,
                         tenant=(0, 0)) -> TSID | None:
        prefix = NS_NAME_TO_TSID + tenant_prefix(tenant) + \
            mn_marshaled + b"\x00"
        item = self.table.first_with_prefix(prefix)
        if item is None:
            return None
        return TSID.unmarshal(item[len(prefix):])

    def get_metric_name_by_id(self, metric_id: int) -> MetricName | None:
        got = self.get_metric_name_raw_by_id(metric_id)
        return got[0] if got is not None else None

    def get_metric_name_raw_by_id(self, metric_id: int
                                  ) -> tuple[MetricName, bytes] | None:
        """(MetricName, marshaled bytes) — the raw form doubles as a cheap
        sort/group key so hot paths skip re-marshaling."""
        got = self._name_cache.get(metric_id)
        if got is not None:
            return got
        prefix = NS_MID_TO_NAME + _U64.pack(metric_id)
        item = self.table.first_with_prefix(prefix)
        if item is None:
            return None
        raw = item[len(prefix):]
        got = (MetricName.unmarshal(raw), raw)
        self._cache_ids(self._name_cache, metric_id, got)
        return got

    def get_tsid_by_id(self, metric_id: int) -> TSID | None:
        t = self._tsid_cache.get(metric_id)
        if t is not None:
            return t
        prefix = NS_MID_TO_TSID + _U64.pack(metric_id)
        item = self.table.first_with_prefix(prefix)
        if item is None:
            return None
        t = TSID.unmarshal(item[len(prefix):])
        self._cache_ids(self._tsid_cache, metric_id, t)
        return t

    def get_metric_names_by_ids(self, metric_ids
                                ) -> dict[int, tuple[MetricName, bytes]]:
        """Batched metricID->(MetricName, raw) resolution: one cached-block
        bisect per missing id instead of a merge-iteration per id."""
        out: dict[int, tuple[MetricName, bytes]] = {}
        for mid in metric_ids:
            mid = int(mid)
            got = self.get_metric_name_raw_by_id(mid)
            if got is not None:
                out[mid] = got
        return out

    # -- deleted set -------------------------------------------------------

    def _load_deleted(self) -> np.ndarray:
        ids = [_U64.unpack(item[1:9])[0]
               for item in self.table.search_prefix(NS_DELETED)]
        return np.array(sorted(ids), dtype=np.uint64)

    @property
    def deleted_metric_ids(self) -> np.ndarray:
        with self._lock:
            return self._deleted

    # -- posting scans -----------------------------------------------------

    def _postings_for_tag(self, key: bytes, value: bytes,
                          date: int | None = None,
                          tenant=(0, 0)) -> np.ndarray:
        ten = tenant_prefix(tenant)
        if date is None:
            table = self.table
            prefix = NS_TAG_TO_MID + ten + _tag_key_bytes(key, value)
        else:
            table = self._day_table_ro(date)
            if table is None:
                return np.array([], dtype=np.uint64)
            prefix = NS_DATE_TAG_TO_MID + ten + _U32.pack(date) + \
                _tag_key_bytes(key, value)
        ids = [_U64.unpack(item[-8:])[0]
               for item in table.search_prefix(prefix)]
        return np.array(sorted(ids), dtype=np.uint64)

    def _iter_tag_values(self, key: bytes, date: int | None = None,
                         tenant=(0, 0)):
        """Yield (value, metric_id) pairs for one tag key."""
        ten = tenant_prefix(tenant)
        if date is None:
            table = self.table
            prefix = NS_TAG_TO_MID + ten + escape(key) + b"\x01"
        else:
            table = self._day_table_ro(date)
            if table is None:
                return
            prefix = NS_DATE_TAG_TO_MID + ten + _U32.pack(date) + \
                escape(key) + b"\x01"
        plen = len(prefix)
        for item in table.search_prefix(prefix):
            body = item[plen:]
            # fixed-width tail: 0x00 separator + 8-byte BE metric_id (which
            # itself may contain 0x00 bytes, so never search for the NUL)
            sep = len(body) - 9
            if sep < 0 or body[sep] != 0:
                raise ValueError("corrupted tag->metricID index item")
            yield unescape(body[:sep]), _U64.unpack(body[sep + 1:])[0]

    def _metric_ids_for_date(self, date: int, tenant=(0, 0)) -> np.ndarray:
        table = self._day_table_ro(date)
        if table is None:
            return np.array([], dtype=np.uint64)
        prefix = NS_DATE_TO_MID + tenant_prefix(tenant) + _U32.pack(date)
        ids = [_U64.unpack(item[-8:])[0]
               for item in table.search_prefix(prefix)]
        return np.array(sorted(ids), dtype=np.uint64)

    def _all_metric_ids(self, tenant=(0, 0)) -> np.ndarray:
        # every series has exactly one metric-group posting (tag key b"");
        # scanning it under the tenant prefix enumerates the tenant
        ids = [_U64.unpack(item[-8:])[0] for item in self.table.search_prefix(
            NS_TAG_TO_MID + tenant_prefix(tenant) + b"\x01")]
        return np.array(sorted(ids), dtype=np.uint64)

    def all_series_count(self) -> int:
        """Global series count across every tenant (vm_timeseries_total)."""
        return sum(1 for _ in self.table.search_prefix(NS_MID_TO_TSID))

    def tenants(self) -> list[tuple[int, int]]:
        """Distinct (accountID, projectID) pairs (tenants_v1 analog)."""
        out = []
        for item in self.table.search_prefix(NS_TENANTS):
            a, p = _TEN.unpack(item[1:9])
            out.append((a, p))
        return sorted(set(out))

    def _metric_ids_for_filter(self, tf: TagFilter, date: int | None,
                               tenant=(0, 0)) -> np.ndarray:
        """Posting set for the *positive form* of the filter, i.e. ids whose
        label value matches value/regex ignoring negation (negation is set
        subtraction in the caller)."""
        if tf.or_values is not None:
            sets = [self._postings_for_tag(tf.key, v, date, tenant)
                    for v in tf.or_values if v != b""]
            sets = [s for s in sets if s.size]
            return (np.unique(np.concatenate(sets))
                    if sets else np.array([], dtype=np.uint64))
        ids = [mid for v, mid in self._iter_tag_values(tf.key, date, tenant)
               if bool(tf._re.match(v.decode("utf-8", "replace")))]
        return np.unique(np.array(ids, dtype=np.uint64)) if ids else \
            np.array([], dtype=np.uint64)

    # -- search ------------------------------------------------------------

    MAX_DAYS_PER_DAY_INDEX = 40

    def search_metric_ids(self, filters: list[TagFilter],
                          min_ts: int | None = None,
                          max_ts: int | None = None,
                          tenant=(0, 0), check=None) -> np.ndarray:
        """Resolve tag filters to a sorted metricID array
        (searchMetricIDs, index_db.go:1685 analog), memoized in the
        tagFilters->metricIDs cache (index_db.go:336-361 analog).

        ``check`` (optional zero-arg callable) is the storage-side
        deadline budget's UNCONDITIONAL clock check: invoked between
        posting scans — each one a whole mergeset prefix iteration, so
        the per-call clock read is noise — so an expired query aborts
        mid-index-scan instead of completing the whole resolution for a
        dead caller.  (The cheap amortized tick belongs to per-item
        loops like search_tsids' resolution, not here: a filter x day
        matrix rarely reaches the tick's every-Nth threshold.)"""
        ckey = (tenant,
                tuple((tf.key, tf.value, tf.negate, tf.regex)
                      for tf in filters),
                None if min_ts is None else date_of_ms(min_ts),
                None if max_ts is None else date_of_ms(max_ts))
        self._filter_cache_requests.inc()
        _FILTER_CACHE_REQUESTS.inc()
        with self._lock:
            got = self._filter_cache.get(ckey)
            if got is None:
                # previous generation: promote hits instead of losing the
                # whole working set to an overflow wipe
                got = self._filter_cache_prev.get(ckey)
                if got is not None and got[0] == self._gen:
                    if len(self._filter_cache) >= self.MAX_FILTER_CACHE:
                        self._filter_cache_prev = self._filter_cache
                        self._filter_cache = {}
                    self._filter_cache[ckey] = got
            if got is not None and got[0] == self._gen:
                self._filter_cache_hits.inc()
                return got[1]
            gen = self._gen  # capture BEFORE the search: a concurrent index
            # write during the scan must invalidate what we store
        _FILTER_CACHE_MISSES.inc()
        result = self._search_metric_ids_uncached(filters, min_ts, max_ts,
                                                  tenant, check)
        with self._lock:
            # rotate only when inserting a NEW key into a full current
            # generation (refreshing a resident stale entry must not
            # discard the whole previous generation)
            if ckey not in self._filter_cache and \
                    len(self._filter_cache) >= self.MAX_FILTER_CACHE:
                self._filter_cache_prev = self._filter_cache
                self._filter_cache = {}
            self._filter_cache[ckey] = (gen, result)
        return result

    def _search_metric_ids_uncached(self, filters: list[TagFilter],
                                    min_ts: int | None = None,
                                    max_ts: int | None = None,
                                    tenant=(0, 0),
                                    check=None) -> np.ndarray:
        if check is None:
            def check():
                pass
        use_dates: list[int] | None = None
        if min_ts is not None and max_ts is not None:
            d0, d1 = date_of_ms(min_ts), date_of_ms(max_ts)
            if d1 - d0 + 1 <= self.MAX_DAYS_PER_DAY_INDEX:
                use_dates = list(range(d0, d1 + 1))

        def filter_set(tf: TagFilter) -> np.ndarray:
            if use_dates is not None:
                sets = []
                for d in use_dates:
                    check()  # budget: one check per per-day posting scan
                    sets.append(self._metric_ids_for_filter(tf, d, tenant))
                sets = [s for s in sets if s.size]
                return (np.unique(np.concatenate(sets)) if sets
                        else np.array([], dtype=np.uint64))
            check()
            return self._metric_ids_for_filter(tf, None, tenant)

        # Strong positives (don't match a missing label) seed the result via
        # posting intersections; everything else refines it. A missing label
        # reads as empty value "" (Prometheus matcher semantics).
        strong = [tf for tf in filters
                  if not tf.negate and not tf.is_empty_match]
        rest = [tf for tf in filters if tf not in strong]

        if strong:
            result: np.ndarray | None = None
            for tf in strong:
                s = filter_set(tf)
                result = s if result is None else \
                    np.intersect1d(result, s, assume_unique=True)
                if result.size == 0:
                    return result
        else:
            # no strong positive: start from the day universe (or everything)
            if use_dates is not None:
                sets = [self._metric_ids_for_date(d, tenant)
                        for d in use_dates]
                sets = [s for s in sets if s.size]
                result = (np.unique(np.concatenate(sets)) if sets
                          else np.array([], dtype=np.uint64))
            else:
                result = self._all_metric_ids(tenant)

        for tf in rest:
            if result.size == 0:
                break
            pos = TagFilter(tf.key, tf.value, negate=False, regex=tf.regex)
            matched = filter_set(pos)
            if tf.negate:
                survivors = np.setdiff1d(result, matched, assume_unique=True)
                if not tf.is_empty_match:
                    # e.g. x!="" / x!~"a?": a missing label would match the
                    # positive form, so only ids that HAVE the key survive
                    have_key = self._ids_with_key(tf.key, use_dates, tenant)
                    survivors = np.intersect1d(survivors, have_key,
                                               assume_unique=True)
                result = survivors
            else:
                # positive filter matching empty (x="" or x=~"a?"): keep ids
                # that either match the positive form or lack the label
                have_key = self._ids_with_key(tf.key, use_dates, tenant)
                lacking = np.setdiff1d(result, have_key, assume_unique=True)
                matching = np.intersect1d(result, matched, assume_unique=True)
                result = np.union1d(lacking, matching)

        # drop tombstoned series (snapshot under the lock: the deleted
        # array is replaced wholesale by delete_series_by_ids, so a
        # locked reference read is race-free and cheap)
        with self._lock:
            deleted = self._deleted
        if deleted.size:
            result = np.setdiff1d(result, deleted, assume_unique=True)
        return result

    def _ids_with_key(self, key: bytes, use_dates, tenant=(0, 0)) -> np.ndarray:
        ids = set()
        dates = use_dates if use_dates is not None else [None]
        for d in dates:
            for _, mid in self._iter_tag_values(key, d, tenant):
                ids.add(mid)
        return np.array(sorted(ids), dtype=np.uint64)

    MAX_TSIDS_CACHE = 256

    def search_tsids(self, filters: list[TagFilter],
                     min_ts: int | None = None,
                     max_ts: int | None = None, tenant=(0, 0),
                     check=None, scan_check=None) -> list[TSID]:
        # gen-validated result memo: a rolling dashboard repeats the same
        # selector every refresh; the id->TSID resolution + sort (~ms per
        # 10k series) would otherwise run every time
        ckey = (tenant,
                tuple((tf.key, tf.value, tf.negate, tf.regex)
                      for tf in filters),
                None if min_ts is None else date_of_ms(min_ts),
                None if max_ts is None else date_of_ms(max_ts))
        with self._lock:
            got = self._tsids_result_cache.get(ckey)
            if got is not None and got[0] == self._gen:
                return got[1]
            gen = self._gen
        # the posting scans get the UNCONDITIONAL clock check (coarse,
        # expensive units); the per-series loop below gets the amortized
        # tick (cheap, every Nth call reads the clock)
        mids = self.search_metric_ids(filters, min_ts, max_ts, tenant,
                                      scan_check if scan_check is not None
                                      else check)
        out = []
        for mid in mids:
            if check is not None:
                check()
            t = self.get_tsid_by_id(int(mid))
            if t is not None:
                out.append(t)
        out.sort(key=TSID.sort_key)
        with self._lock:
            if len(self._tsids_result_cache) >= self.MAX_TSIDS_CACHE:
                self._tsids_result_cache.clear()
            self._tsids_result_cache[ckey] = (gen, out)
        return out

    # -- label APIs --------------------------------------------------------

    def _date_range(self, min_ts, max_ts) -> list[int] | None:
        """Day list when the range is narrow enough for the per-day index."""
        if min_ts is None or max_ts is None:
            return None
        d0, d1 = date_of_ms(min_ts), date_of_ms(max_ts)
        if d1 - d0 + 1 > self.MAX_DAYS_PER_DAY_INDEX:
            return None
        return list(range(d0, d1 + 1))

    def label_names(self, min_ts=None, max_ts=None,
                    tenant=(0, 0)) -> list[str]:
        """Distinct label keys, time-scoped via the per-day index when the
        range is narrow (SearchLabelNames analog, index_db.go:507)."""
        ten = tenant_prefix(tenant)
        dates = self._date_range(min_ts, max_ts)
        seen_keys = set()
        if dates is None:
            prefix = NS_TAG_TO_MID + ten
            for item in self.table.search_prefix(prefix):
                body = item[len(prefix):]
                seen_keys.add(body[:body.index(b"\x01")])
        else:
            for d in dates:
                table = self._day_table_ro(d)
                if table is None:
                    continue
                prefix = NS_DATE_TAG_TO_MID + ten + _U32.pack(d)
                for item in table.search_prefix(prefix):
                    body = item[len(prefix):]
                    seen_keys.add(body[:body.index(b"\x01")])
        names = {unescape(k).decode("utf-8", "replace")
                 for k in seen_keys if k != b""}
        names.add("__name__")
        return sorted(names)

    def label_values(self, key: str, min_ts=None, max_ts=None,
                     tenant=(0, 0)) -> list[str]:
        kb = b"" if key == "__name__" else key.encode()
        dates = self._date_range(min_ts, max_ts)
        vals = set()
        for d in (dates if dates is not None else [None]):
            vals |= {v for v, _ in self._iter_tag_values(kb, d, tenant)}
        return sorted(v.decode("utf-8", "replace") for v in vals)
