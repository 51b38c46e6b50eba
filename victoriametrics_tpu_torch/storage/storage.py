"""Top-level Storage (reference lib/storage/storage.go:43,180).

Owns: monthly-partitioned data table, inverted index, TSID cache, per-day
index cache, deletion tombstones, snapshots, background flushers, retention.

The public API mirrors the reference's Storage surface: AddRows, Search
(here: search_series / iter_series_blocks), SearchLabelNames/Values,
DeleteSeries, CreateSnapshot, RegisterMetricNames, GetTSDBStatus, ForceFlush/
ForceMerge — re-shaped for a Python host plane feeding a device query engine.

The port's copy of ``victoriametrics_tpu/storage/storage.py``, on the same
on-disk format (each reads a directory the other wrote).  Two write paths:
``add_rows`` (label sets, or raw ``name{labels}`` byte keys from the
native text parser) and ``add_rows_columnar`` (``native.ColumnarRows``
batches, each resolved to dense ids by a per-tenant ``_ColumnarSpace``
over the native key map).  ``SeriesData.raw_name`` keys the device
engine's tiles.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import threading
import time
from contextlib import contextmanager

import numpy as np

from ..devtools import faultinject
from ..devtools.locktrace import make_lock, make_rlock
from ..utils import costacc, fasttime, flightrec, logger
from ..utils import metrics as metricslib
from ..utils import workpool
from ..utils.deadline import Budget, DeadlineExceededError  # noqa: F401 —
# DeadlineExceededError re-exported: RPC handlers and tests catch the
# storage-side abort through the storage module's public surface
from ..utils.workingset import WorkingSetCache
from .dedup import deduplicate
from .index_db import IndexDB, date_of_ms
from .metric_name import MetricName
from .table import Table
from .tag_filters import TagFilter
from .tsid import MetricIDGenerator, TSID, generate_tsid

DEFAULT_RETENTION_MS = 31 * 13 * 86_400_000  # ~13 months, like the reference

# per-phase fetch attribution (bench.py and /metrics read these): seconds
# spent in each stage of the columnar read path, labeled like the
# reference's per-stage vmselect metrics.  The fused VM_NATIVE_ASSEMBLE
# kernel merges collect+decode+clip into one native call per part — its
# time reports under phase="assemble_native" so the split-path labels
# (collect / decode) stay accurate for the fallback/oracle path instead
# of silently absorbing fused time.
_PHASE = {
    ph: metricslib.REGISTRY.float_counter(
        f'vm_fetch_phase_seconds_total{{phase="{ph}"}}')
    for ph in ("index_search", "collect", "decode", "assemble",
               "assemble_native", "queue_wait")
}
# phase="queue_wait" (time queued at the SearchGate before the fetch
# starts) is INCREMENTED in utils/workpool.SearchGate — listed here so
# the family is complete at import and the split sums to wall time

# write-path twin of _PHASE: where ingest time goes (the flush/merge
# phases are fed by partition.py / mergeset.py)
_ING_PHASE = {ph: metricslib.ingest_phase(ph)
              for ph in ("resolve", "register", "append")}
_INGEST_ROWS = metricslib.REGISTRY.counter("vm_ingest_rows_total")
_SHARD_WAIT = metricslib.REGISTRY.float_counter(
    "vm_ingest_shard_lock_wait_seconds_total")

#: fan per-day registrations across the pool only past this size (small
#: batches lose more to task handoff than they gain)
_FANOUT_MIN_REGS = 64

# storage-side deadline aborts (ROADMAP item 3): a search whose shipped
# budget expires mid-index-scan/mid-fetch stops HERE instead of burning
# the dead query's full server-side cost
_DEADLINE_ABORTS = metricslib.REGISTRY.counter(
    "vm_storage_deadline_aborts_total")


class _ScanBudget(Budget):
    """Budget whose clock checks double as the ``storage:scan`` chaos
    seam: an injected delay there dilates the scan so the chaos suite
    can prove a query aborts within ~one check interval of expiry."""

    __slots__ = ()

    def check(self) -> None:
        if faultinject.active():
            faultinject.fire("storage:scan")
        super().check()


class _IngestShard:
    """One registration stripe of the sharded write path (the
    rawRowsShards analog, partition.go): the per-day cache slice for
    metric ids with ``hash(metric_id) % N == index``, guarded by its own
    lock so concurrent writers (and the striped fan-out of one large
    batch) only contend when they touch the same stripe."""

    __slots__ = ("lock", "day_cache")

    def __init__(self):
        # one role name for every stripe: same-role edges are exempt
        # from lock-order cycle checks (stripes are never nested)
        self.lock = make_lock("storage.Storage._ingest_shard")
        self.day_cache: set[tuple[int, int]] = set()  # (metric_id, date)


class _ColumnarSpace:
    """Per-tenant dense-id state for the columnar ingest path: a native
    byte-key -> id map plus per-id numpy columns (TSID sort-key fields,
    per-day index state, drop verdicts). Resolving a batch is ONE native
    call; everything downstream indexes these arrays.

    Drop verdicts are sticky per id (0 ok, 1 malformed key, 2 dropped by
    transform/relabel, 3 over cardinality budget at creation) — repeat rows
    of a dropped series are filtered with one mask, never re-judged."""

    __slots__ = ("keymap", "tsids", "acc", "proj", "grp", "job", "inst",
                 "mid", "drop", "last_date", "_cap", "lock", "retired")

    #: distinct raw keys per tenant space before the whole space is rebuilt
    #: — same bound (and rationale) as the legacy raw TSID cache clear at
    #: 1<<21 entries (add_rows): high-churn keys must not leak memory
    MAX_KEYS = 1 << 21

    def __init__(self):
        from .. import native
        self.keymap = native.KeyMap()
        # per-space lock: same-tenant columnar writers serialize HERE,
        # not on the storage-wide lock (cross-tenant ingest is parallel);
        # `retired` marks a rotated-out space whose key map is closed —
        # holders must re-fetch (pending chunks only read the numpy
        # columns, which stay alive)
        self.lock = make_lock("storage._ColumnarSpace.lock")
        self.retired = False
        self.tsids: list = []
        self._cap = 0
        z = np.zeros(0, np.uint64)
        self.acc = z
        self.proj = z.copy()
        self.grp = z.copy()
        self.job = z.copy()
        self.inst = z.copy()
        self.mid = z.copy()
        self.drop = np.zeros(0, np.uint8)
        self.last_date = np.zeros(0, np.int64)

    def _grow(self, need: int) -> None:
        """Amortized-doubling growth of the per-id columns (append_ids runs
        per new-series batch; O(total) reallocation there would make churny
        workloads quadratic)."""
        if need <= self._cap:
            return
        ncap = max(1024, self._cap * 2, need)
        for f in ("acc", "proj", "grp", "job", "inst", "mid", "drop",
                  "last_date"):
            old = getattr(self, f)
            new = np.empty(ncap, old.dtype)
            new[:len(self.tsids)] = old[:len(self.tsids)]
            setattr(self, f, new)
        self._cap = ncap

    def append_ids(self, tsids: list, drops: list) -> None:
        """Registers len(tsids) new ids (tsids[i] is None when drops[i]!=0)."""
        k = len(tsids)
        n = len(self.tsids)
        self._grow(n + k)
        for j, (t, d) in enumerate(zip(tsids, drops)):
            i = n + j
            if t is not None:
                self.acc[i] = t.account_id
                self.proj[i] = t.project_id
                self.grp[i] = t.metric_group_id
                self.job[i] = t.job_id
                self.inst[i] = t.instance_id
                self.mid[i] = t.metric_id
            else:
                self.acc[i] = self.proj[i] = self.grp[i] = 0
                self.job[i] = self.inst[i] = self.mid[i] = 0
            self.drop[i] = d
            self.last_date[i] = -(1 << 62)
        self.tsids.extend(tsids)

    def set_tsid(self, i: int, tsid) -> None:
        """Re-admits a previously dropped id (cardinality retry)."""
        self.tsids[i] = tsid
        self.acc[i] = tsid.account_id
        self.proj[i] = tsid.project_id
        self.grp[i] = tsid.metric_group_id
        self.job[i] = tsid.job_id
        self.inst[i] = tsid.instance_id
        self.mid[i] = tsid.metric_id
        self.drop[i] = 0
        self.last_date[i] = -(1 << 62)

    def close(self):
        # every caller holds self.lock via acquire/release bracketing the
        # static pass cannot see (_acquire_cspace returns with it HELD,
        # reset_columnar_spaces takes `with sp.lock`)
        km, self.keymap = self.keymap, None  # vmt: disable=VMT015
        if km is not None:
            km.close()


def _phase_lap(phase: str, t0: float) -> float:
    """Account wall time since t0 to a fetch phase (counter + flight
    event + the current query's CostTracker); returns the new t0."""
    now = time.perf_counter()
    _PHASE[phase].inc(now - t0)
    flightrec.rec("fetch:" + phase, t0, now - t0)
    costacc.lap("fetch:" + phase, now - t0)
    return now


def _ingest_lap(phase: str, t0: float) -> float:
    """Account wall time since t0 to an ingest phase; returns the new t0."""
    now = time.perf_counter()
    _ING_PHASE[phase].inc(now - t0)
    flightrec.rec("ingest:" + phase, t0, now - t0)
    return now


class SeriesData:
    """Decoded query result for one series."""

    __slots__ = ("metric_name", "timestamps", "values", "raw_name",
                 "_stale_blocks", "_maybe_stale")

    def __init__(self, metric_name: MetricName, timestamps: np.ndarray,
                 values: np.ndarray, raw_name: bytes | None = None,
                 stale_blocks=None, maybe_stale: bool | None = None):
        self.metric_name = metric_name
        self.timestamps = timestamps
        self.values = values
        self.raw_name = raw_name  # marshaled name (sort/fingerprint key)
        # lazily computed from the contributing blocks' memoized stale
        # scans: default_rollup (the common case) never consults it, so it
        # costs nothing there; sealed-part blocks amortize across queries
        self._stale_blocks = stale_blocks
        if maybe_stale is not None:  # precomputed by the columnar path
            self._maybe_stale = maybe_stale
        else:
            self._maybe_stale = None if stale_blocks is not None else True

    @property
    def maybe_stale(self) -> bool:
        """False when every contributing block is known stale-marker-free
        (block-level memo): lets the eval skip the per-query stale scan."""
        if self._maybe_stale is None:
            self._maybe_stale = any(b.has_stale()
                                    for b in self._stale_blocks)
            self._stale_blocks = None
        return self._maybe_stale


class Storage:
    def __init__(self, path: str, retention_ms: int = DEFAULT_RETENTION_MS,
                 dedup_interval_ms: int = 0, max_hourly_series: int = 0,
                 max_daily_series: int = 0, downsample: str | None = None):
        self.path = path
        self.retention_ms = retention_ms
        self.dedup_interval_ms = dedup_interval_ms
        # downsampling tiers (storage/downsample.py): offset:res[:keep],
        # finest first; None reads the VM_DOWNSAMPLE env grammar
        from . import downsample as _ds
        self.downsample_tiers = _ds.parse_spec(
            os.environ.get("VM_DOWNSAMPLE", "") if downsample is None
            else downsample)
        self._downsample_interval_s = float(
            os.environ.get("VM_DOWNSAMPLE_INTERVAL_S", "60"))
        self._last_downsample = time.monotonic()
        # per-request partial-RESOLUTION flag (reset_partial clears it):
        # set when a fetch fell back to a coarser tier than the query's
        # step allows (raw dropped, no satisfying tier)
        self._partial_res_flag = False
        from .cardinality import BloomLimiter
        self.hourly_limiter = (BloomLimiter(max_hourly_series, 3600, "hourly")
                               if max_hourly_series > 0 else None)
        self.daily_limiter = (BloomLimiter(max_daily_series, 86400, "daily")
                              if max_daily_series > 0 else None)
        os.makedirs(path, exist_ok=True)
        self._flock_f = open(os.path.join(path, "flock.lock"), "w")
        try:
            fcntl.flock(self._flock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            raise RuntimeError(f"storage at {path} is locked by another process")
        self._check_format()
        self.idb = IndexDB(os.path.join(path, "indexdb"))
        self.table = Table(os.path.join(path, "data"), dedup_interval_ms)
        # open-time integrity verdict, frozen for the process lifetime:
        # quarantine/open-error state only changes at open (see
        # last_partial) and the flag is read per query
        self._has_quarantine = bool(self.table.quarantined() or
                                    self.idb.quarantined())
        self._tsid_cache: dict[bytes, TSID] = {}
        # fast-path cache keyed by the UNMARSHALED label identity (the
        # reference's MetricNameRaw-keyed tsidCache, storage.go:1874): rows
        # with a cached label tuple skip MetricName construction entirely.
        # Two-generation rotation (workingsetcache analog) instead of a
        # multi-million-entry clear() on overflow.
        self._tsid_cache_raw = WorkingSetCache(1 << 21, "storage.tsid_raw")
        # per-tenant columnar id spaces (native key map + per-id numpy
        # state), lazily created by add_rows_columnar
        self._cspaces: dict[tuple, "_ColumnarSpace"] = {}
        # striped registration shards: the per-day cache is split by
        # hash(metric_id) % VM_INGEST_SHARDS, each slice with its own
        # lock (VM_INGEST_SHARDS=1 restores the single-stripe layout)
        self._shards = [_IngestShard()
                        for _ in range(workpool.configured_shards())]
        self._mid_gen = MetricIDGenerator()
        self._lock = make_rlock("storage.Storage._lock")
        self._stop = threading.Event()
        self._readonly = False
        self.rows_added = 0
        # bumped on every data mutation (ingest/delete/retention): cheap
        # content token for device tile-cache fingerprints
        self.data_version = 0
        # bumped only on mutations that REMOVE visible data (delete,
        # retention): append-only ingest keeps it stable so rolling device
        # tiles can advance incrementally instead of rebuilding
        self.structural_version = 0
        # (data_version, min inserted ts) per append batch, bounded: lets a
        # rolling tile ask "was anything since version v older than my
        # covered range?" (late/backfill data forces a rebuild)
        from collections import deque
        self._append_log: deque = deque(maxlen=4096)
        self._append_log_floor = 0  # appends at versions <= floor may be
        #                             missing from the bounded log
        # memoized name-resolution/row-order products per fetched id set
        # (suffix-aware fetch; see _resolve_ordered_names)
        from collections import OrderedDict
        self._name_memo: OrderedDict = OrderedDict()
        self._name_memo_lock = make_lock("storage.Storage._name_memo")
        self.slow_row_inserts = 0
        self.new_series_created = 0
        # metric-name usage stats + TYPE/HELP metadata (storage-resident
        # so cluster RPCs can serve them; lib/storage/metricnamestats)
        self._name_usage: dict = {}
        self.metadata: dict[str, dict] = {}
        from ..query.rollup_result_cache import next_storage_token
        self.cache_token = next_storage_token()
        # series this node must ALWAYS serve regardless of ring
        # ownership (parallel/ringfilter): adopted via part migration or
        # landed here by a write reroute — this node may hold the only
        # copy of some of their samples.  Persisted (append-only) so a
        # restart keeps serving them.
        self._ring_exempt: set[bytes] = set()
        self._ring_exempt_lock = make_lock("storage.Storage._ring_exempt")
        self._load_ring_exempt()
        # adopted-foreign-id watermark: the id generator's restart
        # uniqueness comes from nanotime reseeding, which only covers
        # LOCALLY generated ids — ids adopted from a clock-ahead node
        # must stay reserved across restarts too
        self._load_adopted_watermark()
        self._load_caches()
        # long-lived service timer, not hot-path fan-out: it owns the
        # periodic flush cadence and is joined cleanly in close() (the
        # daemon flag only covers processes that never call close)
        self._flusher = threading.Thread(  # vmt: disable=VMT011 — service
            target=self._flush_loop, daemon=True,  # timer; close() joins it
            name="vm-storage-flusher")
        self._flusher.start()

    FORMAT_VERSION = 3  # v2: 32-byte tenant TSID; v3: indexdb/global layout

    def _check_format(self):
        """Refuse to open data directories written with an incompatible
        on-disk format instead of misparsing them (format.json marker)."""
        import json as _json
        marker = os.path.join(self.path, "format.json")
        has_data = any(os.path.isdir(os.path.join(self.path, d))
                       for d in ("data", "indexdb"))
        if os.path.exists(marker):
            with open(marker) as f:
                v = _json.load(f).get("format_version")
            if v != self.FORMAT_VERSION:
                raise RuntimeError(
                    f"storage at {self.path} uses on-disk format v{v}; this "
                    f"build reads v{self.FORMAT_VERSION} — restore from a "
                    f"snapshot or re-ingest")
        elif has_data:
            raise RuntimeError(
                f"storage at {self.path} predates the versioned on-disk "
                f"format (v{self.FORMAT_VERSION}) — restore from a snapshot "
                f"or re-ingest")
        else:
            with open(marker, "w") as f:
                _json.dump({"format_version": self.FORMAT_VERSION}, f)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._stop.set()
        self._flusher.join(timeout=10)
        self._save_caches()
        self.table.flush_to_disk()
        self.idb.flush()
        self.table.close()
        self.idb.close()
        with self._lock:
            spaces, self._cspaces = self._cspaces, {}
        for sp in spaces.values():
            sp.close()
        fcntl.flock(self._flock_f, fcntl.LOCK_UN)
        self._flock_f.close()

    def _flush_loop(self):
        last_disk = time.monotonic()
        while not self._stop.wait(2.0):
            try:
                self.table.flush_pending()
                if time.monotonic() - last_disk >= 5.0:
                    self.table.flush_to_disk()
                    self.idb.flush()
                    last_disk = time.monotonic()
                if self.downsample_tiers and \
                        time.monotonic() - self._last_downsample >= \
                        self._downsample_interval_s:
                    self.run_downsample_cycle()
            except Exception as e:  # pragma: no cover
                logger.errorf("storage flusher: %s", e)

    def run_downsample_cycle(self, now_ms: int | None = None) -> int:
        """One background re-rollup pass over every partition x tier
        (the historicalMergeWatcher cadence; also called directly by
        tests/bench/smoke to force aging).  Flushes first — tier
        coverage must only ever run over DURABLE raw parts."""
        if not self.downsample_tiers:
            return 0
        self.table.flush_to_disk()
        written = self.table.run_downsample(
            self.downsample_tiers, self.idb.deleted_metric_ids,
            fasttime.unix_ms() if now_ms is None else now_ms)
        self._last_downsample = time.monotonic()
        if written:
            with self._lock:
                # new tier parts change what a query may read
                self.data_version += 1
        return written

    # -- cache persistence (storage.go:1026-1041 mustSaveCache analogs) ----

    _CACHE_MAGIC = b"vmtpu-cache-v2\n"

    def _save_caches(self):
        """Persist the tsid and per-day caches so a restart does not
        re-resolve every live series through the index."""
        import struct as _st
        d = os.path.join(self.path, "cache")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "tsid_cache.bin.tmp")
        with self._lock:
            tsid_items = list(self._tsid_cache.items())
        day_items = []
        for shard in self._shards:
            with shard.lock:
                day_items.extend(shard.day_cache)
        with open(tmp, "wb") as f:
            f.write(self._CACHE_MAGIC)
            f.write(_st.pack("<Q", len(tsid_items)))
            for (tenant, raw), t in tsid_items:
                f.write(_st.pack("<III", tenant[0], tenant[1], len(raw)))
                f.write(raw)
                f.write(t.marshal())
            f.write(_st.pack("<Q", len(day_items)))
            for mid, date in day_items:
                f.write(_st.pack("<QI", mid, date))
        os.rename(tmp, os.path.join(d, "tsid_cache.bin"))

    def _load_caches(self):
        import struct as _st
        fp = os.path.join(self.path, "cache", "tsid_cache.bin")
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except OSError:
            return
        if not data.startswith(self._CACHE_MAGIC):
            return
        try:
            off = len(self._CACHE_MAGIC)
            (n,) = _st.unpack_from("<Q", data, off)
            off += 8
            for _ in range(n):
                a, p, ln = _st.unpack_from("<III", data, off)
                off += 12
                raw = data[off:off + ln]
                off += ln
                t = TSID.unmarshal(data[off:off + TSID.SIZE])
                off += TSID.SIZE
                self._tsid_cache[((a, p), raw)] = t
            (n,) = _st.unpack_from("<Q", data, off)
            off += 8
            nsh = len(self._shards)
            for _ in range(n):
                mid, date = _st.unpack_from("<QI", data, off)
                off += 12
                self._shards[mid % nsh].day_cache.add((mid, date))
        except (_st.error, IndexError):
            # torn write: caches are an optimization, start cold
            self._tsid_cache.clear()
            for shard in self._shards:
                shard.day_cache.clear()

    @property
    def is_readonly(self) -> bool:
        return self._readonly

    def set_readonly(self, ro: bool):
        self._readonly = ro

    # -- writes ------------------------------------------------------------

    def _resolve_tsid(self, mn: MetricName, raw: bytes,
                      tenant=(0, 0), limited=False) -> TSID | None:
        """Resolve or create the TSID. With limited=True the cardinality
        limiter is consulted BEFORE any index writes, so an over-budget
        NEW series creates no index entries at all (storage.go:2136
        ordering); returns None when the limiter rejects.

        This is the slow index path; it serializes on the storage lock,
        which fast-path (cache-hit) rows no longer take at all."""
        ck = (tenant, raw)
        with self._lock:
            tsid = self._tsid_cache.get(ck)
            if tsid is not None:
                if limited and not self._cardinality_ok(tsid.metric_id):
                    return None
                return tsid
            # monotonic stat, written under _lock; the /metrics reader
            # takes a lock-free int snapshot — staleness, not corruption
            self.slow_row_inserts += 1  # vmt: disable=VMT015
            tsid = self.idb.get_tsid_by_name(raw, tenant)
            if tsid is None:
                tsid = generate_tsid(mn, self._mid_gen.next_id(), tenant)
                if limited and not self._cardinality_ok(tsid.metric_id):
                    return None
                self.idb.create_indexes_for_metric(mn, tsid)
                # monotonic stat (see slow_row_inserts above)
                self.new_series_created += 1  # vmt: disable=VMT015
            elif limited and not self._cardinality_ok(tsid.metric_id):
                return None
            self._tsid_cache[ck] = tsid
            return tsid

    #: add_rows accepts raw `name{labels}` BYTES keys (native parser fast
    #: path); ClusterStorage does NOT — it must decompose labels to shard
    #: and marshal the RPC payload, so the HTTP layer gates on this.
    supports_raw_keys = True

    def add_rows(self, rows, tenant=(0, 0)) -> int:
        """rows: iterable of (MetricName | dict | list[(k,v)], ts_ms, value).
        Returns rows added (AddRows/Storage.add analog, storage.go:1655).

        Sharded write path (rawRowsShards analog). Three phases:

        1. **resolve** — input-order pass over the batch with NO
           storage-wide lock: raw-label cache lookups (rotating
           working-set cache), cardinality probes, per-day cache checks.
           Only first-seen series drop into the slow index path, which
           serializes on the storage lock — fast-path rows from
           concurrent writers never wait behind it.
        2. **register** — per-day index registration striped by
           ``hash(metric_id) % VM_INGEST_SHARDS``, each stripe under its
           own lock; large batches fan stripes across the shared work
           pool.  Index items are set-semantic, so stripe order never
           changes what the index contains.
        3. **append** — rows land in the partitions in input order, so
           part contents are byte-identical to the sequential path
           (``VM_INGEST_SHARDS=1`` restores it exactly).
        """
        if self._readonly:
            raise RuntimeError("storage is read-only")
        t0 = time.perf_counter()
        out = []
        regs = []       # (mn, tsid, date) needing per-day registration
        reg_seen = set()  # batch-local (mid, date) dedup: one regs entry
        #                   per distinct rollover, not per row
        raw_cache = self._tsid_cache_raw
        nsh = len(self._shards)
        for labels, ts, val in rows:
            key = None
            if type(labels) is dict:
                key = (tenant, *labels.items())
            elif type(labels) is list:
                key = (tenant, *labels)
            elif type(labels) is bytes:
                # raw `name{labels}` series key from the native parser:
                # cache hits never materialize labels at all
                key = (tenant, labels)
            tsid = raw_cache.get(key) if key is not None else None
            date = ts // 86_400_000
            mn = None
            if tsid is not None:
                if not self._cardinality_ok(tsid.metric_id):
                    continue
                mid = tsid.metric_id
                # OPTIMISTIC day-cache probe, no stripe lock: GIL-atomic
                # set membership against adds that happen only under the
                # stripe lock; a stale miss merely routes the row through
                # _register_days, which re-checks under the lock (entries
                # are never removed during ingest).  Taking the stripe
                # lock here would re-serialize the whole fast path.
                if (mid, date) in reg_seen or \
                        (mid, date) in self._shards[mid % nsh].day_cache:
                    out.append((tsid, ts, val))
                    continue
                # day rollover: rebuild the name from the index cache
                mn = self.idb.get_metric_name_by_id(mid)
            if mn is None:
                if isinstance(labels, MetricName):
                    mn = labels
                elif isinstance(labels, dict):
                    mn = MetricName.from_dict(labels)
                elif isinstance(labels, bytes):
                    from ..ingest.parsers import labels_from_series_key
                    try:
                        mn = MetricName.from_labels(
                            labels_from_series_key(labels))
                    except ValueError:
                        continue  # malformed key: skip row, keep batch
                else:
                    mn = MetricName.from_labels(labels)
                tsid = self._resolve_tsid(mn, mn.marshal(), tenant,
                                          limited=True)
                if tsid is None:
                    continue  # over the cardinality budget
                if key is not None:
                    raw_cache.put(key, tsid)
                mid = tsid.metric_id
                if (mid, date) in reg_seen or \
                        (mid, date) in self._shards[mid % nsh].day_cache:
                    out.append((tsid, ts, val))
                    continue
            reg_seen.add((mid, date))
            regs.append((mn, tsid, date))
            out.append((tsid, ts, val))
        t0 = _ingest_lap("resolve", t0)
        if regs:
            self._register_days(regs)
        t0 = _ingest_lap("register", t0)
        n = len(out)
        if n == 0:
            return 0
        # backfill older than the result-cache offset invalidates cached
        # rollup tails (ResetRollupResultCacheIfNeeded) — at STORAGE
        # level so library/embedded writers are covered too; the batch
        # minimum is computed ONCE and reused for the append log
        oldest = min(r[1] for r in out)
        from ..query.rollup_result_cache import GLOBAL, OFFSET_MS
        if oldest < fasttime.unix_ms() - OFFSET_MS:
            GLOBAL.reset()
        self.table.add_rows(out)
        _ingest_lap("append", t0)
        _INGEST_ROWS.inc(n)
        with self._lock:
            # monotonic stat, written under _lock; the /metrics reader
            # takes a lock-free int snapshot — staleness, not corruption
            self.rows_added += n  # vmt: disable=VMT015
            self.data_version += 1
            log = self._append_log
            if log.maxlen is not None and len(log) == log.maxlen:
                self._append_log_floor = log[0][0]
            log.append((self.data_version, oldest))
        return n

    @contextmanager
    def _shard_locked(self, si: int):
        """Acquire stripe si's lock, accounting the wait time to
        vm_ingest_shard_lock_wait_seconds_total."""
        shard = self._shards[si]
        tw = time.perf_counter()
        shard.lock.acquire()
        _SHARD_WAIT.inc(time.perf_counter() - tw)
        try:
            yield shard
        finally:
            shard.lock.release()

    def _fan_stripes(self, by_shard: dict, run_stripe, total: int) -> None:
        """Execute run_stripe(shard_index, payload) for every stripe —
        across the shared pool for large batches (>= _FANOUT_MIN_REGS
        items, several stripes, pool enabled), inline otherwise.  Stripe
        execution order is unobservable: per-day index items collapse
        set-semantically in the mergeset."""
        stripes = sorted(by_shard.items())
        if len(stripes) > 1 and total >= _FANOUT_MIN_REGS and \
                workpool.ingest_parallel_enabled():
            from functools import partial
            workpool.POOL.run([partial(run_stripe, si, payload)
                               for si, payload in stripes])
        else:
            for si, payload in stripes:
                run_stripe(si, payload)

    def _register_days(self, regs) -> None:
        """Per-day index registration, striped by hash(metric_id) % N:
        each stripe runs under its own lock (in input order within the
        stripe), large batches fanned across the shared work pool."""
        nsh = len(self._shards)
        by_shard: dict[int, list] = {}
        for reg in regs:
            by_shard.setdefault(reg[1].metric_id % nsh, []).append(reg)

        def run_stripe(si, items):
            with self._shard_locked(si) as shard:
                for mn, tsid, date in items:
                    dk = (tsid.metric_id, date)
                    if dk in shard.day_cache:
                        continue
                    self.idb.create_per_day_indexes(mn, tsid, date)
                    shard.day_cache.add(dk)

        self._fan_stripes(by_shard, run_stripe, len(regs))

    #: add_rows_columnar accepts native.ColumnarRows batches; ClusterStorage
    #: does not (it must decompose labels to shard), so HTTP gates on this.
    supports_columnar = True

    def add_rows_columnar(self, cr, tenant=(0, 0), transform=None,
                          drop_stats: dict | None = None) -> int:
        """Columnar ingest batch (native.ColumnarRows): resolves every raw
        series key to a dense id with ONE native hash-map call, then runs
        filtering/day-index bookkeeping as numpy masking. Per-row Python
        exists only for NEW series and day rollovers.

        `transform(labels) -> labels | None` runs ONCE per new series (None
        = drop); the verdict is cached under the raw key, which is how
        relabeling composes with the fast path (relabel rules are pure
        functions of the label set). Callers must reset the columnar spaces
        when the transform config changes (reset_columnar_spaces).

        `drop_stats`: optional dict, incremented per dropped ROW by reason
        ("malformed" / "transform" / "cardinality" / "limiter").
        """
        if self._readonly:
            raise RuntimeError("storage is read-only")
        t0 = time.perf_counter()
        sp = self._acquire_cspace(tenant)  # returns with sp.lock HELD
        try:
            ids, n_new = sp.keymap.resolve(cr.keybuf, cr.key_off, cr.key_len)
            if n_new:
                self._register_columnar_ids(sp, cr, ids, tenant, transform)
            drop = sp.drop[ids]
            if (drop == 3).any():
                # cardinality rejections are transient (limiter windows
                # rotate hourly/daily): re-judge once per id per batch,
                # matching the legacy path's per-batch retry
                retried = set()
                for r in np.flatnonzero(drop == 3):
                    i = int(ids[r])
                    if i in retried:
                        continue
                    retried.add(i)
                    key = bytes(memoryview(cr.keybuf)[
                        int(cr.key_off[r]):
                        int(cr.key_off[r]) + int(cr.key_len[r])])
                    tsid, verdict = self._judge_key(key, tenant, transform)
                    if tsid is not None:
                        sp.set_tsid(i, tsid)
                drop = sp.drop[ids]
            tss, vals = cr.tss, cr.values
            sel = None  # surviving-row indices into cr (None = all)
            if drop.any():
                if drop_stats is not None:
                    for code, name in ((1, "malformed"), (2, "transform"),
                                       (3, "cardinality")):
                        c = int((drop == code).sum())
                        if c:
                            drop_stats[name] = drop_stats.get(name, 0) + c
                keep = drop == 0
                sel = np.flatnonzero(keep)
                ids = ids[keep]
                tss = tss[keep]
                vals = vals[keep]
            if ids.size and (self.hourly_limiter is not None or
                             self.daily_limiter is not None):
                # one limiter probe per DISTINCT series per batch preserves
                # the limiters' distinct-count semantics at columnar cost
                uniq = np.unique(ids)
                bad = [i for i in uniq
                       if not self._cardinality_ok(int(sp.mid[i]))]
                if bad:
                    keep = ~np.isin(ids, bad)
                    if drop_stats is not None:
                        c = int(ids.size - keep.sum())
                        drop_stats["limiter"] = drop_stats.get(
                            "limiter", 0) + c
                    sel = (np.flatnonzero(keep) if sel is None
                           else sel[keep])
                    ids = ids[keep]
                    tss = tss[keep]
                    vals = vals[keep]
            if ids.size == 0:
                return 0
            dates = tss // 86_400_000
            roll = np.flatnonzero(sp.last_date[ids] != dates)
            if roll.size:
                # touch each distinct (id, date) pair ONCE: a fresh
                # series' first batch used to walk every ROW here (the
                # memo only updates after the first row, but the Python
                # loop still visited all of them)
                d_clip = np.clip(dates[roll], -(1 << 20), (1 << 20) - 1)
                key = (ids[roll].astype(np.int64) * (1 << 21) +
                       d_clip + (1 << 20))
                _, first = np.unique(key, return_index=True)
                roll = roll[first]
            t0 = _ingest_lap("resolve", t0)
            if roll.size:
                self._register_columnar_days(sp, cr, ids, dates, sel, roll,
                                             transform)
            t0 = _ingest_lap("register", t0)
        finally:
            sp.lock.release()
        oldest = int(tss.min())
        from ..query.rollup_result_cache import GLOBAL, OFFSET_MS
        if oldest < fasttime.unix_ms() - OFFSET_MS:
            GLOBAL.reset()
        self.table.add_rows_columnar(sp, ids, tss, vals)
        _ingest_lap("append", t0)
        n = int(ids.size)
        _INGEST_ROWS.inc(n)
        with self._lock:
            self.rows_added += n
            self.data_version += 1
            log = self._append_log
            if log.maxlen is not None and len(log) == log.maxlen:
                self._append_log_floor = log[0][0]
            log.append((self.data_version, oldest))
        return n

    def _acquire_cspace(self, tenant) -> "_ColumnarSpace":
        """The tenant's columnar id space with its lock HELD (caller
        releases): same-tenant columnar writers serialize here instead
        of on the storage-wide lock.  Spaces whose native key map
        outgrew MAX_KEYS are retired under their lock (the raw-cache
        rotation analog) and replaced with a fresh one; in-flight
        PendingChunks keep the retired space's numpy columns alive."""
        while True:
            with self._lock:
                sp = self._cspaces.get(tenant)
                if sp is None:
                    sp = self._cspaces[tenant] = _ColumnarSpace()
            sp.lock.acquire()
            if sp.retired:
                sp.lock.release()
                continue  # lost the race with a rotation: re-fetch
            if len(sp.keymap) < sp.MAX_KEYS:
                return sp
            # bound churny key spaces (raw-cache clear analog)
            sp.retired = True
            sp.close()
            with self._lock:
                if self._cspaces.get(tenant) is sp:
                    del self._cspaces[tenant]
            sp.lock.release()

    def _register_columnar_days(self, sp, cr, ids, dates, sel, roll,
                                transform) -> None:
        """Columnar per-day registration for the distinct (id, date)
        rollovers in `roll`, striped by hash(metric_id) % N.  Runs with
        sp.lock held — the per-id `last_date` memo is batch-exclusive —
        and fans stripes across the shared pool for large rollover sets
        (first batch of a high-cardinality scrape)."""
        nsh = len(self._shards)
        by_shard: dict[int, list] = {}
        for r in roll:
            by_shard.setdefault(
                int(sp.mid[int(ids[r])]) % nsh, []).append(int(r))

        def run_stripe(si, rs):
            with self._shard_locked(si) as shard:
                for r in rs:
                    i = int(ids[r])
                    d = int(dates[r])
                    if sp.last_date[i] == d:
                        continue
                    mid = int(sp.mid[i])
                    if (mid, d) not in shard.day_cache:
                        mn = self.idb.get_metric_name_by_id(mid)
                        if mn is None:
                            # index name cache miss: rebuild from this
                            # batch's raw key (+ transform, for
                            # relabeled series)
                            mn = self._rebuild_mn_from_row(cr, sel, r,
                                                           transform)
                        if mn is not None:
                            self.idb.create_per_day_indexes(
                                mn, sp.tsids[i], d)
                        shard.day_cache.add((mid, d))
                    sp.last_date[i] = d

        self._fan_stripes(by_shard, run_stripe, int(roll.size))

    def _rebuild_mn_from_row(self, cr, sel, r, transform):
        """MetricName from row r's raw series key (sel maps surviving
        rows back to cr rows); None on malformed/transform-dropped."""
        from ..ingest.parsers import labels_from_series_key
        rr = int(sel[r]) if sel is not None else int(r)
        try:
            labels = labels_from_series_key(bytes(
                memoryview(cr.keybuf)[
                    int(cr.key_off[rr]):
                    int(cr.key_off[rr]) + int(cr.key_len[rr])]))
            if transform is not None:
                labels = transform(labels)
            if labels:
                return MetricName.from_labels(labels)
        except ValueError:
            pass
        return None

    def _judge_key(self, key: bytes, tenant, transform):
        """Raw key -> (tsid | None, verdict): materialize labels, run the
        transform, resolve the TSID. Verdicts: 0 ok, 1 malformed, 2 dropped
        by transform, 3 over the cardinality budget (re-triable)."""
        from ..ingest.parsers import labels_from_series_key
        try:
            labels = labels_from_series_key(key)
        except ValueError:
            return None, 1
        if transform is not None:
            labels = transform(labels)
            if labels is None:
                return None, 2
        mn = MetricName.from_labels(labels)
        tsid = self._resolve_tsid(mn, mn.marshal(), tenant, limited=True)
        if tsid is None:
            return None, 3
        return tsid, 0

    def _register_columnar_ids(self, sp, cr, ids, tenant, transform) -> None:
        """Slow path for first-seen raw keys: materialize labels, run the
        transform, resolve TSIDs, create indexes. Ids arrive in
        first-occurrence order, so one ascending pass assigns them all."""
        old = len(sp.tsids)
        mv = memoryview(cr.keybuf)
        new_tsids: list = []
        drops: list = []
        mask = ids >= old
        if not mask.any():
            return
        # touch only the FIRST row of each new id, not every row of the
        # (typically sample-dense) first batch: ids are assigned in
        # first-occurrence order, so ascending unique ids == registration
        # order (a 1440-sample first batch used to cost 1440 iterations
        # per new series here)
        rows = np.flatnonzero(mask)
        uniq, first = np.unique(ids[rows], return_index=True)
        for i, r in zip(uniq, rows[first]):
            if int(i) != old + len(new_tsids):
                continue  # defensive: gap means a concurrent registration
            key = bytes(mv[int(cr.key_off[r]):
                           int(cr.key_off[r]) + int(cr.key_len[r])])
            tsid, verdict = self._judge_key(key, tenant, transform)
            new_tsids.append(tsid)
            drops.append(verdict)
        sp.append_ids(new_tsids, drops)

    def reset_columnar_spaces(self) -> None:
        """Invalidate all cached raw-key -> TSID verdicts (call after the
        ingest transform config — relabel rules, series limits — changes).
        In-flight PendingChunks keep the old space objects alive; spaces
        are retired under their own lock so a concurrent columnar writer
        either finishes its batch first or re-fetches a fresh space."""
        with self._lock:
            spaces = list(self._cspaces.values())
            self._cspaces = {}
        for sp in spaces:
            with sp.lock:
                sp.retired = True
                sp.close()

    def min_appended_since(self, version: int):
        """Minimum timestamp inserted after data_version `version`, or None
        when nothing was appended since. Raises LookupError when `version`
        predates the bounded append log (caller must rebuild)."""
        with self._lock:
            # under _lock: concurrent ingest appends to _append_log, and
            # a deque mutated mid-iteration raises RuntimeError
            if version < self._append_log_floor:
                raise LookupError("append log does not cover version")
            lo = None
            for v, mn in reversed(self._append_log):
                if v <= version:
                    break
                lo = mn if lo is None else min(lo, mn)
            return lo

    def _cardinality_ok(self, metric_id: int) -> bool:
        """registerSeriesCardinality (storage.go:2136): hourly/daily bloom
        limiters drop rows for ids beyond the distinct-series budget."""
        # BloomLimiter.add is internally locked (admissions are atomic);
        # the fields themselves are rebound only at configure time
        if self.hourly_limiter is not None and \
                not self.hourly_limiter.add(metric_id):  # vmt: disable=VMT015
            return False
        if self.daily_limiter is not None and \
                not self.daily_limiter.add(metric_id):  # vmt: disable=VMT015
            return False
        return True

    def register_metric_names(self, metric_names, tenant=(0, 0)) -> None:
        """Create index entries without samples (RegisterMetricNames,
        storage.go:1524)."""
        with self._lock:
            for labels in metric_names:
                mn = labels if isinstance(labels, MetricName) else \
                    MetricName.from_dict(labels)
                self._resolve_tsid(mn, mn.marshal(), tenant)

    # -- reads -------------------------------------------------------------

    # selector-level `or` filters ({a="b" or c="d"}) arrive as a list of
    # filter SETS; this store unions them at the tsid level (one assemble
    # pass over the merged id set — the reference's index union)
    supports_filter_union = True

    @staticmethod
    def _filter_sets(filters):
        """Normalize filters into a list of filter sets: a plain
        list[TagFilter] is one set; a list of lists is an OR union."""
        if filters and isinstance(filters[0], (list, tuple)):
            return list(filters)
        return [filters]

    def _search_tsids_union(self, filters, min_ts, max_ts, tenant,
                            check=None, scan_check=None):
        """search_tsids over one or many OR'd filter sets, deduped by
        metric id and returned in sort_key order (the invariant every
        caller's tsid_lo/tsid_hi clamping relies on)."""
        sets = self._filter_sets(filters)
        if len(sets) == 1:
            return self.idb.search_tsids(sets[0], min_ts, max_ts, tenant,
                                         check=check,
                                         scan_check=scan_check)
        seen: dict = {}
        for fs in sets:
            for t in self.idb.search_tsids(fs, min_ts, max_ts, tenant,
                                           check=check,
                                           scan_check=scan_check):
                seen.setdefault(t.metric_id, t)
        return sorted(seen.values(), key=lambda t: t.sort_key())

    def search_metric_names(self, filters: list[TagFilter], min_ts: int,
                            max_ts: int, limit: int = 2**31,
                            tenant=(0, 0)) -> list[MetricName]:
        mids = self._search_mids_union(filters, min_ts, max_ts, tenant)
        out = []
        for mid in mids[:limit]:
            mn = self.idb.get_metric_name_by_id(int(mid))
            if mn is not None:
                out.append(mn)
        return out

    def _search_mids_union(self, filters, min_ts, max_ts, tenant):
        sets = self._filter_sets(filters)
        if len(sets) == 1:
            return self.idb.search_metric_ids(sets[0], min_ts, max_ts,
                                              tenant)
        out: set = set()
        for fs in sets:
            out.update(self.idb.search_metric_ids(fs, min_ts, max_ts,
                                                  tenant))
        return sorted(out)

    def iter_series_blocks(self, filters: list[TagFilter], min_ts: int,
                           max_ts: int, tenant=(0, 0)):
        """Raw matching blocks in (tsid, min_ts) order — the input to the
        TPU tile packer (Search.NextMetricBlock analog, search.go:275)."""
        tsids = self._search_tsids_union(filters, min_ts, max_ts, tenant)
        tsid_set = {t.metric_id for t in tsids}
        if not tsid_set:
            return
        yield from self.table.iter_blocks(
            tsid_set, min_ts, max_ts,
            tsid_lo=tsids[0].sort_key(), tsid_hi=tsids[-1].sort_key())

    def estimate_series(self, filters: list[TagFilter], min_ts: int,
                        max_ts: int, tenant=(0, 0)) -> int:
        """Matching-series count without fetching samples (the tsid
        search is cached, so a following search_columns* reuses it)."""
        return len(self._search_tsids_union(filters, min_ts, max_ts,
                                            tenant))

    def search_columns_chunked(self, filters: list[TagFilter], min_ts: int,
                               max_ts: int,
                               dedup_interval_ms: int | None = None,
                               max_series: int | None = None, tenant=(0, 0),
                               max_chunk_samples: int = 50_000_000,
                               deadline: float = 0.0):
        """Bounded-memory fetch: yields ColumnarSeries chunks over
        disjoint series subsets, each holding at most ~max_chunk_samples
        resident samples (the tmp-blocks-spool role,
        app/vmselect/netstorage/tmp_blocks_file.go — here the spool is
        the on-disk part itself and each chunk decodes only its own
        blocks). The per-series density estimate starts at the 15s scrape
        grid and adapts to what the first chunk actually returned."""
        tsids = self._search_tsids_union(filters, min_ts, max_ts, tenant)
        if not tsids:
            return
        est = max((max_ts - min_ts) // 15_000 + 2, 1)
        i, S = 0, len(tsids)
        seen = 0

        def fetch(lo: int, k: int):
            return self.search_columns(filters, min_ts, max_ts,
                                       dedup_interval_ms, None, tenant,
                                       _tsids=tsids[lo:lo + k],
                                       deadline=deadline)

        # pipelined prefetch: chunk i+1's fetch/decode runs on the shared
        # work pool while the consumer rolls chunk i up (the netstorage
        # fetch/compute overlap); chunk boundaries, results and error
        # behavior are identical to the sequential loop because est is
        # updated from chunk i BEFORE chunk i+1's size is computed in
        # both modes.  With VM_SEARCH_WORKERS=1 there is no prefetch.
        pool = workpool.POOL
        pending = None
        try:
            k = max(int(max_chunk_samples // est), 64)
            cols = fetch(i, k)
            while True:
                # limit counts series WITH DATA in range (cumulative),
                # matching search_columns' post-collection semantics
                seen += cols.n_series
                if max_series is not None and seen > max_series:
                    raise ResourceWarning(
                        f"query matches more than {max_series} series")
                if cols.n_series:
                    est = max(cols.n_samples // cols.n_series, 1)
                i += k
                if i >= S:
                    yield cols
                    return
                k = max(int(max_chunk_samples // est), 64)
                if pool.parallel_enabled():
                    from functools import partial
                    pending = pool.submit(partial(fetch, i, k))
                    yield cols
                    cols, pending = pending.result(), None
                else:
                    yield cols
                    cols = fetch(i, k)
        except GeneratorExit:
            # consumer abandoned the generator: drain the in-flight
            # prefetch so no background fetch outlives the query (it may
            # race a storage close)
            if pending is not None:
                try:
                    pending.result()
                except BaseException:  # vmt: disable=VMT003 — the query
                    pass               # was abandoned; its error has no
                #                        consumer and must not mask the
                #                        GeneratorExit being re-raised
            raise

    #: eval threads the query deadline down (see ClusterStorage): an
    #: expired budget aborts the scan/fetch mid-flight with the typed
    #: DeadlineExceededError instead of completing for a dead caller
    supports_search_deadline = True
    #: eval may pass ``ds=(agg_column, max_resolution_ms)`` to opt a
    #: fetch into downsampled tiers (storage/downsample.py); absent on
    #: ClusterStorage, so the hint never crosses the RPC untranslated
    supports_downsample_read = True

    @property
    def downsample_active(self) -> bool:
        return bool(self.downsample_tiers)

    def search_columns(self, filters: list[TagFilter], min_ts: int,
                       max_ts: int, dedup_interval_ms: int | None = None,
                       max_series: int | None = None, tenant=(0, 0),
                       _tsids=None, deadline: float = 0.0, ds=None):
        """Batched columnar search: one native decode pass per part, one
        vectorized assembly into padded (S, N) columns — no per-series
        Python on the fetch path (the netstorage.go:374-421 unpack-worker
        role, done as array passes). Returns a ColumnarSeries with rows
        ordered by raw metric name (same order as search_series).

        ``deadline`` (time.monotonic cutoff, 0 = none) is the storage-
        side half of deadline propagation: the budget is checked every
        N series during the index scan and once per fetch unit, and an
        expired query raises :class:`DeadlineExceededError` (counted in
        ``vm_storage_deadline_aborts_total``) instead of burning the
        dead query's full server-side cost."""
        from .columnar import ColumnarSeries, assemble
        interval = (self.dedup_interval_ms if dedup_interval_ms is None
                    else dedup_interval_ms)
        budget = (_ScanBudget(deadline, on_abort=_DEADLINE_ABORTS.inc)
                  if deadline else None)
        # per-tenant QoS admission: a tenant at its VM_TENANT_QUOTAS cap
        # queues (and sheds) against itself instead of starving others
        with workpool.SEARCH_GATE.admit(tenant):
            # chaos seam, INSIDE the admission slot: an injected delay
            # occupies real gate capacity, which is how the chaos suite
            # saturates one tenant's quota without touching another's
            if faultinject.active():
                faultinject.fire(
                    f"storage:search:{tenant[0]}:{tenant[1]}")
            return self._search_columns_gated(
                filters, min_ts, max_ts, interval, max_series, tenant,
                _tsids, ColumnarSeries, assemble, budget, ds)

    def _resolve_ordered_names(self, uniq: np.ndarray):
        """Raw-name resolution + canonical (raw-sorted) row order for a
        fetched metric-id set: (have, kept, rank, ordered_mids,
        raws_in_row_order, names_in_row_order).  Memoized on the id set +
        structural version (metric id -> name is immutable; deletes and
        retention bump structural_version), LRU-bounded — the
        suffix-aware fetch's answer to per-refresh O(S) resolution."""
        from .. import native as _native
        key = (_native.xxh64(np.ascontiguousarray(uniq)),
               int(uniq.size), self.structural_version)
        with self._name_memo_lock:
            got = self._name_memo.get(key)
            if got is not None:
                self._name_memo.move_to_end(key)
                return got
        names = self.idb.get_metric_names_by_ids([int(m) for m in uniq])
        have = np.array([int(m) in names for m in uniq], bool)
        kept = uniq[have]
        raws = [names[int(m)][1] for m in kept]
        if len(raws) > 1:
            # fixed-width bytes argsort (C memcmp) instead of a Python-object
            # compare per element; numpy's S dtype strips trailing NULs, so
            # names ending in \0 (never produced by MetricName.marshal, but
            # cheap to guard) take the object path
            if any(r[-1:] == b"\x00" for r in raws):
                arr = np.array(raws, dtype=object)
            else:
                arr = np.array(raws)
            perm = np.argsort(arr, kind="stable")
        else:
            perm = np.arange(len(raws), dtype=np.int64)
        ordered_mids = kept[perm]
        # rank[j] = final row of kept[j]
        rank = np.empty(perm.size, np.int64)
        rank[perm] = np.arange(perm.size)
        raws_final = [raws[i] for i in perm]
        names_final = [names[int(m)][0] for m in ordered_mids]
        val = (have, kept, rank, ordered_mids, raws_final, names_final)
        with self._name_memo_lock:
            self._name_memo[key] = val
            while len(self._name_memo) > 64:
                self._name_memo.popitem(last=False)
        return val

    def _search_columns_gated(self, filters, min_ts, max_ts, interval,
                              max_series, tenant, _tsids, ColumnarSeries,
                              assemble, budget=None, ds=None):
        t_ph = time.perf_counter()
        costacc.restamp()  # start of this thread's phase-lap chain
        if budget is not None:
            budget.check()  # gate queue wait burned the budget already?
        tsids = (self._search_tsids_union(
                     filters, min_ts, max_ts, tenant,
                     check=budget.tick if budget is not None else None,
                     scan_check=budget.check if budget is not None
                     else None)
                 if _tsids is None else _tsids)
        t_ph = _phase_lap("index_search", t_ph)
        empty = ColumnarSeries.empty()
        if not tsids:
            return empty
        tsid_set = {t.metric_id for t in tsids}
        # downsampled-tier serving: a note dict both ENABLES per-
        # partition tier selection and reports back what was chosen;
        # VM_DOWNSAMPLE_READ=0 (the raw-oracle escape hatch) keeps every
        # fetch raw-only, fallback included
        note = None
        if self.downsample_tiers:
            from . import downsample as _dsmod
            if _dsmod.read_enabled():
                note = {}
            else:
                ds = None
        else:
            ds = None
        # the fused native read kernel (vm_assemble_part) merges the
        # collect+decode+clip stages into one GIL-released call per part
        # and hands back float pieces; VM_NATIVE_ASSEMBLE=0 (or a missing
        # native library) runs the split Python-orchestrated path — the
        # correctness oracle the equality tests diff against
        from .. import native as _native
        fused = _native.assemble_enabled()
        pieces = self.table.collect_columns(
            tsid_set, min_ts, max_ts,
            tsid_lo=tsids[0].sort_key(), tsid_hi=tsids[-1].sort_key(),
            as_float=fused,
            check=budget.check if budget is not None else None,
            ds=ds, note=note)
        t_ph = _phase_lap("assemble_native" if fused else "collect", t_ph)
        if note:
            if note.get("partial_res"):
                # per-request flag, surfaced as partialResolution in the
                # HTTP response metadata (reset_partial clears it).
                # Benign race: sticky advisory boolean — concurrent
                # writers all store True, readers only consume it after
                # their own search returned, and a lost reset merely
                # over-reports partial resolution (never under-reports).
                self._partial_res_flag = True  # vmt: disable=VMT015
        if budget is not None:
            budget.check()  # before the decode/assembly tail
        if not pieces:
            self._note_to_cols(empty, note)
            return empty
        if fused:
            if len(pieces) == 1:
                mids, cnts, ts_all, vals_f = pieces[0]
                piece_ids = None  # one piece: every block shares provenance
            else:
                mids = np.concatenate([p[0] for p in pieces])
                cnts = np.concatenate([p[1] for p in pieces])
                ts_all = np.concatenate([p[2] for p in pieces])
                vals_f = np.concatenate([p[3] for p in pieces])
                piece_ids = np.repeat(np.arange(len(pieces)),
                                      [p[0].size for p in pieces])
        else:
            if len(pieces) == 1:
                mids, cnts, scales, ts_all, mant_all = pieces[0]
                piece_ids = None  # one piece: every block shares provenance
            else:
                mids = np.concatenate([p[0] for p in pieces])
                cnts = np.concatenate([p[1] for p in pieces])
                scales = np.concatenate([p[2] for p in pieces])
                ts_all = np.concatenate([p[3] for p in pieces])
                mant_all = np.concatenate([p[4] for p in pieces])
                piece_ids = np.repeat(np.arange(len(pieces)),
                                      [p[0].size for p in pieces])
            # mantissas -> float64 with per-block exponents, one native pass
            vals_f = np.empty(mant_all.size, np.float64)
            goff = np.empty(cnts.size + 1, np.int64)
            goff[0] = 0
            np.cumsum(cnts, out=goff[1:])
            if _native.available():
                _native.decimal_to_float_blocks(
                    np.ascontiguousarray(mant_all), goff, scales, vals_f)
            else:
                # one sort-by-scale pass, split across the work pool (every
                # task writes a disjoint out region: bit-identical results)
                from ..ops import decimal as dec_ops
                dec_ops.decimal_to_float_blocks_py(mant_all, goff, scales,
                                                   vals_f, pool=workpool.POOL)
            t_ph = _phase_lap("decode", t_ph)
        # cost accounting: the raw column bytes this fetch pulled out of
        # parts (timestamps + decoded values) — the "bytesRead" column
        # of top_queries/usage
        costacc.add_part_bytes(int(ts_all.nbytes) + int(vals_f.nbytes))
        # resolve names FIRST and bake the canonical raw-name row order into
        # the assembly scatter (no post-assembly reorder pass); memoized
        # on the fetched id set — a rolling refresh's per-step cost stays
        # O(new samples), not O(S) name lookups + argsort
        uniq = np.unique(mids)
        if max_series is not None and uniq.size > max_series:
            raise ResourceWarning(
                f"query matches {uniq.size} series, limit {max_series}")
        have, kept, rank, ordered_mids, raws_final, names_final = \
            self._resolve_ordered_names(uniq)
        # per-block target row; blocks of name-less series are dropped
        pos_in_uniq = np.searchsorted(uniq, mids)
        if not have.all():
            bkeep = have[pos_in_uniq]
            if not bkeep.all():
                sample_keep = np.repeat(bkeep, cnts)
                mids, cnts = mids[bkeep], cnts[bkeep]
                ts_all = ts_all[sample_keep]
                vals_f = vals_f[sample_keep]
                if piece_ids is not None:
                    piece_ids = piece_ids[bkeep]
            pos_in_kept = np.searchsorted(kept, mids)
        else:
            pos_in_kept = pos_in_uniq
        block_rows = rank[pos_in_kept]
        # coalesce adjacent same-series blocks within one piece: a part's
        # blocks are (tsid, min_ts)-sorted, so a series' span-capped blocks
        # concatenate in time order — assemble then sees one block per
        # (series, part) and its uniform-grid reshape fast path survives
        # the block-span cap (never across pieces: cross-part rows overlap
        # in time and must keep the per-row sort fix)
        K = int(block_rows.size)
        if K > 1:
            same = block_rows[1:] == block_rows[:-1]
            if piece_ids is not None:
                same &= piece_ids[1:] == piece_ids[:-1]
            if bool(same.any()):
                # Coalescing disables assemble()'s per-row disorder sort
                # for the merged rows, so VERIFY the invariant it rests on
                # (intra-part blocks of one tsid are time-ordered and
                # non-overlapping): last ts of block j must not exceed
                # first ts of block j+1 across every merged boundary.
                # O(#boundaries) gather; on violation keep blocks separate
                # and let the sort fix handle them.
                ends = np.cumsum(cnts)
                j = np.flatnonzero(same)
                pos = ends[j]
                same[j[ts_all[pos - 1] > ts_all[pos]]] = False
            if bool(same.any()):
                starts_blk = np.empty(K, bool)
                starts_blk[0] = True
                np.logical_not(same, out=starts_blk[1:])
                seg = np.cumsum(starts_blk) - 1
                cnts = np.bincount(seg, weights=cnts).astype(np.int64)
                block_rows = block_rows[starts_blk]
        cols = assemble(block_rows, int(kept.size), cnts, ts_all, vals_f,
                        min_ts, max_ts, interval, metric_ids=ordered_mids)
        if cols.dropped_rows is not None:
            live = np.delete(np.arange(ordered_mids.size),
                             cols.dropped_rows)
            cols.raw_names = [raws_final[i] for i in live]
            cols.metric_names = [names_final[i] for i in live]
        else:
            # fresh list objects: the memoized products must never alias
            # a caller-mutable ColumnarSeries field
            cols.raw_names = list(raws_final)
            cols.metric_names = list(names_final)
        cols.compute_stale_rows()
        self._note_to_cols(cols, note)
        if cols.metric_names:
            self.track_name_usage(
                {mn.metric_group for mn in cols.metric_names})
        _phase_lap("assemble", t_ph)
        return cols

    @staticmethod
    def _note_to_cols(cols, note) -> None:
        """Stamp the tier-selection outcome onto the result (eval keys
        its cache and the avg/count rewrites off these)."""
        if note:
            cols.ds_res = int(note.get("ds_res", 0))
            cols.partial_res = bool(note.get("partial_res", False))

    def search_series(self, filters: list[TagFilter], min_ts: int,
                      max_ts: int, dedup_interval_ms: int | None = None,
                      max_series: int | None = None,
                      tenant=(0, 0),
                      deadline: float = 0.0) -> list[SeriesData]:
        """Decoded per-series rows, cross-part merged, deduped, clipped —
        thin per-series view over search_columns."""
        cols = self.search_columns(filters, min_ts, max_ts,
                                   dedup_interval_ms, max_series, tenant,
                                   deadline=deadline)
        return cols.to_series_list()

    def _search_series_blocks(self, filters: list[TagFilter], min_ts: int,
                              max_ts: int,
                              dedup_interval_ms: int | None = None,
                              max_series: int | None = None,
                              tenant=(0, 0)) -> list[SeriesData]:
        """Per-block reference implementation (kept as the differential
        oracle for the columnar path; tests compare both)."""
        from ..ops import decimal as dec_ops
        interval = (self.dedup_interval_ms if dedup_interval_ms is None
                    else dedup_interval_ms)
        per_mid: dict[int, list] = {}
        for blk in self.iter_series_blocks(filters, min_ts, max_ts, tenant):
            per_mid.setdefault(blk.tsid.metric_id, []).append(blk)
        if max_series is not None and len(per_mid) > max_series:
            raise ResourceWarning(
                f"query matches {len(per_mid)} series, limit {max_series}")
        names = self.idb.get_metric_names_by_ids(per_mid.keys())
        out = []
        for mid, blocks in per_mid.items():
            got = names.get(mid)
            if got is None:
                continue
            mn, raw = got
            if len(blocks) == 1:
                # fast path: one block is already time-sorted
                b = blocks[0]
                ts, vals = b.timestamps, b.float_values()
                if ts[0] < min_ts or ts[-1] > max_ts:
                    lo = np.searchsorted(ts, min_ts, side="left")
                    hi = np.searchsorted(ts, max_ts, side="right")
                    ts, vals = ts[lo:hi], vals[lo:hi]
            else:
                ts = np.concatenate([b.timestamps for b in blocks])
                vals = np.concatenate([b.float_values() for b in blocks])
                order = np.argsort(ts, kind="stable")
                ts, vals = ts[order], vals[order]
                keep = (ts >= min_ts) & (ts <= max_ts)
                ts, vals = ts[keep], vals[keep]
            if ts.size == 0:
                continue
            if interval > 0:
                ts, vals = deduplicate(ts, vals, interval)
            # collapse exact-duplicate timestamps (replica merges)
            if ts.size > 1:
                dup = np.concatenate([ts[1:] == ts[:-1], [False]])
                if dup.any():
                    ts, vals = ts[~dup], vals[~dup]
            out.append((raw, SeriesData(mn, ts, vals, raw,
                                        stale_blocks=blocks)))
        out.sort(key=lambda rs: rs[0])
        return [sd for _, sd in out]

    # -- integrity / partial-result surface ------------------------------

    def quarantine_report(self) -> list[dict]:
        """Every part moved aside by the open-time integrity check,
        across all three stores (data partitions, the global mergeset,
        indexdb month tables) — the /api/v1/status/quarantine payload."""
        return self.table.quarantined() + self.idb.quarantined()

    @property
    def last_partial(self) -> bool:
        """A store that quarantined anything serves LOUDLY partial:
        every result carries isPartial=True until the operator restores
        or discards the quarantined parts (the opposite of the old
        silent-drop behavior).  Cached at open — quarantine only happens
        at open time (partitions/tables created later start empty), and
        this property sits on the serving hot path (meta frames, eval
        partial capture, result-cache puts)."""
        return self._has_quarantine

    @property
    def last_partial_resolution(self) -> bool:
        """A fetch since the last reset_partial() fell back to a coarser
        tier than the query's effective step allows (raw dropped by
        retention, no satisfying tier) — the response carries
        ``partialResolution: true`` so degraded data is never silent."""
        return self._partial_res_flag

    def reset_partial(self) -> None:
        """Per-request reset hook (ClusterStorage protocol): quarantine
        partiality is persistent state (nothing to clear), but the
        partial-RESOLUTION flag is per-request."""
        self._partial_res_flag = False

    def label_names(self, min_ts=None, max_ts=None,
                    tenant=(0, 0)) -> list[str]:
        return self.idb.label_names(min_ts, max_ts, tenant)

    def label_values(self, key: str, min_ts=None, max_ts=None,
                     tenant=(0, 0)) -> list[str]:
        return self.idb.label_values(key, min_ts, max_ts, tenant)

    def tag_value_suffixes(self, tag_key: str, tag_value_prefix: str,
                           delimiter: str = ".", max_suffixes: int = 100_000,
                           min_ts=None, max_ts=None,
                           tenant=(0, 0)) -> list[str]:
        """Graphite path expansion (GetTagValueSuffixes,
        lib/storage/index_db.go): distinct suffixes of `tag_key` values
        that start with `tag_value_prefix`, cut AFTER the next delimiter
        (suffix keeps the trailing delimiter, marking a non-leaf)."""
        key = "__name__" if tag_key in ("", "__name__") else tag_key
        vals = self.idb.label_values(key, min_ts, max_ts, tenant)
        plen = len(tag_value_prefix)
        out: set[str] = set()
        for v in vals:
            if not v.startswith(tag_value_prefix):
                continue
            rest = v[plen:]
            i = rest.find(delimiter)
            out.add(rest if i < 0 else rest[:i + 1])
            if len(out) >= max_suffixes:
                break
        return sorted(out)

    # -- metric-name usage stats (lib/storage/metricnamestats) -----------

    _MAX_NAME_USAGE = 100_000

    def track_name_usage(self, metric_groups) -> None:
        """Record a query hit for each distinct metric name (called by
        the search paths; drives /api/v1/status/metric_names_stats and
        the metricNamesUsageStats RPC)."""
        now = fasttime.unix_timestamp()
        with self._lock:
            # under _lock: the stats/RPC readers iterate this dict, and
            # a concurrent insert mid-iteration raises RuntimeError
            nu = self._name_usage
            for g in metric_groups:
                e = nu.get(g)
                if e is None:
                    if len(nu) >= self._MAX_NAME_USAGE:
                        continue
                    e = nu[g] = [0, 0]
                e[0] += 1
                e[1] = now

    def metric_names_usage_stats(self, limit: int = 1000,
                                 le: int | None = None) -> list[dict]:
        with self._lock:
            items = [{"metricName": (g.decode("utf-8", "replace")
                                     if isinstance(g, bytes) else g),
                      "requestsCount": c, "lastRequestTimestamp": t}
                     for g, (c, t) in self._name_usage.items()]
        if le is not None:
            items = [x for x in items if x["requestsCount"] <= le]
        items.sort(key=lambda x: x["requestsCount"])
        return items[:limit]

    def reset_metric_names_stats(self) -> None:
        with self._lock:
            self._name_usage.clear()

    # -- metric metadata (TYPE/HELP; /api/v1/metadata storage side) ------

    def set_metadata(self, metadata: dict) -> None:
        """Merge parsed # TYPE / # HELP exposition metadata."""
        with self._lock:
            # under _lock: search_metadata iterates this dict, and a
            # concurrent merge mid-iteration raises RuntimeError
            if len(self.metadata) < 100_000:
                self.metadata.update(metadata)

    def search_metadata(self, limit: int = 1000,
                        metric: str = "") -> dict:
        with self._lock:
            if metric:
                md = self.metadata.get(metric)
                return {metric: md} if md else {}
            out = {}
            for name, md in self.metadata.items():
                if len(out) >= limit:
                    break
                out[name] = md
            return out

    def series_count(self, tenant=(0, 0)) -> int:
        return int(self.idb._all_metric_ids(tenant).size)

    def tenants(self) -> list[tuple[int, int]]:
        return self.idb.tenants()

    def tsdb_status(self, date: int | None = None, topn: int = 10,
                    tenant=(0, 0), filters=None,
                    focus_label: str = "") -> dict:
        """Cardinality explorer data (GetTSDBStatus, index_db.go:1284).
        `filters` (match[] selectors) restrict the series set — the
        explorer's drill-down; `focus_label` adds a per-value breakdown of
        that label (focusLabel)."""
        by_metric: dict[bytes, int] = {}
        by_label: dict[bytes, int] = {}
        by_pair: dict[bytes, int] = {}
        by_focus: dict[bytes, int] = {}
        values_per_label: dict[bytes, set] = {}
        fl = focus_label.encode()
        if filters:
            mids = self.idb.search_metric_ids(filters, tenant=tenant)
            if date is not None:
                day = self.idb._metric_ids_for_date(date, tenant)
                mids = np.intersect1d(mids, day, assume_unique=True)
        else:
            mids = (self.idb._metric_ids_for_date(date, tenant)
                    if date is not None
                    else self.idb._all_metric_ids(tenant))
        for mid in mids:
            mn = self.idb.get_metric_name_by_id(int(mid))
            if mn is None:
                continue
            by_metric[mn.metric_group] = by_metric.get(mn.metric_group, 0) + 1
            for k, v in mn.labels:
                by_label[k] = by_label.get(k, 0) + 1
                pair = k + b"=" + v
                by_pair[pair] = by_pair.get(pair, 0) + 1
                values_per_label.setdefault(k, set()).add(v)
                if fl and k == fl:
                    by_focus[v] = by_focus.get(v, 0) + 1

        def top(d):
            return [{"name": k.decode("utf-8", "replace"), "count": c}
                    for k, c in sorted(d.items(), key=lambda kv: -kv[1])[:topn]]

        out = {
            "totalSeries": int(mids.size),
            "seriesCountByMetricName": top(by_metric),
            "seriesCountByLabelName": top(by_label),
            "seriesCountByLabelValuePair": top(by_pair),
            "labelValueCountByLabelName": top(
                {k: len(v) for k, v in values_per_label.items()}),
        }
        if fl:
            out["seriesCountByFocusLabelValue"] = top(by_focus)
        return out

    # -- deletes -----------------------------------------------------------

    def delete_series(self, filters: list[TagFilter], tenant=(0, 0)) -> int:
        """Tombstone matching series (DeleteSeries, storage.go:1345). Data
        blocks are dropped at the next merge."""
        mids = self.idb.search_metric_ids(filters, tenant=tenant)
        if mids.size:
            self.idb.delete_series_by_ids(mids)
            dead = set(int(m) for m in mids)
            with self._lock:
                self._tsid_cache = {
                    k: t for k, t in self._tsid_cache.items()
                    if t.metric_id not in dead}
            # the raw-label cache would resurrect tombstoned metric_ids
            self._tsid_cache_raw.filter(
                lambda k, t: t.metric_id not in dead)
            # AFTER the tombstones land: a racing query that fetched the
            # old data keys its tile under the pre-delete version
            with self._lock:
                self.data_version += 1
                # monotonic version, bumped under _lock; cache keying
                # reads a lock-free int snapshot — a stale read keys a
                # tile one version back, which the ratchet re-checks
                self.structural_version += 1  # vmt: disable=VMT015
        return int(mids.size)

    # -- live resharding (part migration + ring-ownership exemptions) ------

    #: this backend holds ring-placed data, so it honors (and acks) the
    #: ring-ownership read filter shipped by vmselects — a multilevel
    #: ClusterStorage backend does not (see parallel/ringfilter)
    supports_ring_filter = True

    @property
    def ring_exempt_names(self) -> set[bytes]:
        """Canonical marshals exempt from ring-ownership filtering.
        Append-only for the process lifetime — handlers may read it
        without the lock."""
        return self._ring_exempt

    def _ring_exempt_path(self) -> str:
        return os.path.join(self.path, "ring_exempt.bin")

    def _load_ring_exempt(self) -> None:
        from ..ops.varint import unmarshal_varuint64
        try:
            with open(self._ring_exempt_path(), "rb") as f:
                data = f.read()
        except OSError:
            return
        off = 0
        try:
            while off < len(data):
                n, off = unmarshal_varuint64(data, off)
                if off + n > len(data):
                    break  # torn tail append: keep the complete prefix
                self._ring_exempt.add(data[off:off + n])
                off += n
        except (ValueError, IndexError):
            pass  # torn record: the loaded prefix still serves

    def add_ring_exempt_names(self, raws) -> int:
        """Mark canonical metric-name marshals as always-served (write
        reroutes, adopted parts).  Returns how many were new."""
        from ..ops.varint import marshal_varuint64
        with self._ring_exempt_lock:
            fresh = [r for r in raws if r not in self._ring_exempt]
            if not fresh:
                return 0
            # the durable append IS the critical section: the in-memory
            # publish must be ordered after it, and concurrent appends
            # to one file must serialize (reroutes/adoptions are rare —
            # never a hot path)
            with open(self._ring_exempt_path(),  # vmt: disable=VMT004
                      "ab") as f:
                for r in fresh:
                    f.write(marshal_varuint64(len(r)) + r)
                f.flush()
                os.fsync(f.fileno())
            # publish AFTER the durable append: a crash between the two
            # re-derives the entries from the next reroute/adoption
            self._ring_exempt.update(fresh)
        return len(fresh)

    def _adopted_watermark_path(self) -> str:
        return os.path.join(self.path, "adopted_mid.json")

    def _load_adopted_watermark(self) -> None:
        import json as _json
        try:
            with open(self._adopted_watermark_path()) as f:
                self._mid_gen.reserve_past(int(_json.load(f)["max"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass  # no adoptions yet (or torn write: adoption re-writes)

    def _persist_adopted_watermark(self, max_id: int) -> None:
        """Durably record the highest adopted foreign metric_id (only
        ratchets upward) so reserve_past survives restarts."""
        import json as _json

        # rare path (one write per adoption batch); the file I/O IS the
        # critical section — the ratchet check and the durable replace
        # must not interleave between concurrent adoptions
        with self._ring_exempt_lock:
            try:
                with open(  # vmt: disable=VMT004 — see above
                        self._adopted_watermark_path()) as f:
                    if int(_json.load(f)["max"]) >= max_id:
                        return
            except (OSError, ValueError, KeyError, TypeError):
                pass
            from ..utils import fs as fslib
            tmp = self._adopted_watermark_path() + ".tmp"
            with open(tmp, "w") as f:  # vmt: disable=VMT004 — see above
                _json.dump({"max": int(max_id)}, f)
                f.flush()
                os.fsync(f.fileno())
            fslib.rename_durable(tmp, self._adopted_watermark_path())

    def list_file_parts(self) -> list[dict]:
        """Migration inventory: every finalized part across partitions."""
        return self.table.list_file_parts()

    def export_part(self, partition: str, part: str):
        """One finalized part as transferable state: (files as
        [(name, bytes)], series registrations as [(tsid_marshal,
        name_marshal)], meta dict).  Raises KeyError when the part was
        merged away since listing (callers re-list and retry)."""
        pt = self.table.partition_by_name(partition)
        p = pt.get_file_part(part) if pt is not None else None
        if p is None:
            raise KeyError(f"part {partition}/{part} not found "
                           f"(merged away since listing?)")
        files = []
        for fname in sorted(os.listdir(p.path)):
            with open(os.path.join(p.path, fname), "rb") as f:
                files.append((fname, f.read()))
        entries = []
        for t in p.unique_tsids():
            got = self.idb.get_metric_name_raw_by_id(t.metric_id)
            if got is not None:
                entries.append((t.marshal(), got[1]))
        meta = {"partition": partition, "part": part, "rows": int(p.rows),
                "bytes": p.file_bytes(), "min_ts": int(p.min_ts),
                "max_ts": int(p.max_ts)}
        return files, entries, meta

    def adopt_series(self, entries, min_ts=None, max_ts=None) -> int:
        """Register series shipped alongside a migrated part UNDER THEIR
        FOREIGN metric_ids (ids are node-local counters, so the part's
        blocks are unreadable without this).  A colliding id bound to a
        DIFFERENT name rejects the whole adoption — the driver leaves
        the part on its source node.  Per-day indexes are registered for
        every day of the part's span (over-inclusive is harmless: the
        per-day index is a pruning filter, and a part spans at most its
        monthly partition)."""
        from .index_db import MS_PER_DAY
        fresh = []
        for tsid_b, raw in entries:
            t = TSID.unmarshal(tsid_b)
            got = self.idb.get_metric_name_raw_by_id(t.metric_id)
            if got is not None:
                if got[1] != raw:
                    raise ValueError(
                        f"metric_id collision adopting series: id "
                        f"{t.metric_id} is already bound to another name")
                continue
            self._mid_gen.reserve_past(t.metric_id)
            fresh.append((MetricName.unmarshal(raw), t))
        if fresh:
            # durable BEFORE the index registrations land: a restart
            # must never re-generate into the adopted id range
            self._persist_adopted_watermark(
                max(t.metric_id for _, t in fresh))
        for mn, t in fresh:
            self.idb.create_indexes_for_metric(mn, t)
        if min_ts is not None and max_ts is not None:
            days = range(int(min_ts) // MS_PER_DAY,
                         int(max_ts) // MS_PER_DAY + 1)
            for mn, t in fresh:
                for d in days:
                    self.idb.create_per_day_indexes(mn, t, d)
        return len(fresh)

    def adopt_part(self, partition: str, files, entries,
                   min_ts=None, max_ts=None) -> tuple[int, int]:
        """Adopt one migrated part.  Ordering: STAGE + crc-verify the
        bytes first (a torn transfer must be rejected before any other
        state lands — index registrations are not rolled back), then
        register the series (reads of the adopted blocks must resolve
        the moment the part is published), then durably publish and
        exempt the series from ring filtering (this node may now hold
        their only copy).  The heavy write runs under the MergeGate so
        adoption yields to in-flight serving.  Returns (rows, bytes)."""
        pt = self.table.partition_by_name(partition, create=True)
        if pt is None:
            raise ValueError(f"bad partition name {partition!r}")
        with workpool.MERGE_GATE:
            staged = pt.stage_part(files)
            try:
                self.adopt_series(entries, min_ts, max_ts)
            except BaseException:
                pt.discard_staged(staged)
                raise
            p = pt.publish_staged(staged)
        self.add_ring_exempt_names([raw for _, raw in entries])
        oldest = int(p.min_ts)
        with self._lock:
            self.rows_added += int(p.rows)
            self.data_version += 1
            log = self._append_log
            if log.maxlen is not None and len(log) == log.maxlen:
                self._append_log_floor = log[0][0]
            # adopted parts carry OLD timestamps: record the append like
            # a backfill so rolling device tiles rebuild instead of
            # serving a stale suffix
            log.append((self.data_version, oldest))
        return int(p.rows), p.file_bytes()

    def remove_parts(self, partition: str, names: list[str]) -> int:
        """Source side of a part migration: delist + delete after the
        receiver's durable ack."""
        pt = self.table.partition_by_name(partition)
        if pt is None:
            return 0
        n = pt.remove_parts(names)
        if n:
            with self._lock:
                self.data_version += 1
                self.structural_version += 1  # visible data moved away
        return n

    # -- maintenance -------------------------------------------------------

    def force_flush(self):
        self.table.flush_to_disk()
        self.idb.flush()

    def force_merge(self):
        self.table.force_merge(self.idb.deleted_metric_ids,
                               self.min_valid_ts)

    @property
    def min_valid_ts(self) -> int:
        return fasttime.unix_ms() - self.retention_ms

    def tier_deadlines(self, now_ms: int | None = None) -> list:
        """``[(resolution_ms, tier_min_valid_ts_or_None)]`` for the
        configured tiers (None = that tier keeps its data forever)."""
        now = fasttime.unix_ms() if now_ms is None else now_ms
        return [(t.resolution_ms,
                 (now - t.retention_ms) if t.retention_ms > 0 else None)
                for t in self.downsample_tiers]

    def enforce_retention(self, now_ms: int | None = None) -> int:
        now = fasttime.unix_ms() if now_ms is None else now_ms
        min_valid = now - self.retention_ms
        deadlines = self.tier_deadlines(now)
        n = self.table.enforce_retention(min_valid, deadlines)
        # the index (metric names, per-day entries) must outlive every
        # tier that still serves samples: months are dropped at the
        # OLDEST live deadline, and never while a tier keeps-forever
        idb_min = min_valid
        for _, d in deadlines:
            if d is None:
                idb_min = None
                break
            idb_min = min(idb_min, d)
        dropped_months = (self.idb.drop_months_before(idb_min)
                          if idb_min is not None else 0)
        n += dropped_months
        if dropped_months:
            # a later backfill into a dropped date must recreate its
            # per-day index entries
            min_date = idb_min // 86_400_000
            for shard in self._shards:
                with shard.lock:
                    dead = {dk for dk in shard.day_cache
                            if dk[1] < min_date}
                    shard.day_cache -= dead
        if n:
            with self._lock:
                # after the drop; no-op sweeps keep tiles
                self.data_version += 1
                self.structural_version += 1
        return n

    # -- snapshots ---------------------------------------------------------

    def snapshots_dir(self) -> str:
        return os.path.join(self.path, "snapshots")

    def create_snapshot(self) -> str:
        """Instant snapshot via hardlinks (MustCreateSnapshot,
        storage.go:411); name format YYYYMMDDhhmmss-seq."""
        name = time.strftime("%Y%m%d%H%M%S") + \
            f"-{fasttime.unix_ns() % 10000:04d}"
        dst = os.path.join(self.snapshots_dir(), name)
        self.table.snapshot_to(os.path.join(dst, "data"))
        # crashpoint: dying here leaves a half-built snapshot dir — the
        # live store is untouched (hardlinks only) and the partial
        # snapshot is inert, never auto-restored
        faultinject.fire("snapshot:mid")
        self.idb.table.create_snapshot_at(
            os.path.join(dst, "indexdb", "global"))
        for mname, t in self.idb.snapshot_month_tables():
            t.create_snapshot_at(os.path.join(dst, "indexdb", "months",
                                              mname))
        shutil.copy(os.path.join(self.path, "format.json"),
                    os.path.join(dst, "format.json"))
        logger.infof("storage: created snapshot %s", name)
        return name

    def list_snapshots(self) -> list[str]:
        d = self.snapshots_dir()
        if not os.path.isdir(d):
            return []
        return sorted(os.listdir(d))

    def delete_snapshot(self, name: str) -> bool:
        full = os.path.join(self.snapshots_dir(), name)
        if not os.path.isdir(full):
            return False
        shutil.rmtree(full)
        return True

    # -- metrics -----------------------------------------------------------

    def metrics(self) -> dict[str, float]:
        out = {
            "vm_rows_added_to_storage_total": self.rows_added,
            "vm_rows": self.table.rows,
            "vm_new_timeseries_created_total": self.new_series_created,
            "vm_slow_row_inserts_total": self.slow_row_inserts,
            "vm_timeseries_total": self.idb.all_series_count(),
            "vm_partitions": len(self.table.partition_names),
        }
        if self.downsample_tiers:
            by_res: dict[int, int] = {}
            with self.table._lock:
                parts = list(self.table._partitions.values())
            for p in parts:
                for st in p.tier_states():
                    by_res[st.resolution_ms] = \
                        by_res.get(st.resolution_ms, 0) + st.rows
            for res, rows in sorted(by_res.items()):
                out[f'vm_downsample_tier_rows{{resolution="{res}"}}'] = rows
        for lim in (self.hourly_limiter, self.daily_limiter):
            if lim is not None:
                out.update(lim.metrics())
        return out
