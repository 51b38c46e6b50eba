"""Cluster node APIs over RPC (reference lib/vminsertapi/api.go +
lib/vmselectapi/{api,server}.go + the cluster-branch netstorage semantics
documented in docs/victoriametrics/Cluster-VictoriaMetrics.md:851+).

- make_storage_handlers(storage): RPC method table served by vmstorage
  (both the insert-side writeRows_v1 and the select-side search_v1 family).
- StorageNodeClient: client half for one storage node.
- ClusterStorage: vminsert+vmselect composite backend — shards writes by
  consistent hash of the canonical metric name with replication and
  rerouting, fans reads out to every node and merges with partial-result
  tracking. Duck-compatible with storage.Storage for httpapi/query use.

The port's copy of ``victoriametrics_tpu/parallel/cluster_api.py``: the
same methods, wire fields and placement, so the port's nodes, routers
and query nodes interoperate with the reference's.  ``ClusterStorage``
offers no ``search_columns_chunked`` and no ``data_version``, as the
reference's does not: a cold query over the cluster takes the
evaluator's unchunked fetch, the CUDA engine keys its tiles by the
fetched content and files no rolling window, and a refresh served over
HTTP is the rollup result cache's partial hit, which fetches the new
steps' window from every node and decodes it again.  One difference:
the read fan-out's re-fan ships the nodes its first attempt marked down
as down (``_read_rings(also_down=...)``); the reference reads their
health again, and when a fan-out outlasts a node's 2 s down-mark it sees
the dead node healthy, re-fans with its shares suppressed and answers
partial although every series has a live replica.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..devtools.locktrace import make_lock
from ..storage.metric_name import MetricName
from ..storage.tag_filters import TagFilter
from ..utils import costacc, logger, querytracer
from ..utils import metrics as metricslib
from . import ringfilter
from .consistenthash import ConsistentHash
from .rpc import (HELLO_INSERT, HELLO_SELECT,  # noqa: F401 — re-exports
                  ClusterUnavailableError, PartialResultError, RPCClient,
                  RPCClientPool, RPCError, Reader, Writer)


def _json_payload(data: bytes, what: str):
    """Decode a JSON wire payload, converting a malformed peer's bytes
    into a typed RPCError (which round-trips both error boundaries)
    instead of a bare ValueError that would surface as an anonymous
    500 / unmarked error frame (VMT016)."""
    import json
    try:
        return json.loads(data)
    except ValueError as e:
        raise RPCError(f"bad {what} payload: {e}") from None

SERIES_PER_FRAME = 64

# fan-out failures whose data was provably still served by surviving
# replicas (RF coverage): NOT marked partial, counted here instead
_PARTIAL_AVOIDED = metricslib.REGISTRY.counter("vm_partial_avoided_total")
# live-resharding accounting (README "Elastic cluster serving"): parts
# adopted over migratePart_v1 (ticks on the receiving storage node AND
# on the driving router) and bytes moved by a join-rebalance/drain
_PARTS_MIGRATED = metricslib.REGISTRY.counter("vm_parts_migrated_total")
_REBALANCE_BYTES = metricslib.REGISTRY.counter(
    "vm_rebalance_moved_bytes_total")


# ---------------------------------------------------------------------------
# vmstorage-side handlers
# ---------------------------------------------------------------------------

def _read_filters(r: Reader) -> list[TagFilter]:
    n = r.u64()
    out = []
    for _ in range(n):
        key = r.bytes_()
        value = r.bytes_()
        flags = r.u64()
        out.append(TagFilter(key, value, negate=bool(flags & 1),
                             regex=bool(flags & 2)))
    return out


def _write_filters(w: Writer, filters: list[TagFilter]):
    w.u64(len(filters))
    for tf in filters:
        w.bytes_(tf.key)
        w.bytes_(tf.value)
        w.u64((1 if tf.negate else 0) | (2 if tf.regex else 0))


def _read_tenant(r: Reader) -> tuple:
    return (r.u64(), r.u64())


def _write_tenant(w: Writer, tenant) -> Writer:
    return w.u64(tenant[0]).u64(tenant[1])


def _split_filter_sets(filters):
    """Normalize a search's filters into (first_set, extra_sets): a
    plain list[TagFilter] has no extras; a selector-level `or` union
    (list of filter sets, see MetricExpr.or_sets) splits into the
    wire-legacy first set plus the trailing extras field."""
    if filters and isinstance(filters[0], (list, tuple)):
        sets = [list(fs) for fs in filters]
        return sets[0], sets[1:]
    return list(filters), []


def _legacy_meta() -> bool:
    """``VM_RPC_LEGACY_META=1`` makes this process speak the PRE-cost
    search_v1 dialect (no empty-trace slot, no extras frame, or_sets
    ignored) — the rolling-upgrade emulation knob the old<->new
    tolerance tests and canary drills use."""
    import os
    return os.environ.get("VM_RPC_LEGACY_META", "") == "1"


#: text series key -> canonical MetricName marshal, the ONE shard-
#: placement key both write paths and the ring-ownership read filter
#: agree on (a per-path key — text here, marshal there — would place
#: the same series on different nodes and break ownership filtering).
#: Pure function of the key bytes, so the memo is global and safe to
#: share across tenants/transforms.
_PLACEMENT_MEMO: dict[bytes, bytes] = {}
_PLACEMENT_LOCK = make_lock("parallel.cluster_api._PLACEMENT_MEMO")
_MAX_PLACEMENT_MEMO = 1 << 20


def placement_marshal(key: bytes) -> bytes:
    """Canonical marshal for a raw text series key; falls back to the
    raw bytes for keys that don't parse (the storage node drops those
    rows later anyway — consistent placement still holds)."""
    # racy-by-design fast path: a stale miss re-parses the key (pure
    # function), and the locked fill stores the identical marshaled name
    m = _PLACEMENT_MEMO.get(key)  # vmt: disable=VMT015
    if m is None:
        from ..ingest.parsers import labels_from_series_key
        try:
            m = MetricName.from_labels(labels_from_series_key(key)).marshal()
        except ValueError:
            m = key
        with _PLACEMENT_LOCK:
            if len(_PLACEMENT_MEMO) >= _MAX_PLACEMENT_MEMO:
                _PLACEMENT_MEMO.clear()
            _PLACEMENT_MEMO[key] = m
    return m


def make_storage_handlers(storage, rate_limiter=None) -> dict:
    """RPC dispatch table for a vmstorage node. `rate_limiter` applies
    -maxIngestionRate to RPC writes too (the multilevel/clusternative
    chaining path must honor the same ceiling as HTTP ingest)."""

    def h_write_rows(r: Reader):
        tenant = _read_tenant(r)
        n = r.u64()
        rows = []
        for _ in range(n):
            raw = r.bytes_()
            ts = r.i64()
            val = r.f64()
            rows.append((MetricName.unmarshal(raw), ts, val))
        # optional trailing reroute flag: these rows landed here because
        # an owner node was down — mark them always-served so the ring
        # read filter can never hide this (possibly only) copy
        exempt = bool(r.u64()) if r.remaining else False
        if rate_limiter is not None and rate_limiter.enabled():
            rate_limiter.register(len(rows), tenant)
        storage.add_rows(rows, tenant=tenant)
        if exempt and hasattr(storage, "add_ring_exempt_names"):
            # re-marshal is canonical, so this round-trips the wire raw
            # byte-for-byte; only the RARE reroute batch pays it
            storage.add_ring_exempt_names(
                {mn.marshal() for mn, _, _ in rows})
        return Writer().u64(len(rows))

    def h_write_rows_columnar(r: Reader):
        """writeRows_v2: ColumnarRows shipped raw — text series keys +
        ts/value columns. The storage node resolves whole batches through
        its native key map (no per-row Python unmarshal on either side;
        the reference's raw-row routing, lib/vminsertapi/api.go:15)."""
        tenant = _read_tenant(r)
        keybuf = r.bytes_()
        key_off = r.array()
        key_len = r.array()
        tss = r.array()
        vals = r.array()
        exempt = bool(r.u64()) if r.remaining else False
        if rate_limiter is not None and rate_limiter.enabled():
            rate_limiter.register(int(key_off.size), tenant)
        from .. import native
        cr = native.ColumnarRows(keybuf, key_off, key_len, tss, vals)
        if exempt and hasattr(storage, "add_ring_exempt_names"):
            mv = memoryview(keybuf)
            seen = set()
            for o, ln in zip(key_off, key_len):
                seen.add(bytes(mv[int(o):int(o) + int(ln)]))
            storage.add_ring_exempt_names(
                [placement_marshal(k) for k in seen])
        if getattr(storage, "add_rows_columnar", None) is not None:
            n = storage.add_rows_columnar(cr, tenant=tenant)
        else:  # storage without a columnar path: materialize rows
            from ..ingest.parsers import labels_from_series_key
            rows = []
            for k, ts, val in cr.to_rows():
                try:
                    rows.append((MetricName.from_labels(
                        labels_from_series_key(k)), ts, val))
                except ValueError:
                    continue
            n = storage.add_rows(rows, tenant=tenant)
        return Writer().u64(int(n))

    def h_is_readonly(r: Reader):
        return Writer().u64(1 if getattr(storage, "is_readonly", False) else 0)

    # sentinel "count" marking the trailing metadata frame of search_v1
    META_FRAME = (1 << 32) - 1

    def _read_trace_flag(r: Reader) -> bool:
        """Optional trailing trace-request flag (search_v1 extension).
        Old clients simply don't send it — Reader tolerance gives
        rolling-upgrade compat both ways."""
        return bool(r.u64()) if r.remaining else False

    def _read_deadline(r: Reader) -> float:
        """Optional trailing remaining-budget field (ms; second
        search_v1 extension, after the trace flag): converts to a local
        monotonic cutoff so this vmstorage aborts index scans and
        fetches mid-flight when the caller's budget expires, instead of
        burning a dead query's full cost.  Old clients don't send it
        (remaining==0 -> no deadline)."""
        budget_ms = r.u64() if r.remaining else 0
        if not budget_ms or not getattr(storage,
                                        "supports_search_deadline", False):
            return 0.0
        return time.monotonic() + budget_ms / 1e3

    def _read_or_sets(r: Reader) -> list:
        """Optional trailing OR'd-filter-set field (third search_v1
        extension, after the budget): a selector-level `or` union ships
        its first set in the legacy position and the remaining sets
        here.  Old clients don't send it; a legacy-dialect server
        (VM_RPC_LEGACY_META=1) ignores it — the client detects the
        missing union ack in the metadata frame and falls back to one
        legacy call per set."""
        if not r.remaining or _legacy_meta():
            return []
        n = r.u64()
        return [_read_filters(r) for _ in range(n)]

    def _union_filters(filters, or_sets):
        """(effective_filters, union_applied): apply the shipped extra
        sets when the storage can union them at the tsid level."""
        if not or_sets:
            return filters, True
        if getattr(storage, "supports_filter_union", False):
            return [filters] + or_sets, True
        # union-less duck-typed storage: serve the first set only and
        # DON'T ack — the client re-issues per-set legacy calls
        return filters, False

    def _read_ring(r: Reader):
        """Optional trailing ring-ownership field (fourth search_v1
        extension, after or_sets): the caller's consistent-hash view.
        Honored (and acked via the metadata frame) only by backends
        that actually hold ring-placed data — a multilevel vmselect's
        ClusterStorage ignores it and the caller's dedup keeps
        correctness (see parallel/ringfilter)."""
        if not r.remaining or _legacy_meta():
            return None
        ring_b = r.bytes_()
        if not getattr(storage, "supports_ring_filter", False):
            return None
        return ringfilter.intern_ring(ring_b)

    def _meta_frame(qt, cost=None, union_ok=True, ring_ok=False) -> Writer:
        """Trailing metadata frame: partial-result flag + the
        storage-side span tree (when tracing) + the extras dict (cost
        frame + filter-union ack).  Wire layout, Reader-tolerant both
        ways across versions:

        - old server: [partial u64] [trace bytes, only when tracing]
        - new server: [partial u64] [trace bytes, b"" when not tracing]
          [extras json bytes]

        An old CLIENT reading a new frame parses the trace slot (b""
        fails its json parse and is ignored by its existing malformed-
        trace guard) and never reads the extras.  A new client
        disambiguates by position: a second bytes field present means
        slot one was the (possibly empty) trace and slot two the
        extras; absent means an old server's trace-only frame."""
        import json
        meta = Writer().u64(META_FRAME)
        meta.u64(1 if getattr(storage, "last_partial", False) else 0)
        if qt.enabled:
            qt.donef("")
            meta.bytes_(json.dumps(qt.to_dict()).encode())
        elif not _legacy_meta():
            meta.bytes_(b"")  # empty trace slot pins the extras position
        if _legacy_meta():
            return meta
        extras = {"filterUnion": bool(union_ok)}
        if ring_ok:
            extras["ringFiltered"] = True
        if cost is not None:
            extras["cost"] = cost.remote_dict()
        meta.bytes_(json.dumps(extras).encode())
        return meta

    def h_search(r: Reader):
        tenant = _read_tenant(r)
        filters = _read_filters(r)
        min_ts, max_ts = r.i64(), r.i64()
        qt = querytracer.new(_read_trace_flag(r),
                             "vmstorage search_v1: %d filters, "
                             "timeRange=[%d..%d]", len(filters), min_ts,
                             max_ts)
        deadline = _read_deadline(r)
        or_sets = _read_or_sets(r)
        ring = _read_ring(r)
        filters, union_ok = _union_filters(filters, or_sets)
        if hasattr(storage, "reset_partial"):
            storage.reset_partial()
        # node-side cost accounting: every fetch seam under this search
        # reports into `cost`, shipped back in the metadata frame
        cost = costacc.CostTracker()
        prev_cost = costacc.set_current(cost)
        try:
            with qt.new_child("search_series") as sq:
                kw = {"deadline": deadline} if deadline else {}
                if getattr(storage, "supports_search_tracer", False):
                    # multilevel: a ClusterStorage backend grafts its
                    # per-node spans under this handler's span, so the
                    # caller's trace shows the WHOLE fan-out tree
                    kw["tracer"] = sq
                series = storage.search_series(filters, min_ts, max_ts,
                                               tenant=tenant, **kw)
                sq.donef("%d series", len(series))
            cost.add_samples(sum(sd.timestamps.size for sd in series))
            if ring is not None:
                keep, rerouted = ring.keep_mask(
                    tenant, [getattr(sd, "raw_name", None) or
                             sd.metric_name.marshal() for sd in series],
                    exempt=getattr(storage, "ring_exempt_names", None))
                series = [sd for sd, k in zip(series, keep) if k]
                if rerouted:
                    ringfilter.REROUTE_READS.inc()
        finally:
            costacc.set_current(prev_cost)
        costacc.record_usage(tenant, cost)

        def frames():
            for i in range(0, len(series), SERIES_PER_FRAME):
                w = Writer()
                chunk = series[i:i + SERIES_PER_FRAME]
                w.u64(len(chunk))
                for sd in chunk:
                    w.bytes_(sd.metric_name.marshal())
                    w.array(sd.timestamps)
                    w.array(sd.values)
                yield w
            yield _meta_frame(qt, cost, union_ok, ring_ok=ring is not None)
        return frames()

    def h_search_columns(r: Reader):
        """searchColumns_v1: the columnar read plane — per-frame batches
        of (raw names, counts, concatenated ts/value columns) instead of
        per-series decoded arrays. Cluster reads then feed the same
        columnar host path and device tile packer as single-node reads
        (the MetricBlock-streaming role, lib/vmselectapi/server.go:1010)."""
        tenant = _read_tenant(r)
        filters = _read_filters(r)
        min_ts, max_ts = r.i64(), r.i64()
        qt = querytracer.new(_read_trace_flag(r),
                             "vmstorage searchColumns_v1: %d filters, "
                             "timeRange=[%d..%d]", len(filters), min_ts,
                             max_ts)
        deadline = _read_deadline(r)
        or_sets = _read_or_sets(r)
        ring = _read_ring(r)
        filters, union_ok = _union_filters(filters, or_sets)
        if hasattr(storage, "reset_partial"):
            storage.reset_partial()
        cost = costacc.CostTracker()
        prev_cost = costacc.set_current(cost)
        try:
            if getattr(storage, "search_columns", None) is not None:
                with qt.new_child("search_columns") as sq:
                    kw = {"deadline": deadline} if deadline else {}
                    if getattr(storage, "supports_search_tracer", False):
                        kw["tracer"] = sq
                    cols = storage.search_columns(
                        filters, min_ts, max_ts, tenant=tenant, **kw)
                    sq.donef("%d series, %d samples", cols.n_series,
                             cols.n_samples)
                cost.add_samples(cols.n_samples)
                raw_names = cols.raw_names
                counts = cols.counts
                ts2, v2 = cols.ts, cols.vals
                if ring is not None and cols.n_series:
                    keep, rerouted = ring.keep_mask(
                        tenant, raw_names,
                        exempt=getattr(storage, "ring_exempt_names", None))
                    if not keep.all():
                        idx = np.flatnonzero(keep)
                        raw_names = [raw_names[i] for i in idx]
                        counts = counts[idx]
                        ts2, v2 = ts2[idx], v2[idx]
                    if rerouted:
                        ringfilter.REROUTE_READS.inc()
                S = len(raw_names)

                def series_arrays(a, b):
                    sel = np.arange(ts2.shape[1])[None, :] < \
                        counts[a:b, None]
                    return ts2[a:b][sel], v2[a:b][sel]
            else:  # per-series storage: adapt
                with qt.new_child("search_series (columnar adapt)") as sq:
                    series = storage.search_series(filters, min_ts, max_ts,
                                                   tenant=tenant)
                    sq.donef("%d series", len(series))
                cost.add_samples(sum(sd.timestamps.size for sd in series))
                raw_names = [getattr(sd, "raw_name", None) or
                             sd.metric_name.marshal() for sd in series]
                if ring is not None and series:
                    keep, rerouted = ring.keep_mask(
                        tenant, raw_names,
                        exempt=getattr(storage, "ring_exempt_names", None))
                    series = [sd for sd, k in zip(series, keep) if k]
                    raw_names = [nm for nm, k in zip(raw_names, keep) if k]
                    if rerouted:
                        ringfilter.REROUTE_READS.inc()
                counts = np.fromiter((sd.timestamps.size for sd in series),
                                     np.int64, len(series))
                S = len(series)

                def series_arrays(a, b):
                    ts_cat = (np.concatenate(
                        [sd.timestamps for sd in series[a:b]])
                        if b > a else np.zeros(0, np.int64))
                    v_cat = (np.concatenate(
                        [sd.values for sd in series[a:b]])
                        if b > a else np.zeros(0, np.float64))
                    return ts_cat, v_cat
        finally:
            costacc.set_current(prev_cost)
        costacc.record_usage(tenant, cost)

        def frames():
            for a in range(0, S, SERIES_PER_FRAME):
                b = min(a + SERIES_PER_FRAME, S)
                w = Writer()
                w.u64(b - a)
                names = raw_names[a:b]
                w.array(np.fromiter((len(nm) for nm in names), np.int64,
                                    b - a))
                w.bytes_(b"".join(names))
                w.array(np.asarray(counts[a:b], np.int64))
                ts_cat, v_cat = series_arrays(a, b)
                w.array(np.asarray(ts_cat, np.int64))
                w.array(np.asarray(v_cat, np.float64))
                yield w
            yield _meta_frame(qt, cost, union_ok, ring_ok=ring is not None)
        return frames()

    def h_search_metric_names(r: Reader):
        tenant = _read_tenant(r)
        filters = _read_filters(r)
        min_ts, max_ts = r.i64(), r.i64()
        names = storage.search_metric_names(filters, min_ts, max_ts,
                                            tenant=tenant)
        w = Writer().u64(len(names))
        for mn in names:
            w.bytes_(mn.marshal())
        return w

    def h_label_names(r: Reader):
        tenant = _read_tenant(r)
        min_ts, max_ts = r.i64(), r.i64()
        names = storage.label_names(min_ts or None, max_ts or None,
                                    tenant=tenant)
        w = Writer().u64(len(names))
        for n in names:
            w.str_(n)
        return w

    def h_label_values(r: Reader):
        tenant = _read_tenant(r)
        key = r.str_()
        min_ts, max_ts = r.i64(), r.i64()
        vals = storage.label_values(key, min_ts or None, max_ts or None,
                                    tenant=tenant)
        w = Writer().u64(len(vals))
        for v in vals:
            w.str_(v)
        return w

    def h_delete_series(r: Reader):
        tenant = _read_tenant(r)
        filters = _read_filters(r)
        return Writer().u64(storage.delete_series(filters, tenant=tenant))

    def h_series_count(r: Reader):
        tenant = _read_tenant(r)
        return Writer().u64(storage.series_count(tenant=tenant))

    def h_tsdb_status(r: Reader):
        import json
        tenant = _read_tenant(r)
        topn = r.u64()
        date_plus1 = r.u64()  # 0 = no date filter
        st = storage.tsdb_status(date_plus1 - 1 if date_plus1 else None, topn,
                                 tenant=tenant)
        return Writer().bytes_(json.dumps(st).encode())

    def h_register_metric_names(r: Reader):
        tenant = _read_tenant(r)
        n = r.u64()
        names = [MetricName.unmarshal(r.bytes_()) for _ in range(n)]
        if hasattr(storage, "register_metric_names"):
            storage.register_metric_names(names, tenant=tenant)
        return Writer().u64(n)

    def h_tenants(r: Reader):
        tenants = storage.tenants() if hasattr(storage, "tenants") \
            else [(0, 0)]
        w = Writer().u64(len(tenants))
        for a, p in tenants:
            w.u64(a).u64(p)
        return w

    def h_tag_value_suffixes(r: Reader):
        tenant = _read_tenant(r)
        min_ts, max_ts = r.i64(), r.i64()
        tag_key = r.str_()
        prefix = r.str_()
        delim = r.str_()
        max_sfx = r.u64()
        sfx = storage.tag_value_suffixes(
            tag_key, prefix, delim or ".", max_sfx,
            min_ts or None, max_ts or None, tenant) \
            if hasattr(storage, "tag_value_suffixes") else []
        w = Writer().u64(len(sfx))
        for s in sfx:
            w.str_(s)
        return w

    def h_metric_names_usage_stats(r: Reader):
        import json
        limit = r.u64()
        le_plus1 = r.u64()  # 0 = no le filter
        items = storage.metric_names_usage_stats(
            limit, le_plus1 - 1 if le_plus1 else None) \
            if hasattr(storage, "metric_names_usage_stats") else []
        return Writer().bytes_(json.dumps(items).encode())

    def h_reset_metric_names_stats(r: Reader):
        if hasattr(storage, "reset_metric_names_stats"):
            storage.reset_metric_names_stats()
        return Writer().u64(1)

    def h_search_metadata(r: Reader):
        import json
        limit = r.u64()
        metric = r.str_()
        md = storage.search_metadata(limit, metric) \
            if hasattr(storage, "search_metadata") else {}
        return Writer().bytes_(json.dumps(md).encode())

    def h_quarantine_report(r: Reader):
        import json
        rep = storage.quarantine_report() \
            if getattr(storage, "quarantine_report", None) is not None \
            else []
        return Writer().bytes_(json.dumps(rep).encode())

    def h_profile(r: Reader):
        """profile_v1: this node's continuous-profiler snapshot (folded
        stacks + sampling meta) so a vmselect can merge the cluster's
        CPU picture with node tags (the quarantineReport_v1 pattern).
        Optional trailing reset flag (old clients don't send it) clears
        this node's aggregates with the read, so a vmselect ?reset=1
        starts a fresh window CLUSTER-wide.  Disabled profiler answers
        an empty snapshot, never an error."""
        import json

        from ..utils import profiler
        reset = bool(r.u64()) if r.remaining else False
        if profiler.configured_hz() > 0:
            profiler.ensure_started()
            snap = profiler.PROFILER.snapshot(reset=reset)
        else:
            snap = {"disabled": True, "stacks": [], "samples": 0}
        return Writer().bytes_(json.dumps(snap).encode())

    def h_health(r: Reader):
        """health_v1: this node's local health verdict — quarantine,
        readonly, merge/work-queue backpressure gauges — as one json
        object (query/sloplane.local_health).  The vmselect roll-up
        fans this and merges; an old node without the method is
        tolerated client-side (verdict "unknown")."""
        import json

        from ..query import sloplane
        return Writer().bytes_(json.dumps(sloplane.local_health(
            storage=storage, role="vmstorage")).encode())

    # -- live resharding: the migrateParts_v1 family -----------------------

    def h_list_parts(r: Reader):
        """listParts_v1: finalized-part inventory for the rebalance
        driver.  Optional flags u64: bit0 = flush pending data to disk
        first, bit1 = force_merge first (compaction shrinks the part
        count a drain must move AND leaves no background merge racing
        the subsequent fetches)."""
        import json
        flags = r.u64() if r.remaining else 0
        if getattr(storage, "list_file_parts", None) is None:
            return Writer().bytes_(json.dumps([]).encode())
        if flags & 2 and hasattr(storage, "force_merge"):
            storage.force_merge()  # force_merge flushes first itself
        elif flags & 1 and hasattr(storage, "force_flush"):
            storage.force_flush()
        return Writer().bytes_(json.dumps(storage.list_file_parts())
                               .encode())

    def h_fetch_part(r: Reader):
        """fetchPart_v1: stream one finalized part — a json meta frame
        (with the file list), one frame per file (header order), then
        the series-registration frame (tsid marshal + name marshal per
        distinct series; metric_ids are node-local, the receiver cannot
        resolve the blocks without them)."""
        import json
        partition = r.str_()
        part = r.str_()
        files, entries, meta = storage.export_part(partition, part)

        def frames():
            yield Writer().bytes_(json.dumps(
                dict(meta, files=[n for n, _ in files])).encode())
            for _, data in files:
                yield Writer().bytes_(data)
            w = Writer().u64(len(entries))
            for tsid_b, raw in entries:
                w.bytes_(tsid_b)
                w.bytes_(raw)
            yield w
        return frames()

    def h_migrate_part(r: Reader):
        """migratePart_v1: adopt a finalized part shipped by the
        rebalance driver — series registrations first, then the bytes
        through the PR-10 crc/quarantine gate under the MergeGate
        (Storage.adopt_part).  Answers (rows, bytes) only after the
        part is durably published, so the driver's subsequent
        removeParts_v1 on the source can never strand acked data."""
        hdr = _json_payload(r.bytes_(), "migratePart_v1 header")
        files = [(str(name), r.bytes_()) for name in hdr["files"]]
        n = r.u64()
        entries = [(r.bytes_(), r.bytes_()) for _ in range(n)]
        if getattr(storage, "adopt_part", None) is None:
            raise RPCError("this node does not support part migration")
        rows, nbytes = storage.adopt_part(
            str(hdr["partition"]), files, entries,
            hdr.get("min_ts"), hdr.get("max_ts"))
        _PARTS_MIGRATED.inc()
        return Writer().u64(int(rows)).u64(int(nbytes))

    def h_remove_parts(r: Reader):
        """removeParts_v1: delist + delete migrated-away parts on the
        source, after the receiver's durable ack."""
        partition = r.str_()
        n = r.u64()
        names = [r.str_() for _ in range(n)]
        if getattr(storage, "remove_parts", None) is None:
            return Writer().u64(0)
        return Writer().u64(storage.remove_parts(partition, names))

    return {
        "writeRows_v1": h_write_rows,
        "writeRowsColumnar_v1": h_write_rows_columnar,
        "listParts_v1": h_list_parts,
        "fetchPart_v1": h_fetch_part,
        "migratePart_v1": h_migrate_part,
        "removeParts_v1": h_remove_parts,
        "isReadOnly_v1": h_is_readonly,
        "search_v1": h_search,
        "searchColumns_v1": h_search_columns,
        "searchMetricNames_v1": h_search_metric_names,
        "labelNames_v1": h_label_names,
        "labelValues_v1": h_label_values,
        "deleteSeries_v1": h_delete_series,
        "seriesCount_v1": h_series_count,
        "tsdbStatus_v1": h_tsdb_status,
        "registerMetricNames_v1": h_register_metric_names,
        "tenants_v1": h_tenants,
        "tagValueSuffixes_v1": h_tag_value_suffixes,
        "metricNamesUsageStats_v1": h_metric_names_usage_stats,
        "resetMetricNamesStats_v1": h_reset_metric_names_stats,
        "searchMetadata_v1": h_search_metadata,
        "quarantineReport_v1": h_quarantine_report,
        "profile_v1": h_profile,
        "health_v1": h_health,
    }


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class StorageNodeClient:
    def __init__(self, host: str, insert_port: int, select_port: int,
                 name: str | None = None, timeout: float = 10.0):
        self.name = name or f"{host}:{insert_port}"
        self.insert = RPCClient(host, insert_port, HELLO_INSERT,
                                timeout=timeout)
        # select plane gets a CONNECTION POOL (VM_RPC_SELECT_CONNS,
        # default 4): concurrent queries to one node must not serialize
        # on a single TCP connection — head-of-line blocking there both
        # throttles reads and hides concurrent load from the node-side
        # TenantGate.  The insert plane stays single-connection: writes
        # are batched and sequenced per node by the router anyway.
        self.select = RPCClientPool(host, select_port, HELLO_SELECT,
                                    timeout=timeout)
        self.down_until = 0.0

    @property
    def healthy(self) -> bool:
        return time.monotonic() >= self.down_until

    def mark_down(self, seconds: float = 2.0):
        self.down_until = time.monotonic() + seconds
        logger.warnf("storage node %s marked down for %.1fs", self.name,
                     seconds)

    def write_rows(self, rows: list[tuple[bytes, int, float]],
                   tenant=(0, 0), reroute: bool = False):
        """``reroute=True`` marks the batch as landing OFF its ring
        owners (an owner was down): the receiving node records the
        series as always-served so the ring read filter can never hide
        what may be their only copy (old nodes ignore the flag — they
        never filter by ring either)."""
        w = _write_tenant(Writer(), tenant).u64(len(rows))
        for raw, ts, val in rows:
            w.bytes_(raw)
            w.i64(int(ts))
            w.f64(float(val))
        if reroute:
            w.u64(1)
        self.insert.call("writeRows_v1", w)

    supports_columnar_write = True  # cleared on first unknown-method error

    def write_rows_columnar(self, keybuf: bytes, key_off, key_len,
                            tss, vals, tenant=(0, 0),
                            reroute: bool = False) -> int:
        """Ship a ColumnarRows shard raw (writeRowsColumnar_v1); falls
        back to per-row writeRows_v1 against old storage nodes."""
        if self.supports_columnar_write:
            w = _write_tenant(Writer(), tenant)
            w.bytes_(keybuf)
            w.array(np.asarray(key_off, np.int64))
            w.array(np.asarray(key_len, np.int64))
            w.array(np.asarray(tss, np.int64))
            w.array(np.asarray(vals, np.float64))
            if reroute:
                w.u64(1)
            try:
                return self.insert.call("writeRowsColumnar_v1", w).u64()
            except RPCError as e:
                if "unknown rpc method" not in str(e):
                    raise
                self.supports_columnar_write = False
        # legacy node: canonical-marshal rows (slow path)
        from ..ingest.parsers import labels_from_series_key
        mv = memoryview(keybuf)
        rows = []
        for o, ln, ts, val in zip(key_off, key_len, tss, vals):
            key = bytes(mv[int(o):int(o) + int(ln)])
            try:
                mn = MetricName.from_labels(labels_from_series_key(key))
            except ValueError:
                continue
            rows.append((mn.marshal(), int(ts), float(val)))
        self.write_rows(rows, tenant, reroute=reroute)
        return len(rows)

    @staticmethod
    def _budget_ms(deadline: float) -> int:
        """Remaining budget to SHIP inside the request (storage-side
        deadline enforcement): the receiving vmstorage re-anchors it on
        its own monotonic clock, so wall-clock skew between nodes never
        matters.  0 = no deadline; an already-exhausted budget ships as
        1ms so the node aborts at its first check instead of scanning."""
        if not deadline:
            return 0
        return max(int((deadline - time.monotonic()) * 1e3), 1)

    @staticmethod
    def _wire_deadline(deadline: float) -> float:
        """Socket-level cutoff: the shipped budget plus bounded slack
        (20% of remaining, clamped to [0.1s, 2s]).  A budget-honoring
        vmstorage aborts server-side within ~one check interval of the
        SHIPPED cutoff, so its typed deadline error arrives before the
        socket gives up (no node-down marking, loud abort accounting);
        a dead/stalled node still costs at most ~1.2 deadlines, never a
        fixed per-hop timeout (the PR-9 property, slightly relaxed)."""
        if not deadline:
            return 0.0
        remaining = deadline - time.monotonic()
        return deadline + min(max(0.2 * remaining, 0.1), 2.0)

    @staticmethod
    def _read_meta(r: Reader, tracer) -> tuple[bool, dict | None]:
        """Parse the trailing metadata frame: (partial, extras).  Old
        servers send [partial][trace-when-tracing] — extras comes back
        None (degraded cost accounting, no union ack).  New servers
        always send [partial][trace-or-empty][extras-json]; the second
        bytes field present is what disambiguates the dialects."""
        partial = bool(r.u64())
        extras = None
        if r.remaining:
            import json
            b1 = r.bytes_()
            if r.remaining:
                # new dialect: b1 was the (possibly empty) trace slot
                try:
                    extras = json.loads(r.bytes_())
                except (ValueError, RPCError):
                    extras = None
            if b1:
                try:
                    tracer.add_remote(json.loads(b1))
                except (ValueError, RPCError):
                    pass  # malformed remote trace never fails the search
        return partial, extras

    @staticmethod
    def _finish_meta(extras: dict | None, or_sets) -> bool:
        """Common metadata-frame epilogue: merge the node's shipped cost
        frame into the current query's CostTracker (None degrades to
        partial cost accounting, never an error) and answer whether the
        shipped or_sets were ACKed as applied — False means the peer is
        an old/union-less node and the caller must fall back to one
        legacy call per set."""
        tr = costacc.current()
        if tr is not None:
            tr.merge_remote((extras or {}).get("cost"))
        if not or_sets:
            return True
        return bool((extras or {}).get("filterUnion"))

    def search_series(self, filters, min_ts, max_ts, tenant=(0, 0),
                      tracer=querytracer.NOP, deadline: float = 0.0,
                      ring=None):
        """Returns (series_list, remote_partial).  Selector-level `or`
        unions (filters = list of sets) ship the extra sets as the
        trailing or_sets field; a peer that doesn't ack the union gets
        one legacy call per remaining set instead (duplicate series
        across sets collapse in the caller's assemble, the same way
        replica overlap does).  ``ring`` (a ringfilter.RingConfig with
        this node's self index) asks the node to serve only the series
        it owns under the caller's hash view — unacked peers return
        everything and the caller's dedup collapses it."""
        first, extra_sets = _split_filter_sets(filters)
        w = _write_tenant(Writer(), tenant)
        _write_filters(w, first)
        w.i64(min_ts).i64(max_ts)
        w.u64(1 if tracer.enabled else 0)
        w.u64(self._budget_ms(deadline))
        if extra_sets or ring is not None:
            w.u64(len(extra_sets))
            for fs in extra_sets:
                _write_filters(w, fs)
        if ring is not None:
            w.bytes_(ring.to_json())
        out = []
        partial = False
        extras = None
        rpc_bytes = 0
        for r in self.select.call_stream("search_v1", w,
                                         deadline=self._wire_deadline(
                                             deadline)):
            rpc_bytes += len(r.data)
            n = r.u64()
            if n == (1 << 32) - 1:  # trailing metadata frame
                partial, extras = self._read_meta(r, tracer)
                continue
            for _ in range(n):
                mn = MetricName.unmarshal(r.bytes_())
                ts = r.array()
                vals = r.array()
                out.append((mn, ts, vals))
        costacc.add_rpc_bytes(rpc_bytes)
        if not self._finish_meta(extras, extra_sets):
            # union-less peer: it served only the first set — fetch the
            # remaining sets one legacy call at a time and concatenate
            for fs in extra_sets:
                more, p2 = self.search_series(fs, min_ts, max_ts, tenant,
                                              tracer=tracer,
                                              deadline=deadline, ring=ring)
                out.extend(more)
                partial = partial or p2
        return out, partial

    supports_columnar_read = True  # cleared on first unknown-method error

    def search_columns(self, filters, min_ts, max_ts, tenant=(0, 0),
                       tracer=querytracer.NOP, deadline: float = 0.0,
                       ring=None):
        """Columnar read plane: returns (raw_names list, counts int64[],
        ts_cat int64[], vals_cat float64[], remote_partial). Falls back to
        search_v1 against old nodes (same return shape).  `deadline` is
        the caller's time.monotonic() cutoff, enforced per socket
        operation by the RPC client; ``ring`` as in search_series."""
        if self.supports_columnar_read:
            first, extra_sets = _split_filter_sets(filters)
            w = _write_tenant(Writer(), tenant)
            _write_filters(w, first)
            w.i64(min_ts).i64(max_ts)
            w.u64(1 if tracer.enabled else 0)
            w.u64(self._budget_ms(deadline))
            if extra_sets or ring is not None:
                w.u64(len(extra_sets))
                for fs in extra_sets:
                    _write_filters(w, fs)
            if ring is not None:
                w.bytes_(ring.to_json())
            try:
                frames = self.select.call_stream(
                    "searchColumns_v1", w,
                    deadline=self._wire_deadline(deadline))
            except RPCError as e:
                if "unknown rpc method" not in str(e):
                    raise
                self.supports_columnar_read = False
                frames = None
            if frames is not None:
                names: list[bytes] = []
                cnt_parts, ts_parts, val_parts = [], [], []
                partial = False
                extras = None
                rpc_bytes = 0
                for r in frames:
                    rpc_bytes += len(r.data)
                    sf = r.u64()
                    if sf == (1 << 32) - 1:  # trailing metadata frame
                        partial, extras = self._read_meta(r, tracer)
                        continue
                    lens = r.array()
                    namebuf = r.bytes_()
                    off = 0
                    for ln in lens:
                        names.append(namebuf[off:off + int(ln)])
                        off += int(ln)
                    cnt_parts.append(r.array())
                    ts_parts.append(r.array())
                    val_parts.append(r.array())
                costacc.add_rpc_bytes(rpc_bytes)
                if not self._finish_meta(extras, extra_sets):
                    # union-less peer served only the first set: pull
                    # the remaining sets legacy-style and concatenate —
                    # duplicate series collapse in the caller's
                    # assemble exactly like replica overlap
                    for fs in extra_sets:
                        n2, c2, t2, v2, p2 = self.search_columns(
                            fs, min_ts, max_ts, tenant, tracer=tracer,
                            deadline=deadline, ring=ring)
                        names.extend(n2)
                        cnt_parts.append(c2)
                        ts_parts.append(t2)
                        val_parts.append(v2)
                        partial = partial or p2
                cat = (lambda ps, dt: np.concatenate(ps) if ps
                       else np.zeros(0, dt))
                return (names, cat(cnt_parts, np.int64),
                        cat(ts_parts, np.int64),
                        cat(val_parts, np.float64), partial)
        series, partial = self.search_series(filters, min_ts, max_ts,
                                             tenant, tracer=tracer,
                                             deadline=deadline, ring=ring)
        names = [mn.marshal() for mn, _, _ in series]
        counts = np.fromiter((ts.size for _, ts, _ in series), np.int64,
                             len(series))
        ts_cat = (np.concatenate([ts for _, ts, _ in series])
                  if series else np.zeros(0, np.int64))
        val_cat = (np.concatenate([v for _, _, v in series])
                   if series else np.zeros(0, np.float64))
        return names, counts, ts_cat, val_cat, partial

    def search_metric_names(self, filters, min_ts, max_ts, tenant=(0, 0)):
        w = _write_tenant(Writer(), tenant)
        _write_filters(w, filters)
        w.i64(min_ts).i64(max_ts)
        r = self.select.call("searchMetricNames_v1", w)
        return [MetricName.unmarshal(r.bytes_()) for _ in range(r.u64())]

    def label_names(self, min_ts, max_ts, tenant=(0, 0)):
        w = _write_tenant(Writer(), tenant).i64(min_ts or 0).i64(max_ts or 0)
        r = self.select.call("labelNames_v1", w)
        return [r.str_() for _ in range(r.u64())]

    def label_values(self, key, min_ts, max_ts, tenant=(0, 0)):
        w = _write_tenant(Writer(), tenant).str_(key)
        w.i64(min_ts or 0).i64(max_ts or 0)
        r = self.select.call("labelValues_v1", w)
        return [r.str_() for _ in range(r.u64())]

    def delete_series(self, filters, tenant=(0, 0)):
        w = _write_tenant(Writer(), tenant)
        _write_filters(w, filters)
        return self.select.call("deleteSeries_v1", w).u64()

    def series_count(self, tenant=(0, 0)):
        return self.select.call("seriesCount_v1",
                                _write_tenant(Writer(), tenant)).u64()

    def tsdb_status(self, topn, date=None, tenant=(0, 0)):
        import json
        w = _write_tenant(Writer(), tenant).u64(topn)
        w.u64(0 if date is None else date + 1)
        r = self.select.call("tsdbStatus_v1", w)
        return _json_payload(r.bytes_(), "tsdbStatus_v1")

    def tenants(self):
        r = self.select.call("tenants_v1", Writer())
        return [(r.u64(), r.u64()) for _ in range(r.u64())]

    def tag_value_suffixes(self, tag_key, prefix, delimiter=".",
                           max_suffixes=100_000, min_ts=None, max_ts=None,
                           tenant=(0, 0)):
        w = _write_tenant(Writer(), tenant)
        w.i64(min_ts or 0).i64(max_ts or 0)
        w.str_(tag_key).str_(prefix).str_(delimiter)
        w.u64(max_suffixes)
        r = self.select.call("tagValueSuffixes_v1", w)
        return [r.str_() for _ in range(r.u64())]

    def metric_names_usage_stats(self, limit=1000, le=None):
        w = Writer().u64(limit).u64(0 if le is None else le + 1)
        r = self.select.call("metricNamesUsageStats_v1", w)
        return _json_payload(r.bytes_(), "metricNamesUsageStats_v1")

    def reset_metric_names_stats(self):
        self.select.call("resetMetricNamesStats_v1", Writer())

    def search_metadata(self, limit=1000, metric=""):
        w = Writer().u64(limit).str_(metric)
        r = self.select.call("searchMetadata_v1", w)
        return _json_payload(r.bytes_(), "searchMetadata_v1")

    def quarantine_report(self):
        try:
            r = self.select.call("quarantineReport_v1", Writer())
        except RPCError as e:
            if "unknown rpc method" in str(e):
                return []  # pre-quarantine storage node
            raise
        return _json_payload(r.bytes_(), "quarantineReport_v1")

    def profile(self, reset: bool = False) -> dict | None:
        """This node's continuous-profiler snapshot; None from an
        old node without profile_v1 (tolerated, the merge just lacks
        that node's stacks).  `reset` clears the node's aggregates
        atomically with the read (old nodes ignore the trailing flag —
        their window simply doesn't reset)."""
        import json
        try:
            r = self.select.call("profile_v1",
                                 Writer().u64(1 if reset else 0))
        except RPCError as e:
            if "unknown rpc method" in str(e):
                return None  # pre-profiler storage node
            raise
        return json.loads(r.bytes_())

    def health(self) -> dict | None:
        """This node's health_v1 verdict; None from an old node
        without the method (tolerated — the roll-up shows the node as
        verdict "unknown" instead of failing the whole report)."""
        import json
        try:
            r = self.select.call("health_v1", Writer())
        except RPCError as e:
            if "unknown rpc method" in str(e):
                return None  # pre-health storage node
            raise
        return json.loads(r.bytes_())

    # -- live resharding (part migration) -------------------------------

    def list_parts(self, flush: bool = False,
                   merge: bool = False) -> list[dict]:
        """Finalized-part inventory on this node (listParts_v1);
        ``flush``/``merge`` compact first — a drain wants few parts and
        no background merge racing the fetches."""
        import json
        w = Writer().u64((1 if flush else 0) | (2 if merge else 0))
        return json.loads(self.select.call("listParts_v1", w).bytes_())

    def fetch_part(self, partition: str, part: str):
        """Pull one finalized part (fetchPart_v1): returns
        (files [(name, bytes)], entries [(tsid, name)], meta dict)."""
        import json
        w = Writer().str_(partition).str_(part)
        frames = list(self.select.call_stream("fetchPart_v1", w))
        hdr = json.loads(frames[0].bytes_())
        fnames = hdr.pop("files")
        files = [(fnames[i], frames[1 + i].bytes_())
                 for i in range(len(fnames))]
        reg = frames[1 + len(fnames)]
        n = reg.u64()
        entries = [(reg.bytes_(), reg.bytes_()) for _ in range(n)]
        return files, entries, hdr

    def migrate_part(self, partition: str, files, entries,
                     meta=None) -> tuple[int, int]:
        """Push one finalized part into this node (migratePart_v1);
        returns (rows, bytes) after the node's durable publish."""
        import json
        meta = meta or {}
        w = Writer().bytes_(json.dumps(
            {"partition": partition, "files": [n for n, _ in files],
             "min_ts": meta.get("min_ts"),
             "max_ts": meta.get("max_ts")}).encode())
        for _, data in files:
            w.bytes_(data)
        w.u64(len(entries))
        for tsid_b, raw in entries:
            w.bytes_(tsid_b)
            w.bytes_(raw)
        r = self.select.call("migratePart_v1", w)
        return r.u64(), r.u64()

    def remove_parts(self, partition: str, names: list[str]) -> int:
        w = Writer().str_(partition).u64(len(names))
        for n in names:
            w.str_(n)
        return self.select.call("removeParts_v1", w).u64()

    def close(self):
        self.insert.close()
        self.select.close()


# ---------------------------------------------------------------------------
# ClusterStorage: the vminsert/vmselect composite backend
# ---------------------------------------------------------------------------

def parse_node_spec(spec: str) -> tuple[str, int, int]:
    """-storageNode spec -> (host, insert_port, select_port).  The
    3-field ``host:insertPort:selectPort`` form addresses a vmstorage;
    the 2-field ``host:port`` form addresses a multilevel child
    (a vmselect/vminsert -clusternativeListenAddr speaks ONE plane, so
    the same port serves both halves — the unused half connects
    lazily and is never dialed)."""
    fields = spec.rsplit(":", 2)
    if len(fields) == 3 and fields[1].isdigit() and fields[2].isdigit():
        return fields[0], int(fields[1]), int(fields[2])
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad storage node spec {spec!r} (want "
                         f"host:insertPort:selectPort or host:port)")
    return host, int(port), int(port)


def _node_name_of(spec: str) -> str:
    """Accept a full node spec OR a bare node name for admin calls."""
    host, ip_, _ = parse_node_spec(spec)
    return f"{host}:{ip_}"


def register_cluster_admin(srv, cluster: "ClusterStorage") -> None:
    """``/internal/cluster/*`` admin surface on vminsert/vmselect —
    the no-restart elasticity endpoints the chaos
    harness, tools and operators drive:

    - ``GET  /internal/cluster/nodes``                  topology + health
    - ``POST /internal/cluster/join?node=h:ip:sp[&rebalance=1]``
    - ``POST /internal/cluster/drain?node=h:ip[&remove=0]``
    - ``POST /internal/cluster/remove?node=h:ip``       (already-empty node)
    - ``POST /internal/cluster/rebalance?node=h:ip``
    - ``POST /internal/cluster/ring_filter?enable=0|1``

    Each process owns its view: a join/drain is announced to the
    vmselect AND the vminsert (reads first for joins, writes first for
    drains — the README walks the orderings)."""
    from ..httpapi.server import Response

    def ok(data):
        return Response.json({"status": "success", "data": data})

    def h_nodes(req):
        return ok(cluster.cluster_status())

    def h_join(req):
        spec = req.arg("node")
        if not spec:
            return Response.error("missing 'node' arg")
        try:
            out = cluster.add_node(spec)
            if req.arg("rebalance") == "1":
                out["rebalance"] = cluster.rebalance_to(
                    _node_name_of(spec))
        except (ValueError, KeyError) as e:
            return Response.error(str(e))
        except (OSError, RPCError, ConnectionError) as e:
            return Response.error(f"join failed: {e}", 503, "unavailable")
        return ok(out)

    def h_drain(req):
        spec = req.arg("node")
        if not spec:
            return Response.error("missing 'node' arg")
        try:
            return ok(cluster.drain_node(
                _node_name_of(spec), remove=req.arg("remove", "1") != "0"))
        except (ValueError, KeyError) as e:
            return Response.error(str(e))
        except (OSError, RPCError, ConnectionError) as e:
            return Response.error(f"drain failed: {e}", 503, "unavailable")

    def h_remove(req):
        spec = req.arg("node")
        if not spec:
            return Response.error("missing 'node' arg")
        try:
            return ok(cluster.remove_node(_node_name_of(spec)))
        except (ValueError, KeyError) as e:
            return Response.error(str(e))

    def h_rebalance(req):
        spec = req.arg("node")
        if not spec:
            return Response.error("missing 'node' arg")
        try:
            return ok(cluster.rebalance_to(_node_name_of(spec)))
        except (ValueError, KeyError) as e:
            return Response.error(str(e))
        except (OSError, RPCError, ConnectionError) as e:
            return Response.error(f"rebalance failed: {e}", 503,
                                  "unavailable")

    def h_ring_filter(req):
        en = req.arg("enable")
        if en is not None and en != "":
            cluster.set_ring_filter(en != "0")
        return ok({"ringFilter": cluster.ring_filter_active})

    srv.route("/internal/cluster/nodes", h_nodes)
    srv.route("/internal/cluster/join", h_join)
    srv.route("/internal/cluster/drain", h_drain)
    srv.route("/internal/cluster/remove", h_remove)
    srv.route("/internal/cluster/rebalance", h_rebalance)
    srv.route("/internal/cluster/ring_filter", h_ring_filter)


def start_native_server(addr: str, hello: bytes, storage,
                        rate_limiter=None):
    """Start a cluster-native RPC server exposing `storage` (used by the
    -clusternativeListenAddr multilevel flags on vminsert/vmselect)."""
    from .rpc import RPCServer
    host, _, port = addr.rpartition(":")
    srv = RPCServer(host or "0.0.0.0", int(port), hello,
                    make_storage_handlers(storage, rate_limiter))
    srv.start()
    return srv


_MISSING = object()


class ClusterStorage:
    """Shard writes / fan-out reads across storage nodes."""

    def __init__(self, nodes: list[StorageNodeClient],
                 replication_factor: int = 1,
                 deny_partial_response: bool = False):
        # (node list, ring) swap together in ONE attribute assignment so
        # a topology change (join/drain) can never hand an in-flight
        # batch a ring index into a different node list
        self._topology = (list(nodes),
                          ConsistentHash([n.name for n in nodes]))
        self.rf = replication_factor
        self.deny_partial = deny_partial_response
        #: nodes being drained: excluded from NEW writes while their
        #: parts migrate off (reads keep hitting them until removal)
        self._draining: set[str] = set()
        #: rf>1 + a topology change suspends ring-ownership read
        #: filtering on this router (full fan-out + dedup): with
        #: replicas, ownership under the NEW ring does not imply
        #: possession until a full anti-entropy pass — rf=1 stays
        #: filtered through every transition (ownership == placement
        #: there, and orphan/exemption rules cover moved data)
        self._ring_suspended = False
        # per-tenant raw-key -> send-key verdicts (relabel applied once
        # per distinct series key; see add_rows_columnar)
        self._key_verdicts: dict[tuple, dict] = {}
        from ..query.rollup_result_cache import next_storage_token
        self.cache_token = next_storage_token()
        # per-instance counters (metrics() is per-cluster; tests build
        # several ClusterStorages per process), mirrored into the process
        # registry below on every inc
        self._rows_sent = metricslib.Counter("rows_sent")
        self._reroutes = metricslib.Counter("reroutes")
        self._rows_sent_counter = metricslib.REGISTRY.counter(
            "vm_rpc_rows_sent_total")
        self._reroutes_counter = metricslib.REGISTRY.counter(
            "vm_rpc_rows_rerouted_total")
        # read fan-outs launched (one per search, NOT one per node): the
        # matstream fleet guard asserts this stays flat as subscribers
        # grow — N watchers of one expression must cost ONE fan-out per
        # interval
        self._search_fanouts = metricslib.Counter("search_fanouts")
        self._search_fanouts_counter = metricslib.REGISTRY.counter(
            "vm_cluster_search_fanouts_total")
        self._lock = make_lock("parallel.VMSelect._lock")
        # partial-result tracking is per handler thread and STICKY across
        # the fanouts of one query (a shared flag would race between
        # concurrent queries and be cleared by a later clean fanout)
        self._tls = threading.local()

    @property
    def nodes(self) -> list[StorageNodeClient]:
        return self._topology[0]

    @property
    def ch(self) -> ConsistentHash:
        return self._topology[1]

    @property
    def rows_sent(self) -> int:
        return self._rows_sent.get()

    @property
    def reroutes(self) -> int:
        return self._reroutes.get()

    def reset_partial(self):
        # threading.local: each request thread reads/writes only its own
        # slot, so cross-root access is partitioned by construction
        self._tls.partial = False  # vmt: disable=VMT015

    @property
    def last_partial(self) -> bool:
        return bool(getattr(self._tls, "partial", False))

    # -- write path (vminsert) ------------------------------------------

    def _write_excluded(self, nodes) -> set[int]:
        """Node indexes NEW writes must avoid: down + draining."""
        return {i for i, n in enumerate(nodes)
                if not n.healthy or n.name in self._draining}

    def add_rows(self, rows, tenant=(0, 0)) -> int:
        """rows: [(labels-dict-or-MetricName, ts, value)] — shard by
        (tenant, canonical metric name), replicate RF-ways, reroute on
        failure."""
        import struct as _struct
        tkey = _struct.pack(">II", tenant[0], tenant[1])
        nodes, ch = self._topology
        per_node: dict[int, list] = {}
        excluded = self._write_excluded(nodes)
        for labels, ts, val in rows:
            mn = labels if isinstance(labels, MetricName) else \
                MetricName.from_dict(labels) if isinstance(labels, dict) \
                else MetricName.from_labels(labels)
            raw = mn.marshal()
            targets = ch.nodes_for_key(tkey + raw, self.rf, excluded)
            if not targets:
                # all nodes down: try everything anyway
                targets = ch.nodes_for_key(tkey + raw, self.rf, set())
            for i in targets:
                per_node.setdefault(i, []).append((raw, ts, val))
        sent = 0
        for i, node_rows in per_node.items():
            node = nodes[i]
            try:
                node.write_rows(node_rows, tenant)
                sent += len(node_rows)
            except (OSError, RPCError, ConnectionError) as e:
                node.mark_down()
                self._reroutes.inc()
                self._reroutes_counter.inc()
                # regroup the failed batch by alternate node: one RPC per
                # target, not one per row
                ex = self._write_excluded(nodes) | {i}
                alt_batches: dict[int, list] = {}
                for row in node_rows:
                    alt = ch.nodes_for_key(tkey + row[0], 1, ex)
                    if not alt:
                        raise RPCError(
                            f"no healthy storage nodes for reroute: {e}")
                    alt_batches.setdefault(alt[0], []).append(row)
                for j, batch in alt_batches.items():
                    # reroute=True: the receiver marks these series
                    # always-served (ring-exempt) — it may now hold
                    # their only copy of this window
                    nodes[j].write_rows(batch, tenant, reroute=True)
                    sent += len(batch)
        self._rows_sent.inc(sent)
        self._rows_sent_counter.inc(sent)
        return len(rows)

    # columnar ingest: the vminsert HTTP fast path (native text parse ->
    # ColumnarRows) ships shards RAW over writeRowsColumnar_v1 — the
    # storage node's native key map resolves whole batches, no per-row
    # Python on either side (the r4 verdict measured the per-row RPC
    # path at <2k rows/s; this is the fix)
    supports_columnar = True
    _MAX_KEY_VERDICTS = 1 << 20

    def add_rows_columnar(self, cr, tenant=(0, 0), transform=None,
                          drop_stats: dict | None = None) -> int:
        import struct as _struct
        tkey = _struct.pack(">II", tenant[0], tenant[1])
        nodes, ch = self._topology
        n_rows = len(cr)
        if n_rows == 0:
            return 0
        key_off = np.asarray(cr.key_off, np.int64)
        key_len = np.asarray(cr.key_len, np.int64)
        mv = memoryview(cr.keybuf)
        # same (offset, len) => same key bytes: unique-ify cheaply first
        # (the native parser reuses key slots for repeat series)
        packed = key_off * (np.int64(1) << 24) + key_len
        uniq, inv = np.unique(packed, return_inverse=True)
        # rows grouped by unique key
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(uniq.size + 1))
        # verdict cache, TRANSFORM PATH ONLY: transform is a pure function
        # of the label set, so each distinct key is parsed/relabeled ONCE
        # across batches. The transform=None path (multilevel RPC ingest,
        # where relabeling already happened upstream) passes keys through
        # untouched and must NOT share verdicts — a cached no-transform
        # passthrough would silently skip a later HTTP request's relabel
        # rules (and vice versa).
        vc = None
        if transform is not None:
            with self._lock:
                vc = self._key_verdicts.setdefault(tenant, {})
        excluded = self._write_excluded(nodes)
        # per-node shards: node -> (key bytes list, PLACEMENT marshal
        # list — reroutes re-place by it — and row index arrays)
        shards: dict[int, tuple[list, list, list]] = {}
        # series whose transformed labels don't survive the text-key
        # round-trip (names with key-syntax bytes): per-row canonical path
        legacy_shards: dict[int, list] = {}
        dropped_transform = dropped_malformed = 0
        for j in range(uniq.size):
            o = int(uniq[j] >> 24)
            ln = int(uniq[j] & ((1 << 24) - 1))
            key = bytes(mv[o:o + ln])
            if transform is None:
                # placement by the CANONICAL marshal (memoized per
                # distinct key): both write paths and the ring read
                # filter must agree on one shard key, and spelling
                # variants of one series must co-locate
                sk = ("cols", key, placement_marshal(key))
            else:
                sk = vc.get(key, _MISSING)
                if sk is _MISSING:
                    sk = self._judge_key(key, transform)
                    if len(vc) >= self._MAX_KEY_VERDICTS:
                        vc.clear()
                    vc[key] = sk
            rows_j = order[bounds[j]:bounds[j + 1]]
            if sk is False:
                dropped_malformed += rows_j.size
                continue
            if sk is None:
                dropped_transform += rows_j.size
                continue
            if sk[0] == "legacy":  # ("legacy", canonical_marshal)
                raw = sk[1]
                targets = ch.nodes_for_key(tkey + raw, self.rf, excluded)
                if not targets:
                    targets = ch.nodes_for_key(tkey + raw, self.rf, set())
                for i in targets:
                    rl = legacy_shards.setdefault(i, [])
                    for rix in rows_j:
                        rl.append((raw, int(cr.tss[rix]),
                                   float(cr.values[rix])))
                continue
            _, send_key, pm = sk
            targets = ch.nodes_for_key(tkey + pm, self.rf, excluded)
            if not targets:
                targets = ch.nodes_for_key(tkey + pm, self.rf, set())
            for i in targets:
                keys, pkeys, rowsl = shards.setdefault(i, ([], [], []))
                keys.append(send_key)
                pkeys.append(pm)
                rowsl.append(rows_j)
        if drop_stats is not None:
            if dropped_transform:
                drop_stats["transform"] = drop_stats.get(
                    "transform", 0) + int(dropped_transform)
            if dropped_malformed:
                drop_stats["malformed"] = drop_stats.get(
                    "malformed", 0) + int(dropped_malformed)
        tss = np.asarray(cr.tss, np.int64)
        vals = np.asarray(cr.values, np.float64)
        sent = 0
        for i, rows in legacy_shards.items():
            try:
                nodes[i].write_rows(rows, tenant)
                sent += len(rows)
            except (OSError, RPCError, ConnectionError) as e:
                nodes[i].mark_down()
                self._reroutes.inc()
                self._reroutes_counter.inc()
                ex = self._write_excluded(nodes) | {i}
                alt_batches: dict[int, list] = {}
                for row in rows:
                    alt = ch.nodes_for_key(tkey + row[0], 1, ex)
                    if not alt:
                        raise RPCError(
                            f"no healthy storage nodes for reroute: {e}")
                    alt_batches.setdefault(alt[0], []).append(row)
                for j2, batch in alt_batches.items():
                    nodes[j2].write_rows(batch, tenant, reroute=True)
                    sent += len(batch)
        for i, (keys, pkeys, rowsl) in shards.items():
            try:
                sent += self._send_columnar_shard(nodes[i], keys,
                                                  rowsl, tss, vals, tenant)
            except (OSError, RPCError, ConnectionError) as e:
                nodes[i].mark_down()
                self._reroutes.inc()
                self._reroutes_counter.inc()
                ex = self._write_excluded(nodes) | {i}
                alt_shards: dict[int, tuple[list, list]] = {}
                for key, pm, rows_j in zip(keys, pkeys, rowsl):
                    alt = ch.nodes_for_key(tkey + pm, 1, ex)
                    if not alt:
                        raise RPCError(
                            f"no healthy storage nodes for reroute: {e}")
                    ks, rl = alt_shards.setdefault(alt[0], ([], []))
                    ks.append(key)
                    rl.append(rows_j)
                for j2, (ks, rl) in alt_shards.items():
                    sent += self._send_columnar_shard(nodes[j2], ks,
                                                      rl, tss, vals, tenant,
                                                      reroute=True)
        self._rows_sent.inc(sent)
        self._rows_sent_counter.inc(sent)
        return int(n_rows - dropped_transform - dropped_malformed)

    @staticmethod
    def _judge_key(key: bytes, transform):
        """One-time verdict for a distinct raw key under `transform`:
        ("cols", send_key, placement_marshal) = ship the (relabeled)
        text key columnar, shard by the canonical marshal; None =
        dropped by the transform; False = malformed; ("legacy",
        marshal) = the transformed labels don't survive the text
        round-trip (key-syntax bytes in names) and must go per-row
        canonical."""
        from ..ingest.parsers import (labels_from_series_key,
                                      series_key_from_labels)
        try:
            labels = labels_from_series_key(key)
        except ValueError:
            return False
        labels = transform(labels)
        if not labels:
            return None
        sk = series_key_from_labels(labels)
        try:
            back = labels_from_series_key(sk)
        except ValueError:
            back = None
        canon = sorted((k.decode() if isinstance(k, bytes) else k,
                        v.decode() if isinstance(v, bytes) else v)
                       for k, v in labels if v)
        marshal = MetricName.from_labels(labels).marshal()
        if back is None or sorted(back) != canon:
            return ("legacy", marshal)
        return ("cols", sk, marshal)

    def reset_columnar_spaces(self) -> None:
        """Invalidate cached raw-key -> send-key verdicts (call after the
        ingest transform config — relabel rules, series limits —
        changes)."""
        with self._lock:
            self._key_verdicts = {}

    def _send_columnar_shard(self, node, keys, rowsl, tss, vals,
                             tenant, reroute: bool = False) -> int:
        """One writeRowsColumnar_v1 call: build the shard's keybuf +
        per-row offset columns from (key, row-index-array) pairs."""
        counts = np.fromiter((r.size for r in rowsl), np.int64, len(rowsl))
        klens = np.fromiter((len(k) for k in keys), np.int64, len(keys))
        koffs = np.concatenate([[0], np.cumsum(klens)[:-1]])
        row_order = (np.concatenate(rowsl) if rowsl
                     else np.zeros(0, np.int64))
        node.write_rows_columnar(
            b"".join(keys), np.repeat(koffs, counts),
            np.repeat(klens, counts), tss[row_order], vals[row_order],
            tenant, reroute=reroute)
        return int(row_order.size)

    # -- read path (vmselect) -------------------------------------------

    def _fanout(self, fn, replica_covered_ok: bool = True):
        """Run fn(node) on every healthy node concurrently (scatter-gather;
        the reference fans out to all vmstorage nodes in parallel) via the
        shared work pool (utils/workpool) instead of spawning fresh
        threads per query — RPC reads release the GIL, and a fanout task
        hitting an in-process LocalNode may fan its own part collection
        across the same pool (the pool's helping waiters make that
        nesting deadlock-free). Trade-off: network waits share the
        cpu_count-sized pool with decode units, so very wide clusters
        (nodes >> cores) serialize some per-node waits; at this port's
        node counts that is cheaper than a thread per node per query,
        and the helping caller always makes progress. Known-down nodes
        are skipped but still count toward the partial flag.

        Replica-aware partial accounting (the vm_deny_partial-style key
        coverage): with rendezvous placement every key's RF-target set
        holds RF DISTINCT nodes, so when fewer than RF distinct nodes
        failed AND every survivor responded, each of the failed nodes'
        hash ranges is provably served by a surviving responder — the
        result is complete, not partial; ``vm_partial_avoided_total``
        ticks instead.  ``replica_covered_ok=False`` (mutating fanouts
        like deleteSeries, where a missed node means a missed tombstone
        regardless of read coverage) keeps the strict accounting."""
        results: list = []
        errors: list = []
        lock = make_lock("parallel.cluster_api.fanout_lock")
        # per-thread record of WHICH nodes failed this fan-out: the
        # ring-filtered read path re-fans (or goes honestly partial)
        # when a failure wasn't in the down set the rings shipped —
        # waited=False failures (pre-exhausted budget, local pool
        # capacity) never flip node.healthy, so health alone can't
        # detect that survivors suppressed the failed node's shares
        self._tls.fanout_failed = frozenset()

        def run(node):
            try:
                r = fn(node)
                with lock:
                    results.append(r)
            except (OSError, RPCError, ConnectionError) as e:
                # a deadline that was exhausted BEFORE any I/O touched
                # the node (waited=False) is the query's fault: count
                # the error/partial, but don't poison the node's health
                # for other queries' next 2s
                if getattr(e, "waited", True):
                    node.mark_down()
                with lock:
                    errors.append((node.name, e))

        all_nodes = self.nodes
        live = [n for n in all_nodes if n.healthy]
        for n in all_nodes:
            if not n.healthy:
                errors.append((n.name, RPCError("node marked down")))
        if len(live) <= 1:
            for n in live:
                run(n)
        else:
            from functools import partial

            from ..utils import workpool
            workpool.POOL.run([partial(run, n) for n in live])
        if errors and not results:
            raise ClusterUnavailableError(
                f"all storage nodes failed: {errors[0][0]}: "
                f"{errors[0][1]}")
        if errors:
            failed = {name for name, _ in errors}
            self._tls.fanout_failed = frozenset(failed)
            if replica_covered_ok and self.rf > 1 and \
                    len(failed) < self.rf:
                # every hash range of every failed node is RF-covered by
                # a surviving responder (all non-failed nodes produced a
                # result above): the merged answer is complete
                _PARTIAL_AVOIDED.inc()
            else:
                self._tls.partial = True
                if self.deny_partial:
                    raise PartialResultError(
                        f"partial response denied: {errors[0][0]}: "
                        f"{errors[0][1]}")
        return results

    # eval passes ec.tracer down so storage-node spans land in the query
    # trace (the vmselect->vmstorage half of cross-RPC tracing)
    supports_search_tracer = True
    # selector-level `or` filters ({a="b" or c="d"}) are shipped through
    # search_v1/searchColumns_v1 as a trailing or_sets field; union-less
    # peers degrade to one legacy call per set (see StorageNodeClient)
    supports_filter_union = True
    # eval passes ec.deadline down so per-node RPC socket timeouts are
    # derived from the query's REMAINING budget: a hung vmstorage costs
    # one query deadline, not a fixed default timeout per hop
    supports_search_deadline = True

    def _read_rings(self, also_down=frozenset()) -> tuple[dict, frozenset]:
        """(per-node RingConfig for one read fan-out — node name ->
        ring with that node's self index and the current down set —,
        the down NODE NAMES those rings embed).  ({}, frozenset()) when
        ring-ownership filtering is off (VM_RING_FILTER=0, a single
        node, or suspended after an rf>1 topology change).  The down
        set is returned so the re-fan check compares against exactly
        what the rings claimed (a second health read could differ).
        Ticks ``vm_reroute_reads_total`` when the shipped down set is
        non-empty — survivors will explicitly serve the down nodes'
        hash ranges from their replicas.  ``also_down`` names nodes to
        ship as down whatever their health says: the re-fan passes the
        nodes the first attempt marked down, whose 2 s down-mark may
        already have expired when a fan-out takes longer than that."""
        nodes = self.nodes
        if not ringfilter.enabled() or self._ring_suspended or \
                len(nodes) <= 1:
            return {}, frozenset()
        names = [n.name for n in nodes]
        down = frozenset(i for i, n in enumerate(nodes)
                         if not n.healthy or n.name in also_down)
        if down:
            ringfilter.REROUTE_READS.inc()
        return ({n.name: ringfilter.get_ring(names, self.rf, i, down)
                 for i, n in enumerate(nodes) if n.healthy},
                frozenset(names[i] for i in down))

    def search_columns(self, filters, min_ts, max_ts,
                       dedup_interval_ms=None, max_series=None,
                       tenant=(0, 0), tracer=querytracer.NOP,
                       deadline: float = 0.0):
        """Columnar scatter-gather: every node streams (raw names,
        counts, concatenated columns) over searchColumns_v1; the merge is
        ONE vectorized assembly into the padded (S, N) layout — cluster
        reads feed the same columnar host rollups and device tile packer
        as single-node reads. Replica overlap is handled by assemble()'s
        per-row sort fix + exact-duplicate-timestamp dedup (keep last),
        identical to the old per-series merge semantics."""
        from ..storage.columnar import ColumnarSeries, assemble
        self._search_fanouts.inc()
        self._search_fanouts_counter.inc()
        lost = frozenset()
        for _attempt in range(2):
            # down_before = the EXACT down set the shipped rings embed
            # (a second health snapshot could already differ and hide a
            # just-failed node from the re-fan check); the re-fan ships
            # the nodes the first attempt marked down as down even when
            # the mark expired during a fan-out longer than it (else the
            # re-fan suppresses their shares again and goes partial); a
            # failure that marks no node (waited=False) stays partial
            rings, down_before = self._read_rings(lost)

            def query_node(n, rings=rings):
                # one child span per storage node; children.append is
                # GIL-atomic, so concurrent fan-out threads are safe
                with tracer.new_child("rpc searchColumns_v1 node %s",
                                      n.name) as nqt:
                    return n.search_columns(filters, min_ts, max_ts,
                                            tenant, tracer=nqt,
                                            deadline=deadline,
                                            ring=rings.get(n.name))

            t_fan = time.monotonic()
            node_results = self._fanout(query_node)
            if not rings or self.rf <= 1:
                break
            # ANY failure the shipped rings didn't list as down means
            # the survivors suppressed shares the failed node owned —
            # node.healthy flips cover crashes, fanout_failed covers
            # waited=False failures (pre-exhausted budget, local pool
            # capacity) that never mark the node down
            fresh = (({n.name for n in self.nodes if not n.healthy} |
                      set(getattr(self._tls, "fanout_failed", ()))) -
                     down_before)
            if not fresh:
                break
            if _attempt == 1:
                # the re-fan ALSO failed a node the rings called
                # healthy: replica coverage cannot be claimed — the
                # suppressed shares may be missing, so go honestly
                # partial instead of silently incomplete
                self._tls.partial = True
                if self.deny_partial:
                    raise PartialResultError(
                        "partial response denied: ring-filtered "
                        "fan-out kept failing node(s) "
                        + ",".join(sorted(fresh)))
                break
            # a node died DURING this fan-out, after the shipped rings
            # claimed it healthy: its replicas suppressed the shares it
            # owned, so the merged result is silently missing them.
            # One bounded re-fan with the updated down set makes the
            # survivors serve those ranges explicitly (KNOWN-down nodes
            # never re-fan — their shares ship rerouted the first time).
            logger.warnf("cluster: node(s) %s failed mid-fan-out; "
                         "re-fanning with rerouted ring",
                         ",".join(sorted(fresh)))
            lost = frozenset(n.name for n in self.nodes
                             if n.name in fresh and n.down_until > t_fan)
        names_all: list[bytes] = []
        cnt_parts, ts_parts, val_parts = [], [], []
        for names, counts, ts_cat, val_cat, remote_partial in node_results:
            if remote_partial:
                # a lower level (multilevel chain) saw an incomplete
                # fan-out
                self._tls.partial = True
            names_all.extend(names)
            cnt_parts.append(counts)
            ts_parts.append(ts_cat)
            val_parts.append(val_cat)
        if not names_all:
            return ColumnarSeries.empty()
        cnts = np.concatenate(cnt_parts)
        ts_cat = np.concatenate(ts_parts)
        val_cat = np.concatenate(val_parts)
        # canonical row order = sorted raw names (matches single-node
        # search_columns); same bytes from replicas collapse to one row
        if any(nm[-1:] == b"\x00" for nm in names_all):
            arr = np.array(names_all, dtype=object)
        else:
            arr = np.array(names_all)
        uniq_names, rows = np.unique(arr, return_inverse=True)
        S = int(uniq_names.size)
        if max_series is not None and S > max_series:
            raise ResourceWarning(
                f"query matches {S} series, limit {max_series}")
        keep = cnts > 0
        if not keep.all():
            sample_keep = np.repeat(keep, cnts)
            rows, cnts = rows[keep], cnts[keep]
            ts_cat, val_cat = ts_cat[sample_keep], val_cat[sample_keep]
            if rows.size == 0:
                return ColumnarSeries.empty()
        cols = assemble(np.asarray(rows, np.int64), S,
                        np.asarray(cnts, np.int64), ts_cat, val_cat,
                        min_ts, max_ts, dedup_interval_ms or 0,
                        metric_ids=np.arange(S, dtype=np.int64))
        raws = [bytes(u) for u in uniq_names]
        if cols.dropped_rows is not None:
            live = np.delete(np.arange(S), cols.dropped_rows)
            raws = [raws[i] for i in live]
        cols.raw_names = raws
        cols.metric_names = [MetricName.unmarshal(r) for r in raws]
        cols.compute_stale_rows()
        return cols

    def search_series(self, filters, min_ts, max_ts, dedup_interval_ms=None,
                      max_series=None, tenant=(0, 0),
                      tracer=querytracer.NOP, deadline: float = 0.0):
        return self.search_columns(
            filters, min_ts, max_ts, dedup_interval_ms=dedup_interval_ms,
            max_series=max_series, tenant=tenant,
            tracer=tracer, deadline=deadline).to_series_list()

    def search_metric_names(self, filters, min_ts, max_ts, limit=2**31,
                            tenant=(0, 0)):
        node_results = self._fanout(
            lambda n: n.search_metric_names(filters, min_ts, max_ts, tenant))
        seen = {}
        for res in node_results:
            for mn in res:
                seen.setdefault(mn.marshal(), mn)
        return [seen[k] for k in sorted(seen)][:limit]

    def label_names(self, min_ts=None, max_ts=None, tenant=(0, 0)):
        res = self._fanout(lambda n: n.label_names(min_ts, max_ts, tenant))
        return sorted(set().union(*map(set, res))) if res else []

    def label_values(self, key, min_ts=None, max_ts=None, tenant=(0, 0)):
        res = self._fanout(
            lambda n: n.label_values(key, min_ts, max_ts, tenant))
        return sorted(set().union(*map(set, res))) if res else []

    def tag_value_suffixes(self, tag_key, prefix, delimiter=".",
                           max_suffixes=100_000, min_ts=None, max_ts=None,
                           tenant=(0, 0)):
        res = self._fanout(lambda n: n.tag_value_suffixes(
            tag_key, prefix, delimiter, max_suffixes, min_ts, max_ts,
            tenant))
        return sorted(set().union(*map(set, res)))[:max_suffixes] \
            if res else []

    def metric_names_usage_stats(self, limit=1000, le=None):
        # per-node counters: a missing node's counts change the answer
        # regardless of data replication — strict partial accounting
        merged: dict[str, list] = {}
        for items in self._fanout(
                lambda n: n.metric_names_usage_stats(limit, le),
                replica_covered_ok=False):
            for x in items:
                e = merged.setdefault(x["metricName"], [0, 0])
                e[0] += x["requestsCount"]
                e[1] = max(e[1], x["lastRequestTimestamp"])
        items = [{"metricName": k, "requestsCount": c,
                  "lastRequestTimestamp": t}
                 for k, (c, t) in merged.items()]
        if le is not None:
            items = [x for x in items if x["requestsCount"] <= le]
        items.sort(key=lambda x: x["requestsCount"])
        return items[:limit]

    def reset_metric_names_stats(self):
        # mutation: a missed node keeps its stats — never claim coverage
        self._fanout(lambda n: n.reset_metric_names_stats(),
                     replica_covered_ok=False)

    def search_metadata(self, limit=1000, metric=""):
        # TYPE/HELP metadata is node-local state, not RF-replicated data
        out: dict = {}
        for md in self._fanout(
                lambda n: n.search_metadata(limit, metric),
                replica_covered_ok=False):
            for k, v in md.items():
                out.setdefault(k, v)
        return dict(list(out.items())[:limit])

    def quarantine_report(self) -> list[dict]:
        """Cluster-wide quarantine listing: fan the storage nodes'
        reports together (tagged per node) so the vmselect's
        /api/v1/status/quarantine is the operator's single worksheet."""
        out: list[dict] = []

        def one(n):
            return [dict(q, node=n.name) for q in n.quarantine_report()]

        # strict accounting: a node whose report is missing may be the
        # one HOLDING quarantined parts — replica coverage can cover its
        # data, never its per-node quarantine state
        for rep in self._fanout(one, replica_covered_ok=False):
            out.extend(rep)
        return out

    def profile_report(self, reset: bool = False) -> list[dict]:
        """Cluster-wide profiler fan-out: every node's folded-stack
        snapshot tagged with its node name, so the vmselect's
        ``/api/v1/status/profile`` answers for the whole cluster.
        ``reset`` propagates so ?reset=1 opens a fresh measurement
        window on every node, not just the vmselect.  Node-local
        state — strict partial accounting, like quarantine."""
        def one(n):
            snap = n.profile(reset=reset)
            if snap is None or snap.get("disabled"):
                return []
            snap["node"] = n.name
            return [snap]

        out: list[dict] = []
        for rep in self._fanout(one, replica_covered_ok=False):
            out.extend(rep)
        return out

    def health_report(self) -> list[dict]:
        """Per-node health_v1 verdicts tagged with node names — the
        input to the /api/v1/status/health roll-up.  Best-effort by
        design: a node that cannot answer simply has no report (the
        roll-up already names it down/unreachable from liveness), and
        an old node without the method reports verdict "unknown"
        rather than failing the fan-out."""
        def one(n):
            rep = n.health()
            if rep is None:
                rep = {"verdict": "unknown"}
            rep["node"] = n.name
            return rep

        try:
            # node-local state: strict accounting like quarantine
            return self._fanout(one, replica_covered_ok=False)
        except (ClusterUnavailableError, PartialResultError):
            return []

    def delete_series(self, filters, tenant=(0, 0)):
        # a node that missed the fan-out missed its TOMBSTONES: replica
        # coverage cannot make that complete (the down node's copy will
        # resurrect), so deletes keep strict partial accounting
        return sum(self._fanout(lambda n: n.delete_series(filters, tenant),
                                replica_covered_ok=False))

    def series_count(self, tenant=(0, 0)):
        # summed per-node counts change value when a node is missing —
        # RF coverage proves its DATA is served elsewhere, not that the
        # sum is unchanged (with RF>1 replicas are double-counted when
        # healthy): strict partial accounting
        return sum(self._fanout(lambda n: n.series_count(tenant),
                                replica_covered_ok=False))

    def tenants(self):
        res = self._fanout(lambda n: n.tenants())
        return sorted(set().union(*map(set, res))) if res else []

    def tsdb_status(self, date=None, topn=10, tenant=(0, 0)):
        # per-node top-N counts, same reasoning as series_count
        results = self._fanout(lambda n: n.tsdb_status(topn, date, tenant),
                               replica_covered_ok=False)
        total = sum(r["totalSeries"] for r in results)

        def merge_top(key):
            acc = {}
            for r in results:
                for e in r.get(key, []):
                    acc[e["name"]] = acc.get(e["name"], 0) + e["count"]
            return [{"name": k, "count": c} for k, c in
                    sorted(acc.items(), key=lambda kv: -kv[1])[:topn]]

        return {"totalSeries": total,
                "seriesCountByMetricName": merge_top("seriesCountByMetricName"),
                "seriesCountByLabelName": merge_top("seriesCountByLabelName"),
                "seriesCountByLabelValuePair":
                    merge_top("seriesCountByLabelValuePair")}

    # -- elastic topology: join / drain / rebalance ---------------------
    #
    # The cluster grows and shrinks WITHOUT restarts:
    # join adds a node to the hash ring (new writes shard to it at the
    # next batch), drain write-excludes a node, migrates every
    # finalized part off it over the migrateParts_v1 family, and only
    # then drops it — each part is removed from its source AFTER the
    # receiver's durable ack, so acked writes survive every transition.
    # Reads stay byte-exact throughout: moved parts are ring-exempt on
    # their new node and duplicates collapse in the fan-out merge.

    def node_names(self) -> list[str]:
        return [n.name for n in self.nodes]

    def set_ring_filter(self, enabled: bool) -> None:
        """Re-arm (or suspend) ring-ownership read filtering on this
        router — rf>1 topology changes suspend it automatically (see
        __init__); the operator re-enables once the data layout has
        settled."""
        with self._lock:
            self._ring_suspended = not enabled

    @property
    def ring_filter_active(self) -> bool:
        return ringfilter.enabled() and not self._ring_suspended and \
            len(self.nodes) > 1

    def _set_nodes_locked(self, nodes: list[StorageNodeClient]) -> None:
        """Swap the (nodes, ring) tuple; caller holds self._lock."""
        self._topology = (list(nodes),
                          ConsistentHash([n.name for n in nodes]))
        if self.rf > 1:
            # with replicas, ownership under the NEW ring does not
            # imply possession — suspend ownership filtering until
            # the operator re-arms it (full fan-out stays correct)
            self._ring_suspended = True

    def _set_nodes(self, nodes: list[StorageNodeClient]) -> None:
        with self._lock:
            self._set_nodes_locked(nodes)

    def add_node(self, spec: str, timeout: float = 10.0) -> dict:
        """JOIN host:insertPort:selectPort (or host:port for a
        multilevel child): new writes shard to the node from the next
        batch on.  Call :meth:`rebalance_to` afterwards to move a fair
        byte share of existing parts onto it."""
        host, ip_, sp_ = parse_node_spec(spec)
        node = StorageNodeClient(host, ip_, sp_, timeout=timeout)
        # read-modify-write under the topology lock: two concurrent
        # joins (admin handlers run on separate HTTP threads) must not
        # lose each other's node
        with self._lock:
            if node.name in {n.name for n in self.nodes}:
                dup = True
            else:
                dup = False
                logger.infof("cluster: joining node %s", node.name)
                self._draining.discard(node.name)
                self._set_nodes_locked(self.nodes + [node])
        if dup:
            node.close()
            raise ValueError(f"node {node.name} is already in the ring")
        return {"nodes": self.node_names()}

    def remove_node(self, name: str) -> dict:
        """Drop a node from the ring (reads/writes stop immediately).
        Use :meth:`drain_node` instead when the node still holds data."""
        with self._lock:
            nodes = list(self.nodes)
            keep = [n for n in nodes if n.name != name]
            if len(keep) == len(nodes):
                raise KeyError(f"no node named {name!r}")
            if not keep:
                raise ValueError("cannot remove the last storage node")
            logger.infof("cluster: removing node %s", name)
            self._set_nodes_locked(keep)
            self._draining.discard(name)
        for n in nodes:
            if n.name == name:
                n.close()
        return {"nodes": self.node_names()}

    @staticmethod
    def _migrate_grace_s() -> float:
        """How long a migrated part's SOURCE copy outlives the
        receiver's ack (``VM_MIGRATE_GRACE_MS``, default 1500).  A
        fan-out is not atomic: a query can read the target BEFORE the
        part lands there and the source AFTER a prompt delete — missing
        the part on both, silently.  Keeping the source copy for one
        grace window (>= the longest query's wall time) closes that
        race: any fan-out that missed the part on the target started
        early enough to still find it on the source (duplicates from
        the overlap collapse in the merge like replica overlap)."""
        import os
        try:
            return max(float(os.environ.get("VM_MIGRATE_GRACE_MS",
                                            "1500")), 0.0) / 1e3
        except ValueError:
            return 1.5

    def _copy_one(self, src: StorageNodeClient, dst: StorageNodeClient,
                  partition: str, part: str) -> tuple[int, int]:
        """Copy one finalized part src -> dst: pull (fetchPart_v1) and
        push (migratePart_v1 — the receiver verifies crc32s and
        publishes durably).  The SOURCE copy stays; callers delete it
        after the migration grace window (see _migrate_grace_s).

        Known bound: the transfer materializes the part in memory at
        each hop and the push is one RPC frame, so parts are capped by
        RAM and rpc.MAX_FRAME (256MB compressed) — an over-cap part
        fails loudly and stays on its source (streamed bounded-memory
        transfer is the follow-up)."""
        files, entries, meta = src.fetch_part(partition, part)
        rows, nbytes = dst.migrate_part(partition, files, entries, meta)
        _PARTS_MIGRATED.inc()
        _REBALANCE_BYTES.inc(nbytes)
        logger.infof("cluster: migrated %s/%s %s -> %s (%d rows, %d "
                     "bytes)", partition, part, src.name, dst.name, rows,
                     nbytes)
        return rows, nbytes

    @staticmethod
    def _remove_after_grace(src: StorageNodeClient, moved: dict) -> None:
        """Delete migrated-away source copies once the grace window has
        passed (``moved``: partition -> [part names])."""
        if not moved:
            return
        time.sleep(ClusterStorage._migrate_grace_s())
        for partition, names in moved.items():
            src.remove_parts(partition, names)

    def drain_node(self, name: str, remove: bool = True,
                   max_passes: int = 6) -> dict:
        """DRAIN: write-exclude the node, then migrate every finalized
        part off it (each listing flushes first, so rows acked before
        or during the drain are included; the first pass force-merges
        so few parts move and no background merge races the fetches).
        Multiple passes absorb parts that appear between listings.
        ``remove`` drops the node from the ring once it is empty."""
        if name not in self.node_names():
            raise KeyError(f"no node named {name!r}")
        self._draining.add(name)
        try:
            return self._drain_node(name, remove, max_passes)
        except BaseException:
            # a failed drain must not leave the node write-excluded
            # forever (a successful one removes it from the ring, or —
            # with remove=False — the caller owns the follow-up)
            self._draining.discard(name)
            raise

    def _drain_node(self, name: str, remove: bool,
                    max_passes: int) -> dict:
        # ONE topology snapshot for the whole (long, sleeping) drain:
        # part names are node-local counters, so index-addressing
        # self.nodes across a concurrent topology change could point a
        # remove_parts at the WRONG node's identically-named parts
        nodes, ch = self._topology
        idx = [n.name for n in nodes].index(name)
        src = nodes[idx]
        moved = {"parts": 0, "rows": 0, "bytes": 0}
        for attempt in range(max_passes):
            parts = src.list_parts(flush=True, merge=attempt == 0)
            if not parts:
                break
            copied: dict[str, list[str]] = {}
            for row in parts:
                excluded = {i for i, n in enumerate(nodes)
                            if not n.healthy or n.name in self._draining}
                excluded.add(idx)
                key = (b"part:" + row["partition"].encode() + b"/" +
                       row["part"].encode() + src.name.encode())
                tgt = ch.nodes_for_key(key, 1, excluded)
                if not tgt:
                    raise RPCError(
                        f"drain {name}: no healthy target nodes")
                try:
                    rows_n, bytes_n = self._copy_one(
                        src, nodes[tgt[0]], row["partition"],
                        row["part"])
                except (RPCError, KeyError) as e:
                    # merged away since listing (or a racing pass):
                    # the re-list on the next attempt settles it
                    logger.warnf("drain %s: part %s/%s skipped: %s",
                                 name, row["partition"], row["part"], e)
                    continue
                copied.setdefault(row["partition"], []).append(row["part"])
                moved["parts"] += 1
                moved["rows"] += rows_n
                moved["bytes"] += bytes_n
            # source copies outlive the ack by the migration grace so
            # in-flight fan-outs that read the target pre-adopt still
            # find the bytes on the source (then the re-list can't see
            # the removed parts again)
            self._remove_after_grace(src, copied)
        else:
            raise RPCError(f"drain {name}: parts still appearing after "
                           f"{max_passes} passes")
        out = dict(moved, node=name, removed=False)
        if remove:
            self.remove_node(name)
            out["removed"] = True
        return out

    def rebalance_to(self, name: str) -> dict:
        """After a JOIN: greedily move finalized parts from the most
        loaded nodes onto ``name`` until it holds ~1/N of the cluster's
        part bytes.  A part moves when the move brings BOTH sides at
        least as close to the fair share as staying put — so a single
        compacted part larger than the fair share still moves to an
        empty joiner (the 1-node -> 2-node case) instead of silently
        rebalancing nothing.  Byte-exact reads throughout: adopted
        parts serve ring-exempt, and each source copy outlives the
        receiver's durable ack (one grace window for the whole pass)."""
        # one topology snapshot for the whole pass (see _drain_node:
        # index- or ring-addressing across a concurrent change could
        # delete identically-named parts on the WRONG node)
        nodes, _ = self._topology
        try:
            tgt_i = [n.name for n in nodes].index(name)
        except ValueError:
            raise KeyError(f"no node named {name!r}")
        tgt = nodes[tgt_i]
        inv: dict[int, list] = {}
        for i, n in enumerate(nodes):
            if n.healthy and n.name not in self._draining:
                inv[i] = n.list_parts(flush=True)
        total = sum(r["bytes"] for parts in inv.values() for r in parts)
        fair = total / max(len(inv), 1)
        have = sum(r["bytes"] for r in inv.get(tgt_i, ()))
        moved = {"parts": 0, "rows": 0, "bytes": 0}
        copied: dict[int, dict[str, list[str]]] = {}
        order = sorted((i for i in inv if i != tgt_i),
                       key=lambda i: -sum(r["bytes"] for r in inv[i]))
        for i in order:
            src_bytes = sum(r["bytes"] for r in inv[i])
            for row in sorted(inv[i], key=lambda r: -r["bytes"]):
                b = row["bytes"]
                # move only if neither side ends FARTHER from fair
                # than it started (<= : a neutral move still fills an
                # empty joiner)
                if b <= 0 or b > 2 * (fair - have) or \
                        b > 2 * (src_bytes - fair):
                    continue
                try:
                    rows_n, bytes_n = self._copy_one(
                        nodes[i], tgt, row["partition"], row["part"])
                except (RPCError, KeyError) as e:
                    logger.warnf("rebalance: part %s/%s skipped: %s",
                                 row["partition"], row["part"], e)
                    continue
                copied.setdefault(i, {}).setdefault(
                    row["partition"], []).append(row["part"])
                have += bytes_n
                src_bytes -= bytes_n
                moved["parts"] += 1
                moved["rows"] += rows_n
                moved["bytes"] += bytes_n
        if copied:
            # ONE grace window after the last ack covers every in-flight
            # fan-out, regardless of how many source nodes contributed
            time.sleep(self._migrate_grace_s())
            for i, by_part in copied.items():
                for partition, names in by_part.items():
                    nodes[i].remove_parts(partition, names)
        return dict(moved, node=name)

    def cluster_status(self) -> dict:
        """Topology worksheet for /internal/cluster/nodes."""
        return {"nodes": [{"name": n.name, "healthy": n.healthy,
                           "draining": n.name in self._draining}
                          for n in self.nodes],
                "replicationFactor": self.rf,
                "ringFilter": self.ring_filter_active}

    @property
    def search_fanouts(self) -> int:
        """Read fan-outs launched by this vmselect (one per scatter-
        gather, regardless of node count) — the O(distinct expressions)
        fleet guard's observable."""
        return self._search_fanouts.get()

    def metrics(self):
        return {"vm_cluster_nodes": len(self.nodes),
                "vm_cluster_rows_sent_total": self.rows_sent,
                "vm_cluster_reroutes_total": self.reroutes,
                "vm_cluster_search_fanouts_total": self.search_fanouts,
                "vm_cluster_healthy_nodes":
                    sum(1 for n in self.nodes if n.healthy)}

    def close(self):
        # snapshot under the topology lock: nodes constructed by a
        # join handler thread are published under it (_set_nodes), and
        # this acquire is the happens-before edge that makes their
        # freshly-initialized client state visible here
        with self._lock:
            nodes = self.nodes
        for n in nodes:
            n.close()
