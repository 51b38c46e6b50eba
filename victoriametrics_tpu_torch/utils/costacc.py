"""Per-query resource cost accounting (the cost half of the cost-and-
profile observability plane; reference: per-query tracing +
``/api/v1/status/top_queries`` attribute every query's server-side cost).

One :class:`CostTracker` lives per query (``EvalConfig._cost``, shared
by every child config the way ``_samples_scanned`` is) and accumulates:

- ``samples``       — samples scanned by the evaluator (the
  ``count_samples`` / -search.maxSamplesPerQuery scope)
- ``storage_samples`` — samples scanned SERVER-SIDE on storage nodes,
  shipped back in the search RPC metadata frame (0 on single-node
  setups where the evaluator's own count is the storage count)
- ``part_bytes``    — raw column bytes handed back by the part fetch
  (timestamps + values, post-decode)
- ``rpc_bytes``     — decompressed RPC payload bytes received from
  storage nodes during the query's fan-out
- ``device_up`` / ``device_down`` — H2D/D2H bytes of the device plane
- ``rows``          — result rows (series) returned to the client
- per-bucket wall/CPU laps (``wall_ms`` / ``cpu_ms`` keyed by the
  existing phase-seam names: ``fetch:index_search``,
  ``fetch:assemble_native``, ``fetch:rollup``, ``cache:merge``, ...) —
  CPU measured on the THREAD clock (``time.thread_time``), so a lap
  says what the query burned, not what it waited for.

The tracker is reached from the storage/cache/device seams through a
thread-local "current tracker" (:func:`set_current`), installed by
``exec_query`` / the HTTP observability bracket / the vmstorage RPC
handlers and propagated to pool workers by ``utils/workpool`` the same
way the flight context and query tracer are.  No tracker installed ==
every hook is a cheap no-op.

Per-tenant aggregation: :func:`record_usage` folds a finished query's
tracker into the bounded per-tenant usage table behind
``/api/v1/status/usage`` and the ``vm_tenant_usage_*`` counters
(sticky tenant-label folding — the TenantGate rule — so URL-
sourced tenant ids can never grow the registry unbounded).

The port's copy of ``victoriametrics_tpu/utils/costacc.py``, whole.
"""

from __future__ import annotations

import threading
import time

from . import metrics as metricslib

_tls = threading.local()


class CostTracker:
    """One query's resource-cost accumulator.  Thread-safe: fan-out
    workers and the serving thread report into the same tracker."""

    __slots__ = ("_lock", "samples", "storage_samples", "part_bytes",
                 "rpc_bytes", "device_up", "device_down", "rows",
                 "wall_ms", "cpu_ms", "local_wall_ms", "remote_nodes",
                 "cost_partial")

    def __init__(self):
        self._lock = threading.Lock()
        self.samples = 0
        self.storage_samples = 0
        self.part_bytes = 0
        self.rpc_bytes = 0
        self.device_up = 0
        self.device_down = 0
        self.rows = 0
        self.wall_ms: dict[str, float] = {}
        self.cpu_ms: dict[str, float] = {}
        #: wall ms recorded by THIS process's laps only (merge_remote
        #: excluded): the denominator the eval:other/serve:other
        #: leftover buckets subtract from — remote nodes' laps accrue
        #: CONCURRENTLY and may sum past the local wall clock
        self.local_wall_ms = 0.0
        #: storage nodes that shipped a cost frame during the fan-out
        self.remote_nodes = 0
        #: True when at least one fan-out leg could NOT ship cost (an
        #: old-version node): totals are a lower bound, not wrong data
        self.cost_partial = False

    # -- scalar accumulators (GIL-cheap, lock for the read-modify-write) --

    def add_samples(self, n: int) -> None:
        with self._lock:
            self.samples += int(n)

    def add_part_bytes(self, n: int) -> None:
        with self._lock:
            self.part_bytes += int(n)

    def add_rpc_bytes(self, n: int) -> None:
        with self._lock:
            self.rpc_bytes += int(n)

    def add_device(self, up: int = 0, down: int = 0) -> None:
        with self._lock:
            self.device_up += int(up)
            self.device_down += int(down)

    def add_rows(self, n: int) -> None:
        with self._lock:
            self.rows += int(n)

    def lap(self, bucket: str, wall_s: float, cpu_s: float) -> None:
        """One timed lap of `bucket`: wall seconds plus the recording
        thread's CPU seconds (clamped to the wall lap — a stale stamp
        must never attribute another phase's CPU here)."""
        if wall_s < 0:
            wall_s = 0.0
        cpu_s = min(max(cpu_s, 0.0), wall_s if wall_s > 0 else cpu_s)
        with self._lock:
            self.wall_ms[bucket] = self.wall_ms.get(bucket, 0.0) \
                + wall_s * 1e3
            self.cpu_ms[bucket] = self.cpu_ms.get(bucket, 0.0) \
                + cpu_s * 1e3
            self.local_wall_ms += wall_s * 1e3

    # -- cross-RPC merge --------------------------------------------------

    def remote_dict(self) -> dict:
        """The wire shape shipped in the search RPC metadata frame.
        ``samples`` is THIS level's own scan count (a multilevel node's
        leaf counts live in its ``storage_samples`` and are NOT re-
        shipped — the parent would double-count them against the
        node's own merged-result count)."""
        with self._lock:
            return {"samples": self.samples,
                    "partBytes": self.part_bytes,
                    "rpcBytes": self.rpc_bytes,
                    "deviceUp": self.device_up,
                    "deviceDown": self.device_down,
                    "wallMs": {k: round(v, 3)
                               for k, v in self.wall_ms.items()},
                    "cpuMs": {k: round(v, 3)
                              for k, v in self.cpu_ms.items()}}

    def merge_remote(self, d: dict | None) -> None:
        """Fold one storage node's shipped cost frame in.  ``None``
        (an old-version node that shipped no cost) degrades to partial
        accounting instead of an error."""
        if not isinstance(d, dict):
            with self._lock:
                self.cost_partial = True
            return
        with self._lock:
            self.remote_nodes += 1
            # node-side samples land in storage_samples: the evaluator
            # counts the MERGED fan-out result into .samples itself, so
            # adding node samples there would double-count
            self.storage_samples += int(d.get("samples", 0))
            self.part_bytes += int(d.get("partBytes", 0))
            self.device_up += int(d.get("deviceUp", 0))
            self.device_down += int(d.get("deviceDown", 0))
            # a multilevel node's own rpc_bytes chain up too
            self.rpc_bytes += int(d.get("rpcBytes", 0))
            for k, v in (d.get("wallMs") or {}).items():
                self.wall_ms[k] = self.wall_ms.get(k, 0.0) + float(v)
            for k, v in (d.get("cpuMs") or {}).items():
                self.cpu_ms[k] = self.cpu_ms.get(k, 0.0) + float(v)

    # -- summaries --------------------------------------------------------

    def cpu_ms_total(self) -> float:
        with self._lock:
            return sum(self.cpu_ms.values())

    def wall_ms_total(self) -> float:
        with self._lock:
            return sum(self.wall_ms.values())

    def local_wall_ms_total(self) -> float:
        """Wall ms of this process's OWN laps (remote merges excluded) —
        the only valid baseline for leftover-bucket computation: merged
        per-node laps run concurrently and can sum past local wall."""
        with self._lock:
            return self.local_wall_ms

    def summary(self) -> dict:
        """The cost columns surfaced in top_queries/slow_queries and
        the bench artifact."""
        with self._lock:
            out = {"samplesScanned": self.samples,
                   "bytesRead": self.part_bytes,
                   "cpuMs": round(sum(self.cpu_ms.values()), 3),
                   "deviceBytes": self.device_up + self.device_down,
                   "rpcBytes": self.rpc_bytes,
                   "rowsReturned": self.rows,
                   "wallMsByPhase": {k: round(v, 3)
                                     for k, v in self.wall_ms.items()},
                   "cpuMsByPhase": {k: round(v, 3)
                                    for k, v in self.cpu_ms.items()}}
            if self.storage_samples:
                out["storageSamplesScanned"] = self.storage_samples
            if self.cost_partial:
                out["costPartial"] = True
            return out


# -- thread-local current tracker --------------------------------------------


def set_current(tracker: CostTracker | None) -> CostTracker | None:
    """Install `tracker` as this thread's cost sink; returns the
    previous one (restore it when the bracket exits).  Re-stamps the
    thread-CPU lap clock so the first lap never inherits another
    query's CPU."""
    prev = getattr(_tls, "current", None)
    _tls.current = tracker
    _tls.cpu0 = time.thread_time()
    return prev


def current() -> CostTracker | None:
    return getattr(_tls, "current", None)


def restamp() -> None:
    """Reset this thread's CPU lap stamp (call at the start of a lap
    chain, e.g. right after taking the wall t0 for the first phase)."""
    _tls.cpu0 = time.thread_time()


def lap(bucket: str, wall_s: float) -> None:
    """Account one phase lap to the current tracker: `wall_s` of wall
    time plus the thread-CPU delta since the previous lap/restamp on
    this thread.  No tracker installed == one TLS read."""
    tr = getattr(_tls, "current", None)
    now_cpu = time.thread_time()
    cpu0 = getattr(_tls, "cpu0", None)
    _tls.cpu0 = now_cpu
    if tr is None:
        return
    tr.lap(bucket, wall_s, now_cpu - cpu0 if cpu0 is not None else 0.0)


def add_samples(n: int) -> None:
    tr = getattr(_tls, "current", None)
    if tr is not None:
        tr.add_samples(n)


def add_part_bytes(n: int) -> None:
    tr = getattr(_tls, "current", None)
    if tr is not None:
        tr.add_part_bytes(n)


def add_rpc_bytes(n: int) -> None:
    tr = getattr(_tls, "current", None)
    if tr is not None:
        tr.add_rpc_bytes(n)


def add_device(up: int = 0, down: int = 0) -> None:
    tr = getattr(_tls, "current", None)
    if tr is not None:
        tr.add_device(up, down)


# -- per-tenant usage aggregation ---------------------------------------------

_USAGE_FIELDS = ("samplesScanned", "bytesRead", "cpuMs", "deviceBytes",
                 "rpcBytes", "rowsReturned", "queries")

#: vm_tenant_usage_* metric per usage field; cpuMs exports as seconds
#: (prometheus convention), everything else as raw units
_METRIC_NAMES = {
    "samplesScanned": "vm_tenant_usage_samples_scanned_total",
    "bytesRead": "vm_tenant_usage_bytes_read_total",
    "cpuMs": "vm_tenant_usage_cpu_seconds_total",
    "deviceBytes": "vm_tenant_usage_device_bytes_total",
    "rpcBytes": "vm_tenant_usage_rpc_bytes_total",
    "rowsReturned": "vm_tenant_usage_rows_returned_total",
    "queries": "vm_tenant_usage_queries_total",
}


class TenantUsage:
    """Bounded per-tenant cumulative resource usage: the table behind
    ``/api/v1/status/usage`` and the ``vm_tenant_usage_*`` counter
    family.  Tenant-label cardinality is bounded the sticky TenantGate
    way: the first ``max_tenants`` DISTINCT tenants get their own row
    and label set, everything later folds into ``other`` and adds no
    new keys — URL-sourced tenant ids cannot grow process memory."""

    def __init__(self, max_tenants: int = 1000):
        self._lock = threading.Lock()
        self._max = max_tenants
        self._rows: dict[tuple, dict] = {}
        self._metric_memo: dict[tuple, object] = {}

    def _row_key(self, tenant) -> tuple:
        if tenant in self._rows or len(self._rows) < self._max:
            return tenant
        return ("other",)

    def _metric(self, field: str, key: tuple):
        m = self._metric_memo.get((field, key))
        if m is None:
            label = "other" if key == ("other",) else \
                f"{key[0]}:{key[1]}"
            full = metricslib.format_name(_METRIC_NAMES[field],
                                          {"tenant": label})
            if field == "cpuMs":
                m = metricslib.REGISTRY.float_counter(full)
            else:
                m = metricslib.REGISTRY.counter(full)
            self._metric_memo[(field, key)] = m
        return m

    def record(self, tenant, tracker: CostTracker,
               summary: dict | None = None) -> None:
        """`summary` lets a caller that already built
        ``tracker.summary()`` (the HTTP bracket does, for the qstats/
        slowlog columns) pass it in instead of paying a second
        build+lock round trip on the serving hot path."""
        s = dict(summary) if summary is not None else tracker.summary()
        s["queries"] = 1
        with self._lock:
            key = self._row_key(tuple(tenant))
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = {f: 0 for f in _USAGE_FIELDS}
            for f in _USAGE_FIELDS:
                v = s.get(f, 0)
                row[f] = row[f] + v
                if f == "cpuMs":
                    self._metric(f, key).inc(v / 1e3)
                elif v:
                    self._metric(f, key).inc(int(v))

    def snapshot(self, reset: bool = False) -> list[dict]:
        """Rows sorted by cumulative CPU, most expensive tenant first.
        ``reset=True`` clears the table ATOMICALLY with the read — a
        separate snapshot()+reset() pair would silently drop any usage
        recorded between the two lock acquisitions."""
        with self._lock:
            rows = [dict(v, tenant=("other" if k == ("other",)
                                    else f"{k[0]}:{k[1]}"))
                    for k, v in self._rows.items()]
            if reset:
                self._rows.clear()
        for r in rows:
            r["cpuMs"] = round(r["cpuMs"], 3)
        rows.sort(key=lambda r: -r["cpuMs"])
        return rows

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


#: process-wide table (one per process like the metrics registry; tests
#: build private TenantUsage instances)
TENANT_USAGE = TenantUsage()


def record_usage(tenant, tracker: CostTracker | None,
                 summary: dict | None = None) -> None:
    """Fold one finished query's tracker into the per-tenant table
    (call once per query, from the serving bracket).  Pass the already-
    built ``tracker.summary()`` when the caller has one."""
    if tracker is not None:
        TENANT_USAGE.record(tenant, tracker, summary=summary)
