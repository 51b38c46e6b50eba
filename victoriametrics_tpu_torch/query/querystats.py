"""Per-query runtime stats (reference app/vmselect/promql/active_queries.go
+ lib/querystats): the in-flight query registry behind
``/api/v1/status/active_queries``, the last-N query-stats ring behind
``/api/v1/status/top_queries``, and the slow-query log behind
``/api/v1/status/slow_queries`` (the vmselect
``-search.logSlowQueryDuration`` behavior, kept queryable instead of
only logged).

All register themselves with the self-metrics registry
(``vm_active_queries``, ``vm_search_queries_total``,
``vm_slow_queries_total``) so ``/metrics`` sees them too.

The port's copy of ``victoriametrics_tpu/query/querystats.py``, whole.
"""

from __future__ import annotations

import collections
import os
import threading
import weakref

from ..utils import fasttime
from ..utils import metrics as metricslib

_active_instances: "weakref.WeakSet[ActiveQueries]" = weakref.WeakSet()

metricslib.REGISTRY.gauge(
    "vm_active_queries",
    callback=lambda: sum(len(a) for a in list(_active_instances)))


class ActiveQueries:
    """In-flight query registry (app/vmselect/promql/active_queries.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._live: dict[int, dict] = {}
        _active_instances.add(self)

    def register(self, query: str, start, end, step) -> int:
        with self._lock:
            self._next += 1
            qid = self._next
            self._live[qid] = {"qid": qid, "query": query, "start": start,
                               "end": end, "step": step,
                               "t": fasttime.unix_seconds()}
            return qid

    def unregister(self, qid: int):
        with self._lock:
            self._live.pop(qid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    def snapshot(self) -> list[dict]:
        with self._lock:
            now = fasttime.unix_seconds()
            return [{**q, "duration": f"{now - q['t']:.3f}s"}
                    for q in self._live.values()]


class QueryStats:
    """Top-queries stats ring (reference lib/querystats: the last
    ``max_records`` query executions, aggregated at read time within
    ``max_lifetime_s``).  A bounded deque — old entries age out instead of
    freezing the table once an entry cap is hit."""

    #: per-record cost columns carried into the aggregation (the
    #: utils/costacc CostTracker summary keys), summed per (query,
    #: time-range) group — the most EXPENSIVE queries, not just the
    #: slowest, become findable
    _COST_FIELDS = ("samplesScanned", "bytesRead", "cpuMs",
                    "deviceBytes", "rpcBytes")

    def __init__(self, max_records: int = 20_000,
                 max_lifetime_s: float = 300.0):
        self._lock = threading.Lock()
        # ring of (query, time_range_s rounded, duration_s, cost dict,
        # unix_s)
        self._ring: collections.deque = collections.deque(
            maxlen=max_records)
        self.max_lifetime_s = max_lifetime_s
        self._queries_total = metricslib.REGISTRY.counter(
            "vm_search_queries_total")

    def record(self, query: str, time_range_s: float, duration_s: float,
               cost: dict | None = None):
        self._queries_total.inc()
        with self._lock:
            self._ring.append((query, round(time_range_s), duration_s,
                               cost, fasttime.unix_seconds()))

    def _aggregate(self) -> list[dict]:
        cutoff = fasttime.unix_seconds() - self.max_lifetime_s
        acc: dict[tuple, list] = {}
        with self._lock:
            records = list(self._ring)
        nf = len(self._COST_FIELDS)
        for q, tr, d, cost, at in records:
            if at < cutoff:
                continue
            e = acc.get((q, tr))
            if e is None:
                e = acc[(q, tr)] = [0, 0.0] + [0] * nf
            e[0] += 1
            e[1] += d
            if cost:
                for i, f in enumerate(self._COST_FIELDS):
                    e[2 + i] += cost.get(f, 0)
        out = []
        for (q, tr), e in acc.items():
            c, d = e[0], e[1]
            rec = {"query": q, "timeRangeSeconds": tr, "count": c,
                   "sumDurationSeconds": round(d, 6),
                   "avgDurationSeconds": round(d / c, 6)}
            for i, f in enumerate(self._COST_FIELDS):
                key = "sum" + f[0].upper() + f[1:]
                rec[key] = round(e[2 + i], 3) if f == "cpuMs" \
                    else int(e[2 + i])
            out.append(rec)
        return out

    _SORTERS = {"count": lambda x: -x["count"],
                "sumDuration": lambda x: -x["sumDurationSeconds"],
                "avgDuration": lambda x: -x["avgDurationSeconds"],
                # cumulative-cost orderings: CPU burned and samples
                # scanned are the two cluster-cost currencies
                "sumCpuMs": lambda x: -x["sumCpuMs"],
                "sumSamplesScanned": lambda x: -x["sumSamplesScanned"]}

    def top(self, n: int, key: str) -> list[dict]:
        items = self._aggregate()
        items.sort(key=self._SORTERS.get(key, self._SORTERS["count"]))
        return items[:n]

    def tops(self, n: int) -> dict[str, list[dict]]:
        """All three top-N orderings from ONE aggregation pass over the
        ring (the /top_queries endpoint serves all three at once)."""
        items = self._aggregate()
        out = {}
        for key, sorter in self._SORTERS.items():
            out[key] = sorted(items, key=sorter)[:n]
        return out


def slow_query_threshold_ms() -> float:
    """``VM_SLOW_QUERY_MS``: queries slower than this are retained in
    the slow-query log (default 5000, the reference's
    -search.logSlowQueryDuration=5s; <=0 disables)."""
    try:
        return float(os.environ.get("VM_SLOW_QUERY_MS", "5000"))
    except ValueError:
        return 5000.0


#: spans that CONTAIN other phase spans of the same flight ctx — the
#: whole refresh and the pool's per-task wrapper.  Reported under
#: ``containerSpansMs``, not ``phaseSplitMs``.
_CONTAINER_SPANS = frozenset({"serve:refresh", "pool:task"})


class SlowQueryLog:
    """Bounded ring of the slowest-query evidence: each record carries
    the query, its window, the measured duration, the PER-PHASE split
    reassembled from the flight recorder's cross-thread events for that
    query's context, and — when the refresh tripped a flight capture —
    the capture id, so ``/api/v1/status/slow_queries`` links straight to
    the timeline that explains the latency."""

    def __init__(self, max_records: int = 200,
                 threshold_ms: float | None = None):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max_records)
        self._threshold_ms = threshold_ms
        self._slow_total = metricslib.REGISTRY.counter(
            "vm_slow_queries_total")
        self._rejected_total = metricslib.REGISTRY.counter(
            "vm_rejected_queries_total")

    def threshold_ms(self) -> float:
        """Pinned at construction when given, else re-read from the env
        per call (tests and operators flip it without a restart)."""
        if self._threshold_ms is not None:
            return self._threshold_ms
        return slow_query_threshold_ms()

    def maybe_record(self, query: str, start: int, end: int, step: int,
                     tenant, duration_s: float, ctx: int = 0,
                     capture_id: int | None = None,
                     cost: dict | None = None) -> bool:
        """Record when duration exceeds the threshold; returns whether it
        did.  `ctx` is the query's flight context (0 = none): the
        per-phase split is summed from the ring events carrying it —
        including spans recorded on pool workers.  `cost` is the query's
        CostTracker summary (samplesScanned/bytesRead/cpuMs/...), so a
        slow record says what the query COST, not just how long it
        took."""
        th = self.threshold_ms()
        if th <= 0 or duration_s * 1e3 < th:
            return False
        self._slow_total.inc()
        phases = {}
        containers = {}
        if ctx:
            from ..utils import flightrec
            for name, sec in sorted(flightrec.phase_split(ctx).items()):
                # container spans (the whole refresh, the pool's
                # per-task wrapper) NEST the leaf phases for the same
                # ctx: kept out of phaseSplitMs so the split holds
                # disjoint phases that sum to ~wall time instead of
                # double-counting every contained window
                if name in _CONTAINER_SPANS:
                    containers[name] = round(sec * 1e3, 3)
                else:
                    phases[name] = round(sec * 1e3, 3)
        rec = {"query": query, "start": start, "end": end, "step": step,
               "tenant": f"{tenant[0]}:{tenant[1]}" if tenant else "0:0",
               "durationSeconds": round(duration_s, 6),
               "time": fasttime.unix_seconds(),
               "phaseSplitMs": phases}
        if containers:
            rec["containerSpansMs"] = containers
        if capture_id is not None:
            rec["flightCaptureId"] = capture_id
        if cost is not None:
            rec["cost"] = cost
        with self._lock:
            self._ring.append(rec)
        return True

    def record_rejected(self, query: str, start: int, end: int, step: int,
                        tenant, reason: str = "") -> None:
        """Shed-load visibility: a query REJECTED by admission control
        (TenantGate 429) enters the ring unconditionally — it never ran,
        so the duration threshold does not apply — marked
        ``rejected: true`` with the gate's reason.  Keeps shed load from
        vanishing out of the slow-query evidence trail (the gate's
        ``gate:rejected`` flight instant is the capture-side half).
        Counts ``vm_rejected_queries_total`` — NOT the slow counter: a
        shed query never ran, and a 429 storm must not trip alerts on
        ``vm_slow_queries_total``."""
        self._rejected_total.inc()
        rec = {"query": query, "start": start, "end": end, "step": step,
               "tenant": f"{tenant[0]}:{tenant[1]}" if tenant else "0:0",
               "durationSeconds": 0.0,
               "time": fasttime.unix_seconds(),
               "rejected": True,
               "reason": reason,
               "phaseSplitMs": {}}
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> list[dict]:
        """Records, newest first."""
        with self._lock:
            return list(reversed(self._ring))
