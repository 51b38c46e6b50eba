"""Prometheus-compatible HTTP API (reference app/vmselect/main.go:94-436
router + app/vmselect/prometheus/*.qtpl responders + app/vminsert/main.go:
134-392 ingestion endpoints), bound to one Storage + query engine.

Implements: /api/v1/{query,query_range,series,labels,label/<n>/values,
export,import,import/prometheus,write (remote-write),admin/tsdb/delete_series,
status/{tsdb,active_queries,top_queries}}, /write (influx), /api/put
(opentsdb http), /datadog/api/v{1,2}/series, /graphite ingest, federate,
/metrics, /health, /snapshot/*, /internal/force_{flush,merge},
/newrelic/infra/v2/metrics/events/bulk.

The port's copy of ``victoriametrics_tpu/httpapi/prometheus_api.py``,
with its ingest branches: remote write, Prometheus text and Influx lines
parse natively into ``native.ColumnarRows`` for
``Storage.add_rows_columnar`` (relabeling and series limits as a cached
per-series transform), the Prometheus text otherwise into raw-key rows,
and every other body through ``_add_rows``, where the stream aggregation
hook (``ingest/streamaggr.py``) sits.  The SLO plane's routes
(``/api/v1/status/health``, ``/slo``, ``/incidents``) serve
``query/sloplane.py``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import re
import threading
import time

import numpy as np

import struct

from ..ingest import parsers, remote_write
from ..ingest.otlp import parse_otlp
from ..query.exec import exec_instant, exec_query, parse_cached
from ..query.eval import QueryError, filter_sets_from_metric_expr
from ..query.metricsql import parse as mql_parse
from ..query.metricsql.ast import MetricExpr
from ..query.metricsql.parser import ParseError, parse_duration_ms
from ..parallel.rpc import ClusterUnavailableError, PartialResultError
from ..query.querystats import ActiveQueries, QueryStats, SlowQueryLog
from ..query.types import EvalConfig
from ..storage.metric_name import MetricName
from ..utils import fasttime, flightrec, logger
from ..utils import metrics as metricslib
from ..utils.workpool import SearchLimitError
from .server import HTTPServer, Request, Response, StreamingResponse

#: scatter-gather responses that came back incomplete (a storage node
#: was down/slow) — whether served as isPartial=true or denied as 503
_PARTIAL_TOTAL = metricslib.REGISTRY.counter("vm_partial_results_total")


def parse_time(s: str, default_ms: int) -> int:
    if not s:
        return default_ms
    try:
        return int(float(s) * 1000)
    except ValueError:
        pass
    if s.startswith("-"):
        # relative time: "-1h" = now minus duration (reference supports this)
        try:
            ms, step_based = parse_duration_ms(s[1:])
            if not step_based and ms > 0:
                return fasttime.unix_ms() - int(ms)
        except ValueError:
            pass
    try:
        dt = datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))
        return int(dt.timestamp() * 1000)
    except ValueError:
        raise QueryError(f"cannot parse time {s!r}")


def parse_step(s: str, default_ms: int = 60_000) -> int:
    if not s:
        return default_ms
    try:
        return max(int(float(s) * 1000), 1)
    except ValueError:
        pass
    try:
        ms, step_based = parse_duration_ms(s)
        if not step_based and ms > 0:
            return int(ms)
    except ValueError:
        pass
    raise QueryError(f"cannot parse step {s!r}")


from ..query.format_value import fmt_value as _fmt_value  # noqa: E402


class ConcurrencyGate:
    """Query concurrency limiter with a bounded wait queue (reference
    app/vmselect/main.go:49-92: 2xCPU capped at 16, -search.maxQueueDuration
    timeout returning 429 + Retry-After, like the reference)."""

    def __init__(self, max_concurrent: int | None = None,
                 max_queue_duration_s: float = 10.0):
        if max_concurrent is None:
            from ..utils.memory import available_cpus
            max_concurrent = min(2 * available_cpus(), 16)
        self._sem = threading.Semaphore(max_concurrent)
        self.max_concurrent = max_concurrent
        self.max_queue_duration_s = max_queue_duration_s
        # per-instance thread-safe counter (several APIs per test process;
        # exposed as vm_concurrent_select_limit_reached_total in metrics())
        self._rejected = metricslib.Counter("rejected")

    @property
    def rejected(self) -> int:
        return self._rejected.get()

    def __enter__(self):
        if not self._sem.acquire(timeout=self.max_queue_duration_s):
            self._rejected.inc()
            raise TimeoutError(
                f"query queue wait exceeded {self.max_queue_duration_s}s "
                f"({self.max_concurrent} concurrent queries)")
        return self

    def __exit__(self, *exc):
        self._sem.release()


def _device_window_ready(ec, q: str) -> bool:
    """Does the device plane hold a resident rolling window able to serve
    this query O(new samples)?  Parse failures answer False (the normal
    path will surface the error with its usual handling)."""
    from ..query.eval import device_window_ready
    try:
        return device_window_ready(ec, parse_cached(q))
    except Exception:
        return False


class PrometheusAPI:
    def __init__(self, storage, tpu_engine=None, lookback_delta=300_000,
                 max_series=1_000_000, relabel_configs=None,
                 stream_aggr=None, stream_aggr_keep_input=False,
                 max_concurrent_queries=None, series_limits=None,
                 max_samples_per_query=1_000_000_000,
                 max_memory_per_query=0, max_query_duration_ms=30_000,
                 rate_limiter=None):
        self.storage = storage
        # ingest.ratelimiter.TenantRateLimiters (-maxIngestionRate analog)
        self.rate_limiter = rate_limiter
        self.tpu = tpu_engine
        self.lookback_delta = lookback_delta
        self.max_series = max_series
        self.max_samples_per_query = max_samples_per_query
        self.max_memory_per_query = max_memory_per_query
        self.max_query_duration_ms = max_query_duration_ms
        self.default_tenant = (0, 0)
        self.relabel = relabel_configs   # ingest.relabel.ParsedConfigs
        self.stream_aggr = stream_aggr   # ingest.streamaggr.StreamAggregators
        self.stream_aggr_keep_input = stream_aggr_keep_input
        self.series_limits = series_limits  # ingest.serieslimits.SeriesLimits
        self.columnar_drop_stats: dict = {}
        self.active = ActiveQueries()
        self.qstats = QueryStats()
        self.slowlog = SlowQueryLog()
        self.gate = ConcurrencyGate(max_concurrent_queries)
        # materialized streams + subscription push (query/matstream):
        # one evaluator per distinct expression, suffix deltas fanned to
        # every /api/v1/watch subscriber and vmalert rule group
        from ..query.matstream import MatStreamRegistry
        self.matstreams = MatStreamRegistry(self)
        self.started_at = fasttime.unix_seconds()
        self.rows_inserted = 0
        self.rows_relabel_dropped = 0
        # TYPE/HELP metadata (lib/storage/metricsmetadata analog) and
        # per-metric-name query usage stats (lib/storage/metricnamestats)
        self.metadata: dict[str, dict] = {}
        self.tenant_rows: dict[str, int] = {}
        self.name_usage: dict[str, list] = {}  # name -> [count, last_ts]
        # SLO plane (query/sloplane): lazily built — the engine only
        # spends cycles when pumped (self-scrape on_tick or ?pump=1)
        self.sloplane = None
        self._role = "vmsingle"

    # the columnar ingest path caches relabel/series-limit VERDICTS per raw
    # series key (Storage.add_rows_columnar transform), so any config swap
    # must invalidate those caches — property setters make hot-reload
    # (`self.relabel = ...` on SIGHUP) safe without extra call sites
    @property
    def relabel(self):
        return self._relabel

    @relabel.setter
    def relabel(self, v):
        self._relabel = v
        self._reset_columnar()

    @property
    def series_limits(self):
        return self._series_limits

    @series_limits.setter
    def series_limits(self, v):
        self._series_limits = v
        self._reset_columnar()

    def _reset_columnar(self):
        st = getattr(self, "storage", None)
        if st is not None and getattr(st, "supports_columnar", False):
            st.reset_columnar_spaces()

    # -- wiring ------------------------------------------------------------

    def register(self, srv: HTTPServer, mode: str = "all"):
        """mode: 'all' (vmsingle), 'insert' (vminsert), 'select' (vmselect)
        — mirrors the reference's one-codebase three-role composition."""
        self.srv = srv
        self._role = {"all": "vmsingle", "insert": "vminsert",
                      "select": "vmselect"}.get(mode, mode)
        srv.route("/api/v1/status/health", self.h_health)
        if mode in ("all", "insert"):
            self._register_insert(srv)
            srv.route("/insert/", self._mt_dispatch)
        if mode in ("all", "select"):
            self._register_select(srv)
            srv.route("/select/", self._mt_dispatch)
            srv.route("/admin/tenants", self.h_tenants)
        if mode in ("all", "select"):
            srv.route("/vmui", self.h_vmui)
            srv.route("/vmui/", self.h_vmui)
        srv.route("/metrics", self.h_metrics)
        srv.route("/flags", self.h_flags)
        srv.route("/internal/faults", self.h_faults)
        srv.route("/debug/pprof/", self.h_pprof)
        srv.route("/health", lambda req: Response.text("OK"))
        srv.route("/-/healthy", lambda req: Response.text("OK"))
        srv.route("/-/ready", lambda req: Response.text("OK"))

    def _register_insert(self, srv: HTTPServer):
        r = srv.route
        r("/api/v1/write", self.h_remote_write)
        r("/api/v1/push", self.h_remote_write)
        r("/prometheus/api/v1/write", self.h_remote_write)
        r("/api/v1/import", self.h_import)
        r("/api/v1/import/native", self.h_import_native)
        r("/api/v1/import/prometheus", self.h_import_prometheus)
        r("/api/v1/import/csv", self.h_import_csv)
        r("/write", self.h_influx_write)
        r("/influx/write", self.h_influx_write)
        r("/api/put", self.h_opentsdb_http)
        r("/zabbixconnector/api/v1/history", self.h_zabbix)
        r("/opentsdb/api/put", self.h_opentsdb_http)
        r("/graphite", self.h_graphite_write)
        r("/datadog/api/v1/series", self.h_datadog_v1)
        r("/datadog/api/v2/series", self.h_datadog_v2)
        r("/datadog/api/v1/validate", lambda req: Response.json({"valid": True}))
        r("/newrelic/infra/v2/metrics/events/bulk", self.h_newrelic)
        r("/opentelemetry/v1/metrics", self.h_otlp)
        r("/opentelemetry/api/v1/push", self.h_otlp)
        r("/v1/metrics", self.h_otlp)

    def _register_select(self, srv: HTTPServer):
        r = srv.route
        r("/api/v1/query", self.h_query)
        r("/api/v1/query_range", self.h_query_range)
        r("/api/v1/watch", self.h_watch)
        r("/api/v1/series", self.h_series)
        r("/api/v1/labels", self.h_labels)
        r("/api/v1/label/", self.h_label_values)
        r("/api/v1/export", self.h_export)
        r("/api/v1/read", self.h_remote_read)
        r("/api/v1/export/native", self.h_export_native)
        r("/api/v1/admin/tsdb/delete_series", self.h_delete_series)
        r("/api/v1/status/tsdb", self.h_status_tsdb)
        r("/api/v1/status/active_queries", self.h_active_queries)
        r("/api/v1/status/top_queries", self.h_top_queries)
        r("/api/v1/status/slow_queries", self.h_slow_queries)
        r("/api/v1/status/flight", self.h_flight)
        r("/api/v1/status/quarantine", self.h_quarantine)
        r("/api/v1/status/usage", self.h_usage)
        r("/api/v1/status/profile", self.h_profile)
        r("/api/v1/status/slo", self.h_slo)
        r("/api/v1/status/incidents", self.h_incidents)
        r("/metric-relabel-debug", self.h_relabel_debug)
        r("/prettify-query", self.h_prettify_query)
        r("/expand-with-exprs", self.h_prettify_query)  # WITH folding is
        # part of parsing: the canonical string has templates expanded
        r("/api/v1/parse-query", self.h_query_ast)
        r("/api/v1/metadata", self.h_metadata)
        r("/api/v1/status/metric_names_stats", self.h_name_stats)
        r("/api/v1/admin/status/metric_names_stats/reset",
          self.h_reset_name_stats)
        r("/federate", self.h_federate)
        if hasattr(self.storage, "create_snapshot"):
            r("/snapshot/create", self.h_snapshot_create)
            r("/snapshot/list", self.h_snapshot_list)
            r("/snapshot/delete", self.h_snapshot_delete)
            r("/snapshot/delete_all", self.h_snapshot_delete_all)
        if hasattr(self.storage, "force_flush"):
            r("/internal/force_flush", self.h_force_flush)
            r("/internal/force_merge", self.h_force_merge)

    # -- query -------------------------------------------------------------

    def _tenant(self, req) -> tuple:
        """Per-request tenant: set by the multitenant path router
        (/insert|/select/<accountID[:projectID]>/..., lib/auth.Token)."""
        return getattr(req, "tenant", None) or self.default_tenant

    def _deny_partial(self, req) -> bool:
        """-search.denyPartialResponse semantics per request: the
        ``deny_partial`` query arg wins (1/0), else the
        ``VM_DENY_PARTIAL_RESPONSE`` env default."""
        import os as _os
        v = req.arg("deny_partial")
        if v:
            return v not in ("0", "false", "no")
        return _os.environ.get("VM_DENY_PARTIAL_RESPONSE", "") \
            not in ("", "0", "false", "no")

    def _partial_guard(self, req) -> Response | None:
        """Partial-result accounting + the deny_partial 503: returns the
        error response to serve instead of a silently incomplete 200,
        or None to proceed.  Call right after a successful exec."""
        if not bool(getattr(self.storage, "last_partial", False)):
            return None
        _PARTIAL_TOTAL.inc()
        if not self._deny_partial(req):
            return None
        return Response.error(
            "partial response denied: one or more storage nodes did not "
            "answer (deny_partial=1 / VM_DENY_PARTIAL_RESPONSE; retry or "
            "allow partial results)", 503, "unavailable")

    def _reject_query(self, e: SearchLimitError, q: str, start: int,
                      end: int, step: int, req: Request) -> Response:
        """Shed-load surface: a TenantGate rejection becomes a 429 +
        Retry-After (the ingest limiter's rejection contract) AND a
        rejected record in the slow-query log, so shed queries stay
        visible at /api/v1/status/slow_queries and (via the gate's
        ``gate:rejected`` flight instant) /api/v1/status/flight."""
        self.slowlog.record_rejected(q, start, end, step,
                                     self._tenant(req), str(e))
        resp = Response.error(str(e), 429, "too_many_requests")
        resp.headers["Retry-After"] = str(e.retry_after_s)
        return resp

    def _mt_dispatch(self, req: Request) -> Response:
        """Cluster-style multitenant routing (lib/auth.NewToken +
        app/vmselect/main.go:262 /select/<tenant>/prometheus/...,
        app/vminsert/main.go /insert/<tenant>/<proto>)."""
        parts = req.path.split("/", 3)
        if len(parts) < 4 or not parts[3]:
            return Response.error(f"missing tenant path suffix in "
                                  f"{req.path!r}", 400)
        tstr, rest = parts[2], "/" + parts[3]
        try:
            if ":" in tstr:
                a, p = tstr.split(":", 1)
                tenant = (int(a), int(p))
            else:
                tenant = (int(tstr), 0)
        except ValueError:
            return Response.error(f"cannot parse tenant {tstr!r} "
                                  f"(want accountID[:projectID])", 400)
        if not (0 <= tenant[0] < 2**32 and 0 <= tenant[1] < 2**32):
            return Response.error(f"tenant ids out of uint32 range: {tstr}",
                                  400)
        # cluster URLs nest the protocol: /select/0/prometheus/api/v1/query,
        # /insert/0/prometheus/api/v1/write, /insert/0/influx/write
        if rest.startswith("/prometheus/"):
            rest = rest[len("/prometheus"):]
        elif rest.startswith("/influx/"):
            rest = rest[len("/influx"):]
        elif rest.startswith("/opentsdb/"):
            rest = rest[len("/opentsdb"):]
        elif rest.startswith("/graphite/"):
            rest = rest[len("/graphite"):]
        req.tenant = tenant
        req.path = rest
        fn = self.srv._route_for(rest)
        if fn is None or getattr(fn, "__func__", None) is \
                PrometheusAPI._mt_dispatch:
            return Response.error(f"unsupported path {rest}", 404,
                                  "not_found")
        return fn(req)

    def h_vmui(self, req: Request) -> Response:
        """Static explorer (the reference serves the React vmui bundle at
        app/vmselect/main.go:438; this is a dependency-free equivalent
        with query/graph/table/JSON tabs + cardinality + top queries)."""
        import os as _os
        path = _os.path.join(_os.path.dirname(__file__), "vmui.html")
        with open(path, "rb") as f:
            return Response(200, f.read(), "text/html; charset=utf-8")

    def h_tenants(self, req: Request) -> Response:
        """List tenants with stored data (the vmselect /admin/tenants API,
        app/vmselect/main.go:229 + vmselectapi tenants_v1)."""
        tenants = self.storage.tenants() if hasattr(self.storage, "tenants") \
            else [(0, 0)]
        return Response.json({"status": "success",
                              "data": [f"{a}:{p}" for a, p in tenants]})

    def _ec(self, start, end, step, tenant=(0, 0)) -> EvalConfig:
        import time as _t
        deadline = (_t.monotonic() + self.max_query_duration_ms / 1e3
                    if self.max_query_duration_ms > 0 else 0.0)
        return EvalConfig(start=start, end=end, step=step,
                          storage=self.storage,
                          lookback_delta=self.lookback_delta,
                          max_series=self.max_series, tpu=self.tpu,
                          max_samples_per_query=self.max_samples_per_query,
                          max_memory_per_query=self.max_memory_per_query,
                          deadline=deadline, tenant=tenant)

    @contextlib.contextmanager
    def _query_observability(self, req: Request, q: str, qt, qid: int,
                             start: int, end: int, step: int, ec=None):
        """One query's observability bracket, shared by h_query and
        h_query_range: install the tracer + a fresh flight context (so
        spans recorded anywhere — this thread or pool workers — carry
        the query's ctx and the slow-query log can reassemble the
        per-phase split) + the query's CostTracker (so storage/cache/
        device seams account into it even outside exec_query); on exit
        restore all three, unregister the active query, fold the cost
        into the per-tenant usage table and feed qstats + the
        slow-query log (cost columns included), attaching any flight
        capture the eval noted."""
        from ..utils import costacc, querytracer
        fctx = flightrec.new_ctx()
        prev_ctx = flightrec.set_ctx(fctx)
        prev_tr = querytracer.set_current(qt)
        cost = ec._cost if ec is not None else None
        prev_cost = costacc.set_current(cost)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            costacc.set_current(prev_cost)
            querytracer.set_current(prev_tr)
            flightrec.set_ctx(prev_ctx)
            self.active.unregister(qid)
            dur = time.perf_counter() - t0
            summary = cost.summary() if cost is not None else None
            costacc.record_usage(self._tenant(req), cost, summary=summary)
            self.qstats.record(q, (end - start) / 1e3, dur, cost=summary)
            self.slowlog.maybe_record(
                q, start, end, step, self._tenant(req), dur, ctx=fctx,
                capture_id=flightrec.take_noted_capture(), cost=summary)

    def h_query(self, req: Request) -> Response:
        q = req.arg("query")
        if not q:
            return Response.error("missing 'query' arg")
        now = fasttime.unix_ms()
        try:
            ts = parse_time(req.arg("time"), now)
            step = parse_step(req.arg("step"), 300_000)
        except QueryError as e:
            # bad time=/step= args are the client's mistake: 400, not
            # an escape to the boundary's anonymous 500 (VMT016)
            return Response.error(str(e))
        qid = self.active.register(q, ts, ts, step)
        if hasattr(self.storage, "reset_partial"):
            self.storage.reset_partial()
        from ..utils import querytracer
        qt = querytracer.new(req.arg("trace") == "1", "query %s time=%d",
                             q, ts)
        try:
            ec = self._ec(ts, ts, step, self._tenant(req))
            ec.tracer = qt
            with self._query_observability(req, q, qt, qid, ts, ts, step,
                                           ec=ec):
                with self.gate:
                    rows = exec_query(ec, q)
                ec._cost.add_rows(len(rows))
                self._track_usage(rows)
        except TimeoutError as e:
            resp = Response.error(str(e), 429, "too_many_requests")
            resp.headers["Retry-After"] = "10"
            return resp
        except SearchLimitError as e:
            return self._reject_query(e, q, ts, ts, step, req)
        except PartialResultError as e:
            _PARTIAL_TOTAL.inc()
            return Response.error(str(e), 503, "unavailable")
        except ClusterUnavailableError as e:
            return Response.error(str(e), 503, "unavailable")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))
        denied = self._partial_guard(req)
        if denied is not None:
            return denied
        result = []
        for r in rows:
            v = r.values[-1]
            if math.isnan(v):
                continue
            result.append({"metric": r.metric_name.to_dict(),
                           "value": [ts / 1e3, _fmt_value(v)]})
        qt.donef("%d result series", len(result))
        body = {"status": "success",
                "isPartial": bool(getattr(self.storage, "last_partial",
                                          False)),
                "partialResolution": bool(getattr(
                    self.storage, "last_partial_resolution", False)),
                "data": {"resultType": "vector", "result": result}}
        if qt.enabled:
            body["trace"] = qt.to_dict()
        return Response.json(body)

    def h_query_range(self, req: Request) -> Response:
        q = req.arg("query")
        if not q:
            return Response.error("missing 'query' arg")
        now = fasttime.unix_ms()
        try:
            start = parse_time(req.arg("start"), now - 300_000)
            end = parse_time(req.arg("end"), now)
            step = parse_step(req.arg("step"))
        except QueryError as e:
            # bad start=/end=/step= args are the client's mistake: 400,
            # not an escape to the boundary's anonymous 500 (VMT016)
            return Response.error(str(e))
        if end < start:
            return Response.error("end < start")
        # align the grid to the step (AdjustStartEnd analog): start rounds
        # DOWN (phase-stable for the rollup cache), end rounds UP so the
        # freshest samples stay inside the last window
        start -= start % step
        end = start + -(-(end - start) // step) * step
        qid = self.active.register(q, start, end, step)
        if hasattr(self.storage, "reset_partial"):
            self.storage.reset_partial()
        from ..utils import querytracer
        qt = querytracer.new(req.arg("trace") == "1",
                             "query_range %s start=%d end=%d step=%d",
                             q, start, end, step)
        try:
            ec = self._ec(start, end, step, self._tenant(req))
            ec.tracer = qt
            with self._query_observability(req, q, qt, qid,
                                           start, end, step, ec=ec):
                with self.gate:
                    if req.arg("nocache") == "1":
                        # reference -search.disableCache / nocache=1 arg
                        ec.disable_cache = True
                        rows = exec_query(ec, q)
                    else:
                        rows = self._exec_range_cached(ec, q, now)
                ec._cost.add_rows(len(rows))
                self._track_usage(rows)
        except TimeoutError as e:
            resp = Response.error(str(e), 429, "too_many_requests")
            resp.headers["Retry-After"] = "10"
            return resp
        except SearchLimitError as e:
            return self._reject_query(e, q, start, end, step, req)
        except PartialResultError as e:
            _PARTIAL_TOTAL.inc()
            return Response.error(str(e), 503, "unavailable")
        except ClusterUnavailableError as e:
            return Response.error(str(e), 503, "unavailable")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))
        denied = self._partial_guard(req)
        if denied is not None:
            return denied
        grid = ec.timestamps() / 1e3
        result = []
        for r in rows:
            vals = [[float(t), _fmt_value(v)]
                    for t, v in zip(grid, r.values) if not math.isnan(v)]
            if vals:
                result.append({"metric": r.metric_name.to_dict(),
                               "values": vals})
        qt.donef("%d result series", len(result))
        body = {"status": "success",
                "isPartial": bool(getattr(self.storage, "last_partial",
                                          False)),
                "partialResolution": bool(getattr(
                    self.storage, "last_partial_resolution", False)),
                "data": {"resultType": "matrix", "result": result}}
        if qt.enabled:
            body["trace"] = qt.to_dict()
        return Response.json(body)

    def h_watch(self, req: Request) -> Response:
        """Materialized-stream subscription push (``/api/v1/watch?query=
        ...&step=...&range=...``): the dashboard holds ONE subscription
        and receives SSE suffix frames instead of re-issuing
        ``query_range`` — the per-interval evaluation is shared by every
        subscriber of the same canonical expression (storage reads per
        interval are O(distinct expressions), not O(subscribers)).

        Args: ``query`` (range expression), ``step`` (grid step,
        default 1m), ``range`` (rolling window length, e.g. ``30m``) or
        a ``start``/``end`` pair whose span defines it, ``max_frames``
        (close after N frames — test/CLI hygiene; 0 = until
        disconnect), ``heartbeat`` (idle keepalive seconds, default 15).
        First frame is a full snapshot (replayed from the warm stream
        when one exists), then deltas.  503 when VM_MATSTREAM=0.

        Reconnect/resume: every SSE event carries ``id:
        <epoch>:<seq>``; a dropped dashboard re-attaches with the
        standard ``Last-Event-ID`` header (or ``resume=`` arg) and
        receives only the missed suffix frames — bounded by
        ``VM_MATSTREAM_QUEUE`` retained frames; an older/foreign token
        degrades loudly to one resync snapshot
        (``vm_matstream_resume_misses_total``)."""
        from ..query import matstream
        if not matstream.enabled():
            return Response.error(
                "materialized streams disabled (VM_MATSTREAM=0)", 503,
                "unavailable")
        q = req.arg("query")
        if not q:
            return Response.error("missing 'query' arg")
        try:
            step = parse_step(req.arg("step"))
            rng = req.arg("range")
            if rng:
                duration = parse_step(rng, 0)
            else:
                now = fasttime.unix_ms()
                start = parse_time(req.arg("start"), now - 300_000)
                end = parse_time(req.arg("end"), now)
                duration = max(end - start, step)
            max_frames = int(req.arg("max_frames", "0") or 0)
            # floor 0.2s: heartbeat=0 would turn the frame loop into a
            # hot keepalive spin (one queue poll + socket write per
            # iteration) — a one-request CPU DoS
            heartbeat = min(max(
                float(req.arg("heartbeat", "15") or 15), 0.2), 3600.0)
        except (QueryError, ValueError) as e:
            return Response.error(str(e))
        resume = req.arg("resume") or \
            (getattr(req, "headers", {}).get("Last-Event-ID") or "").strip()
        try:
            sub = self.matstreams.subscribe(q, step, duration,
                                            self._tenant(req),
                                            resume=resume or None)
        except matstream.MatStreamLimitError as e:
            resp = Response.error(str(e), 429, "too_many_requests")
            resp.headers["Retry-After"] = "10"
            return resp
        except matstream.MatStreamDisabled as e:
            # the enabled() pre-check above races a live VM_MATSTREAM
            # flip: subscribe re-checks under the registry lock, so map
            # the raise too — same 503 as the pre-check path (VMT016)
            return Response.error(str(e), 503, "unavailable")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

        def frames():
            sent = 0
            try:
                while True:
                    f = sub.next_frame(timeout_s=heartbeat)
                    if f is None:
                        if sub.closed:
                            return
                        yield b": keepalive\n\n"
                        continue
                    # frames are SHARED dicts (one per advance, fanned
                    # to every subscriber): encode once process-wide,
                    # not once per subscriber.  The id line is the
                    # resume token Last-Event-ID echoes back.
                    yield (b"event: frame\nid: " +
                           sub.stream.resume_token(f).encode() +
                           b"\ndata: " +
                           matstream.encode_frame(f) + b"\n\n")
                    sent += 1
                    if max_frames and sent >= max_frames:
                        return
            finally:
                sub.close()
        # on_close covers the never-started-generator disconnect (the
        # generator's own finally can't run then) — close() is
        # idempotent, so the normal path closing twice is harmless
        return StreamingResponse(frames(),
                                 content_type="text/event-stream",
                                 on_close=sub.close)

    # queries calling non-deterministic / wall-clock functions bypass the
    # rollup-result cache; \b keeps avg_over_time( from matching time(
    _UNCACHEABLE_RE = re.compile(
        r"\b(?:rand|rand_normal|rand_exponential|now|time)\s*\(")

    def _exec_range_cached(self, ec, q: str, now_ms: int):
        # serve-priority window: background flush/merge admission yields
        # to in-flight serving (workpool.MergeGate) for the WHOLE refresh,
        # not just the storage-fetch slice the SearchGate covers
        from ..utils import workpool
        # a flight context per refresh (reuse the HTTP handler's when one
        # is installed — bench and tests call this directly)
        fctx = flightrec.get_ctx()
        fresh_ctx = fctx == 0
        if fresh_ctx:
            fctx = flightrec.new_ctx()
            flightrec.set_ctx(fctx)
        # the whole refresh accounts into the query's CostTracker — the
        # HTTP bracket installs it too (re-install is idempotent), but
        # direct callers (bench, tests) get the cache merge/put laps
        # only through this install
        from ..utils import costacc
        prev_cost = costacc.set_current(ec._cost)
        w0 = ec._cost.local_wall_ms_total()
        t0 = time.perf_counter()
        try:
            with workpool.serving():
                return self._exec_range_cached_serving(ec, q, now_ms)
        finally:
            dur = time.perf_counter() - t0
            # refresh wall not claimed by any LOCAL phase/eval lap
            # (cache get, row sort/filter, result handling) gets its own
            # named bucket — the bench's >=90%-accounted honesty ratio
            # counts glue it can SEE, not glue that vanished.  Local-lap
            # baseline only: merged remote laps are concurrent
            inner_ms = ec._cost.local_wall_ms_total() - w0
            if dur * 1e3 > inner_ms:
                costacc.lap("serve:other", dur - inner_ms / 1e3)
            costacc.set_current(prev_cost)
            flightrec.rec("serve:refresh", t0, dur, arg=q[:200])
            if fresh_ctx:
                flightrec.clear_ctx()
            # slow-refresh trigger: freeze the cross-thread timeline that
            # explains THIS refresh while it is still in the rings
            th = flightrec.slow_refresh_threshold_ms()
            if th > 0 and dur * 1e3 > th:
                cap = flightrec.RECORDER.capture(
                    "slow_refresh",
                    meta={"query": q[:500], "refresh_ms": round(dur * 1e3, 2),
                          "threshold_ms": th, "ctx": fctx},
                    # only the ring snapshot races the writers; building
                    # the trace JSON + summary waits for first retrieval
                    # so the capture cost is not charged to the very
                    # refresh latency that tripped it (observer effect)
                    defer_build=True)
                # note the id only when an outer handler frame exists to
                # consume it (fresh_ctx means a direct call — bench and
                # tests — where a leftover note would misattach to the
                # NEXT slow query this thread happens to serve)
                if cap is not None and not fresh_ctx:
                    flightrec.note_capture(cap["id"])

    def _exec_range_cached_serving(self, ec, q: str, now_ms: int):
        from ..query.rollup_result_cache import GLOBAL as rcache
        cacheable = (ec.n_points > 1
                     and not self._UNCACHEABLE_RE.search(q))
        if not cacheable:
            return exec_query(ec, q)
        if ec.tpu is not None and _device_window_ready(ec, q):
            # device-resident serving: the device plane holds a rolling
            # window for this query shape, so the FULL eval is O(new
            # samples) — advance_rolling fetches/uploads only the tail
            # columns and the [G, T] ring reuses every covered column.
            # The host ring cache still gets the put() below, so a later
            # device decline falls back to the host suffix path with a
            # warm prefix instead of a cold rebuild.
            ec.tracer.printf("device window resident: full eval")
            rows = exec_query(ec, q)
            if not getattr(self.storage, "last_partial", False):
                rcache.put(ec, q, rows, now_ms, trust_raw=False)
            return rows
        cached, new_start = rcache.get(ec, q, now_ms)
        if cached is not None and new_start > ec.end:
            ec.tracer.printf("rollup cache: full hit")
            # same shape as the partial-hit return below: an in-place
            # merge keeps append-ordered rows (and all-NaN churned rows)
            # in the entry, and its stamped no-op put() skips the
            # caller's filter+sort — re-apply both so full hits match
            # the partial-hit rows (and the ring-off oracle) exactly
            rows = [r for r in cached.rows()
                    if not np.isnan(r.values).all()]
            rows.sort(key=lambda ts: ts.raw)
            return rows
        if cached is not None:
            ec.tracer.printf("rollup cache: partial hit, computing from %d",
                             new_start)
            # single-column tails widen by one leading column (dropped
            # after the eval): a one-point grid would flip rollups into
            # instant-query maxPrevInterval semantics (rollup.go:719-728)
            from ..query.eval import suffix_child_bounds, trim_suffix_rows
            sub_start, trim = suffix_child_bounds(ec, new_start)
            sub = ec.child(start=sub_start)
            sub.tracer = ec.tracer
            # the device rolling tail-reuse must not layer under this
            # cache's own tail merge (see EvalConfig.no_device_roll)
            sub.no_device_roll = True
            # the tail sub-eval must not read or write eval-level cache
            # entries under its own short window: a widened single-column
            # sub has n_points=2, and its put() would replace a
            # full-coverage inner entry with a 2-column one (same guard
            # as the eval-level suffix subs, eval.py "must not clobber")
            sub.no_eval_cache = True
            fresh = exec_query(sub, q)
            if trim:
                fresh = trim_suffix_rows(fresh)
            # trust_raw=False: these are POST-transform rows — in-place
            # label edits (multi-output rollups, label_set, binop
            # keep_metric_names) leave Timeseries.raw stale, so identity
            # must come from a fresh marshal here
            rows = rcache.merge(cached, fresh, ec, new_start,
                                trust_raw=False, now_ms=now_ms)
            rows = [r for r in rows
                    if not np.isnan(r.values).all()]
            # merge() just attached authoritative raws to exactly these
            # rows — reuse them for the sort and let put() trust them
            # (no further name mutation happens between here and put)
            rows.sort(key=lambda ts: ts.raw)
            trust = True
        else:
            rows = exec_query(ec, q)
            trust = False
        if not getattr(self.storage, "last_partial", False):
            # never cache partial cluster results: a later hit would present
            # incomplete data as complete with isPartial=false
            rcache.put(ec, q, rows, now_ms, trust_raw=trust)
        return rows

    # -- metadata ----------------------------------------------------------

    def _matches_to_filters(self, req: Request):
        out = []
        for m in req.args("match[]") or req.args("match"):
            e = mql_parse(m)
            if not isinstance(e, MetricExpr):
                raise QueryError(f"match[] must be a series selector: {m}")
            # multiple match[] values are already a union, so a selector's
            # OR'd filter sets expand into extra entries
            out.extend(filter_sets_from_metric_expr(e))
        return out

    def _time_range(self, req: Request, full_default: bool = False):
        """Default range: last 30 days for metadata APIs, everything for
        export (the reference exports the full retention by default)."""
        now = fasttime.unix_ms()
        default_start = 0 if full_default else now - 86_400_000 * 30
        start = parse_time(req.arg("start"), default_start)
        end = parse_time(req.arg("end"), now)
        return start, end

    def h_series(self, req: Request) -> Response:
        try:
            fl = self._matches_to_filters(req)
            start, end = self._time_range(req)
            if not fl:
                return Response.error("missing match[] arg")
            out = []
            seen = set()
            limit = int(req.arg("limit", "0") or 0) or (1 << 31)
            for filters in fl:
                if len(out) >= limit:
                    break
                for mn in self.storage.search_metric_names(
                        filters, start, end, tenant=self._tenant(req)):
                    raw = mn.marshal()
                    if raw not in seen:
                        seen.add(raw)
                        out.append(mn.to_dict())
                        if len(out) >= limit:
                            break
            return Response.json({"status": "success", "data": out})
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

    def h_labels(self, req: Request) -> Response:
        try:
            start, end = self._time_range(req)
        except QueryError as e:
            return Response.error(str(e))
        return Response.json({"status": "success",
                              "data": self.storage.label_names(
                                  start, end, tenant=self._tenant(req))})

    def h_label_values(self, req: Request) -> Response:
        m = re.fullmatch(r"/api/v1/label/([^/]+)/values", req.path)
        if not m:
            return Response.error("bad label values path", 404)
        try:
            start, end = self._time_range(req)
        except QueryError as e:
            return Response.error(str(e))
        vals = self.storage.label_values(m.group(1), start, end,
                                         tenant=self._tenant(req))
        return Response.json({"status": "success", "data": vals})

    # -- export / federate ---------------------------------------------------

    def h_export(self, req: Request) -> Response:
        try:
            fl = self._matches_to_filters(req)
            if not fl:
                return Response.error("missing match[] arg")
            start, end = self._time_range(req, full_default=True)
            lines = []
            for filters in fl:
                for sd in self.storage.search_series(
                        filters, start, end, tenant=self._tenant(req)):
                    mask = ~np.isnan(sd.values)
                    lines.append(parsers.series_to_jsonl(
                        sd.metric_name.to_dict(),
                        sd.timestamps[mask], sd.values[mask]))
            return Response(200, "\n".join(lines) + ("\n" if lines else ""),
                            content_type="application/stream+json")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

    def h_export_native(self, req: Request) -> Response:
        """Binary export (reference /api/v1/export/native,
        app/vmselect/prometheus/export.go): zstd-framed series blocks —
        marshaled MetricName + raw int64 timestamp/float64 value arrays.
        Round-trips losslessly through /api/v1/import/native."""
        from ..ops import compress as zstd_c
        from ..parallel.rpc import Writer
        try:
            fl = self._matches_to_filters(req)
            if not fl:
                return Response.error("missing match[] arg")
            start, end = self._time_range(req, full_default=True)
            out = bytearray(b"vmtpu-native-v1\n")
            for filters in fl:
                for sd in self.storage.search_series(
                        filters, start, end, tenant=self._tenant(req)):
                    w = Writer()
                    w.bytes_(sd.metric_name.marshal())
                    w.array(np.asarray(sd.timestamps, dtype=np.int64))
                    w.array(np.asarray(sd.values, dtype=np.float64))
                    frame = zstd_c.compress(bytes(w.buf))
                    out += struct.pack("<I", len(frame))
                    out += frame
            return Response(200, bytes(out),
                            content_type="application/octet-stream")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

    def h_import_native(self, req: Request) -> Response:
        from ..ops import compress as zstd_c
        from ..parallel.rpc import Reader
        body = req.body
        magic = b"vmtpu-native-v1\n"
        if not body.startswith(magic):
            return Response.error("bad native export header", 400)
        off = len(magic)
        batch = []
        try:
            while off < len(body):
                (flen,) = struct.unpack_from("<I", body, off)
                off += 4
                r = Reader(zstd_c.decompress(body[off:off + flen]))
                off += flen
                mn = MetricName.unmarshal(r.bytes_())
                ts = r.array()
                vals = r.array()
                labels = mn.to_dict()
                for t, v in zip(ts.tolist(), vals.tolist()):
                    batch.append((labels, t, v))
        except Exception as e:  # noqa: BLE001 — any parse failure is a 400
            return Response.error(f"cannot parse native import: {e}", 400)
        self._ingest(batch, self._tenant(req))
        return Response(status=204, body=b"")

    def h_remote_read(self, req: Request) -> Response:
        """Prometheus remote_read server (the reference serves this at
        app/vmselect; lets Prometheus/Thanos/vmctl pull data out)."""
        from ..storage.tag_filters import TagFilter
        try:
            # server.py already decompressed bodies carrying a
            # Content-Encoding header; clients omitting it still send
            # snappy (protocol default)
            try:
                queries = list(remote_write.parse_read_request(req.body,
                                                               "none"))
            except Exception:
                queries = list(remote_write.parse_read_request(req.body,
                                                               "snappy"))
            results = []
            for start, end, matchers in queries:
                filters = []
                for op, name, value in matchers:
                    key = b"" if name == "__name__" else name.encode()
                    filters.append(TagFilter(
                        key, value.encode(), negate=op.startswith("!"),
                        regex=op.endswith("~")))
                series = []
                for sd in self.storage.search_series(
                        filters, start, end, max_series=self.max_series,
                        tenant=self._tenant(req)):
                    mask = ~np.isnan(sd.values)
                    series.append((sd.metric_name.to_dict(),
                                   sd.timestamps[mask], sd.values[mask]))
                results.append(series)
            body = remote_write.build_read_response(results)
            return Response(200, body, "application/x-protobuf")
        except (ValueError, ResourceWarning) as e:
            return Response.error(f"cannot serve remote read: {e}", 400)

    def h_federate(self, req: Request) -> Response:
        try:
            fl = self._matches_to_filters(req)
            if not fl:
                return Response.error("missing match[] arg")
            now = fasttime.unix_ms()
            start = now - self.lookback_delta
            lines = []
            for filters in fl:
                for sd in self.storage.search_series(
                        filters, start, now, tenant=self._tenant(req)):
                    mask = ~np.isnan(sd.values)
                    if not mask.any():
                        continue
                    ts = sd.timestamps[mask][-1]
                    v = sd.values[mask][-1]
                    d = sd.metric_name.to_dict()
                    name = d.pop("__name__", "")
                    lab = ",".join(
                        '{}="{}"'.format(
                            k, v2.replace("\\", "\\\\").replace('"', '\\"')
                                 .replace("\n", "\\n"))
                        for k, v2 in sorted(d.items()))
                    lines.append(f"{name}{{{lab}}} {_fmt_value(v)} {int(ts)}")
            return Response.text("\n".join(lines) + "\n")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

    # -- ingestion -----------------------------------------------------------

    def _columnar_ok(self) -> bool:
        """Columnar fast path covers relabel + series limits (verdicts are
        cached per raw key inside Storage); only stream aggregation — which
        must see every row — forces the Python path."""
        return (self.stream_aggr is None
                and getattr(self.storage, "supports_columnar", False))

    def _columnar_transform(self):
        relabel = self.relabel
        limits = self.series_limits
        if relabel is None and limits is None:
            return None

        def transform(labels):
            d = dict(labels)
            if relabel is not None:
                d = relabel.apply(d)
                if not d or not d.get("__name__"):
                    return None
            if limits is not None and not limits.check(d):
                return None
            return list(d.items())
        return transform

    def _ingest_columnar(self, cr, tenant=(0, 0)) -> int:
        """Shared columnar ingest tail (native.ColumnarRows batches)."""
        if self.rate_limiter is not None and self.rate_limiter.enabled():
            # registers the raw batch size (insert_ctx.go:286 semantics);
            # raises RateLimitedError -> 429 + Retry-After at the server
            self.rate_limiter.register(len(cr), tenant)
        stats: dict = {}
        n = self.storage.add_rows_columnar(
            cr, tenant=tenant, transform=self._columnar_transform(),
            drop_stats=stats)
        if stats:
            self.rows_relabel_dropped += stats.get("transform", 0)
            for k, v in stats.items():
                self.columnar_drop_stats[k] = \
                    self.columnar_drop_stats.get(k, 0) + v
        self.rows_inserted += n
        if n and tenant != (0, 0):
            key = f'{{accountID="{tenant[0]}",projectID="{tenant[1]}"}}'
            self.tenant_rows[key] = self.tenant_rows.get(key, 0) + n
        return n

    def _add_rows(self, rows_iter, tenant=(0, 0)) -> int:
        now = fasttime.unix_ms()
        batch = []
        for row in rows_iter:
            ts = row.timestamp or now
            batch.append((dict(row.labels), ts, row.value))
        return self._ingest(batch, tenant)

    def _ingest(self, batch: list, tenant=(0, 0)) -> int:
        """Shared ingest tail: global relabeling (-relabelConfig analog,
        app/vminsert/relabel) -> stream aggregation hook -> storage."""
        if self.rate_limiter is not None and self.rate_limiter.enabled():
            self.rate_limiter.register(len(batch), tenant)
        if self.relabel is not None:
            out = []
            for labels, ts, val in batch:
                labels = self.relabel.apply(labels)
                if not labels or not labels.get("__name__"):
                    # dropped, or relabeled into a nameless/empty label set —
                    # the reference drops those too rather than indexing an
                    # unreachable series
                    self.rows_relabel_dropped += 1
                    continue
                out.append((labels, ts, val))
            batch = out
        if self.series_limits is not None:
            batch = [(labels, ts, val) for labels, ts, val in batch
                     if self.series_limits.check(labels)]
        if self.stream_aggr is not None:
            passthrough = []
            for labels, ts, val in batch:
                consumed = self.stream_aggr.push(labels, ts, val)
                if not consumed or self.stream_aggr_keep_input:
                    passthrough.append((labels, ts, val))
            batch = passthrough
        if batch:
            # backfill older than the cache offset invalidates cached rollup
            # tails (ResetRollupResultCacheIfNeeded analog)
            from ..query.rollup_result_cache import GLOBAL as rcache
            from ..query.rollup_result_cache import OFFSET_MS
            now = fasttime.unix_ms()
            if min(ts for _, ts, _ in batch) < now - OFFSET_MS:
                rcache.reset()
        n = self.storage.add_rows(batch, tenant=tenant) if batch else 0
        self.rows_inserted += n
        if n and tenant != (0, 0):
            # tenantmetrics (lib/tenantmetrics CounterMap analog)
            key = f'{{accountID="{tenant[0]}",projectID="{tenant[1]}"}}'
            self.tenant_rows[key] = self.tenant_rows.get(key, 0) + n
        return n

    def h_remote_write(self, req: Request) -> Response:
        # server.py already decompressed bodies with a Content-Encoding
        # header; clients that omit it still send snappy (the protocol
        # default), so try raw first, then snappy. parse_write_request is a
        # generator — materialize inside the try so errors surface here.
        if self._columnar_ok():
            from .. import native
            now = fasttime.unix_ms()
            cr = native.parse_rw_columnar(req.body, now)
            if cr is None:
                body = native.snappy_uncompress(req.body)
                if body is not None:
                    cr = native.parse_rw_columnar(body, now)
            if cr is not None:
                self._ingest_columnar(cr, self._tenant(req))
                return Response(status=204, body=b"")
        try:
            series = list(remote_write.parse_write_request(req.body, "none"))
        except Exception:
            try:
                series = list(remote_write.parse_write_request(req.body,
                                                               "snappy"))
            except Exception as e:
                return Response.error(f"cannot parse remote write: {e}", 400)
        batch = []
        now = fasttime.unix_ms()
        for labels, samples in series:
            for ts, val in samples:
                batch.append((dict(labels), ts or now, val))
        self._ingest(batch, self._tenant(req))
        return Response(status=204, body=b"")

    def h_import(self, req: Request) -> Response:
        try:
            n = self._add_rows(parsers.parse_jsonl(
                req.body.decode("utf-8", "replace")), self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse import data: {e}", 400)
        return Response(status=204, body=b"")

    def h_import_prometheus(self, req: Request) -> Response:
        try:
            ts = parse_time(req.arg("timestamp"), 0)
            if b"# TYPE" in req.body or b"# HELP" in req.body:
                md = parsers.parse_prometheus_metadata(
                    req.body.decode("utf-8", "replace"))
                if len(self.metadata) < 100_000:
                    self.metadata.update(md)
                if getattr(self.storage, "set_metadata", None) is not None:
                    self.storage.set_metadata(md)
            tenant = self._tenant(req)
            cr = None
            if self._columnar_ok():
                from .. import native
                cr = native.parse_prom_columnar(
                    req.body, ts or fasttime.unix_ms())
            if cr is not None:
                # fast path: native parse -> columnar raw-key rows; repeat
                # scrapes resolve whole batches in one native hash-map call
                self._ingest_columnar(cr, tenant)
            elif self.relabel is None and self.series_limits is None and \
                    self.stream_aggr is None and \
                    getattr(self.storage, "supports_raw_keys", False):
                # raw-key row path (native lib present, columnar storage
                # absent — e.g. cluster vminsert)
                rows = parsers.parse_prometheus_fast(req.body, ts)
                self._ingest(rows, tenant)
            else:
                self._add_rows(parsers.parse_prometheus(
                    req.body.decode("utf-8", "replace"), ts), tenant)
        except (ValueError, QueryError) as e:
            return Response.error(f"cannot parse prometheus text: {e}", 400)
        return Response(status=204, body=b"")

    def h_import_csv(self, req: Request) -> Response:
        fmt = req.arg("format")
        if not fmt:
            return Response.error("missing 'format' arg")
        try:
            self._add_rows(parsers.parse_csv(
                req.body.decode("utf-8", "replace"), fmt), self._tenant(req))
        except (ValueError, IndexError) as e:
            return Response.error(f"cannot parse csv: {e}", 400)
        return Response(status=204, body=b"")

    def h_influx_write(self, req: Request) -> Response:
        db = req.arg("db")
        try:
            cr = None
            if self._columnar_ok():
                from .. import native
                cr = native.parse_influx_columnar(
                    req.body, db or "", fasttime.unix_ms())
            if cr is not None:
                self._ingest_columnar(cr, self._tenant(req))
            else:
                self._add_rows(parsers.parse_influx(
                    req.body.decode("utf-8", "replace"), db=db),
                    self._tenant(req))
        except ValueError as e:
            return Response.error(f"cannot parse influx line: {e}", 400)
        return Response(status=204, body=b"")

    def h_opentsdb_http(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_opentsdb_http(req.body), self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse opentsdb json: {e}", 400)
        return Response(status=204, body=b"")

    def h_graphite_write(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_graphite(
                req.body.decode("utf-8", "replace")), self._tenant(req))
        except ValueError as e:
            return Response.error(f"cannot parse graphite line: {e}", 400)
        return Response(status=204, body=b"")

    def h_otlp(self, req: Request) -> Response:
        try:
            self._add_rows(parse_otlp(req.body), self._tenant(req))
        except (ValueError, struct.error) as e:
            return Response.error(f"cannot parse OTLP payload: {e}", 400)
        # empty body = valid empty ExportMetricsServiceResponse proto
        return Response(200, b"", "application/x-protobuf")

    def h_zabbix(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_zabbixconnector(
                req.body.decode("utf-8", "replace")), self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse zabbix history: {e}", 400)
        return Response(status=204, body=b"")

    def h_datadog_v1(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_datadog_v1(req.body),
                           self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse datadog: {e}", 400)
        return Response.json({"status": "ok"}, status=202)

    def h_datadog_v2(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_datadog_v2(req.body),
                           self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse datadog: {e}", 400)
        return Response.json({"errors": []}, status=202)

    def h_newrelic(self, req: Request) -> Response:
        try:
            self._add_rows(parsers.parse_newrelic(req.body), self._tenant(req))
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse newrelic: {e}", 400)
        return Response.json({"status": "ok"}, status=202)

    # -- admin ---------------------------------------------------------------

    def h_delete_series(self, req: Request) -> Response:
        try:
            fl = self._matches_to_filters(req)
            if not fl:
                return Response.error("missing match[] arg")
            n = 0
            for filters in fl:
                n += self.storage.delete_series(filters,
                                                tenant=self._tenant(req))
            return Response(status=204, body=b"")
        except (QueryError, ParseError, ValueError) as e:
            return Response.error(str(e))

    def h_status_tsdb(self, req: Request) -> Response:
        try:
            topn = int(req.arg("topN", "10"))
            date = req.arg("date")
            d = None
            if date:
                d = int(datetime.datetime.fromisoformat(date).timestamp()
                        // 86400)
            fl = self._matches_to_filters(req)
        except (ValueError, QueryError, ParseError) as e:
            return Response.error(f"bad arg: {e}", 400)
        kw = {}
        if fl:
            kw["filters"] = fl[0]  # drill-down selector (match[])
        focus = req.arg("focusLabel")
        if focus:
            kw["focus_label"] = focus
        try:
            st = self.storage.tsdb_status(d, topn, tenant=self._tenant(req),
                                          **kw)
        except TypeError:
            # cluster backend: no drill-down over RPC yet — serve the
            # unfiltered explorer rather than failing
            st = self.storage.tsdb_status(d, topn, tenant=self._tenant(req))
        return Response.json({"status": "success", "data": st})

    def h_relabel_debug(self, req: Request) -> Response:
        """Relabel debugger (reference /metric-relabel-debug +
        vmui's relabel playground): applies a relabel config to one metric
        step by step and returns every intermediate label set."""
        from ..ingest import parsers
        from ..ingest.relabel import parse_relabel_configs
        metric = req.arg("metric")
        cfg_text = req.arg("relabel_configs")
        if not metric:
            return Response.error("missing `metric` arg", 400)
        try:
            labels = dict(parsers.labels_from_series_key(
                metric.strip().encode()))
        except ValueError as e:
            return Response.error(f"cannot parse metric: {e}", 400)
        try:
            cfg = parse_relabel_configs(cfg_text or "")
        except (ValueError, KeyError) as e:
            return Response.error(f"cannot parse relabel config: {e}", 400)
        steps = []
        cur: dict | None = dict(labels)
        for rc in cfg.configs:
            before = dict(cur)
            cur = rc.apply(cur)
            desc = {"action": rc.action}
            if rc.source_labels:
                desc["source_labels"] = rc.source_labels
            if rc.regex_orig is not None:
                desc["regex"] = str(rc.regex_orig)
            if rc.target_label:
                desc["target_label"] = rc.target_label
            if rc.replacement != "$1":
                desc["replacement"] = rc.replacement
            steps.append({"rule": desc, "in": before,
                          "out": dict(cur) if cur is not None else None})
            if cur is None:
                break
        final = cfg.apply(dict(labels))
        return Response.json({"status": "success",
                              "originalLabels": labels,
                              "steps": steps,
                              "resultingLabels": final or None,
                              "dropped": not final})

    def h_prettify_query(self, req: Request) -> Response:
        """Canonicalize/pretty-print a MetricsQL expression (reference
        /prettify-query): parse -> AST -> formatted text. A parse error
        comes back as status=error with the message."""
        q = req.arg("query")
        try:
            expr = mql_parse(q)
        except (ParseError, QueryError) as e:
            return Response.json({"status": "error", "msg": str(e)})
        return Response.json({"status": "success", "query": str(expr)})

    def h_query_ast(self, req: Request) -> Response:
        """AST explorer for the vmui query analyzer: the parsed expression
        as a nested-node JSON tree."""
        q = req.arg("query")
        try:
            expr = mql_parse(q)
        except (ParseError, QueryError) as e:
            return Response.json({"status": "error", "msg": str(e)})

        def node(e):
            d = {"kind": type(e).__name__, "text": str(e)}
            kids = []
            for attr in ("args", ):
                for c in getattr(e, attr, []) or []:
                    if hasattr(c, "__class__") and hasattr(c, "__module__") \
                            and "ast" in type(c).__module__:
                        kids.append(node(c))
            for attr in ("expr", "left", "right"):
                c = getattr(e, attr, None)
                if c is not None and hasattr(type(c), "__module__") and \
                        "ast" in type(c).__module__:
                    kids.append(node(c))
            if kids:
                d["children"] = kids
            return d
        return Response.json({"status": "success", "ast": node(expr)})

    def h_faults(self, req: Request) -> Response:
        """Chaos fault-injection control (devtools/faultinject; the
        live half of the ``VM_FAULTS`` env seam).  GET lists the armed
        table; ``?set=<spec>`` replaces it; ``?clear=1`` disarms; 403
        unless the process opted into chaos (VM_FAULT_INJECT=1 or a
        VM_FAULTS table armed at start)."""
        from ..devtools import faultinject
        return faultinject.handle_http(req, Response)

    def h_active_queries(self, req: Request) -> Response:
        return Response.json({"status": "ok",
                              "data": self.active.snapshot()})

    def h_top_queries(self, req: Request) -> Response:
        n = int(req.arg("topN", "20"))
        tops = self.qstats.tops(n)
        return Response.json({
            "status": "ok",
            "topByCount": tops["count"],
            "topBySumDuration": tops["sumDuration"],
            "topByAvgDuration": tops["avgDuration"],
            # cumulative-cost orderings (utils/costacc): the most
            # EXPENSIVE queries, not just the slowest
            "topBySumCpuMs": tops["sumCpuMs"],
            "topBySumSamplesScanned": tops["sumSamplesScanned"],
        })

    def h_usage(self, req: Request) -> Response:
        """Per-tenant cumulative resource usage (/api/v1/status/usage):
        the costacc TENANT_USAGE table — samples scanned, bytes read,
        CPU ms, device/RPC bytes, rows returned and query count per
        tenant, most CPU-expensive tenant first.  On a vmselect these
        totals are CLUSTER-wide: the fan-out merges each node's shipped
        cost frame before the bracket records it.  ``?reset=1`` clears
        the table (bench/test hygiene)."""
        from ..utils import costacc
        rows = costacc.TENANT_USAGE.snapshot(
            reset=req.arg("reset") == "1")
        data = {"tenants": rows}
        ms = getattr(self, "matstreams", None)
        if ms is not None:
            # per-stream attribution: each row's totals are the SHARED
            # evaluations, counted once per interval — not multiplied by
            # the stream's subscriber count
            data["matstreams"] = ms.usage_rows()
            data["matstreamInstant"] = ms.instant_stats()
        return Response.json({
            "status": "success",
            "data": data,
        })

    def h_profile(self, req: Request) -> Response:
        """Continuous-profiler surface (/api/v1/status/profile):
        collapsed-stack text (default), ``?format=speedscope`` JSON, or
        ``?format=raw`` snapshots.  On a vmselect the local snapshot is
        merged with the profile_v1 fan-out, node-tagged.  503 when
        VM_PROFILE_HZ=0."""
        from ..utils import profiler
        # tag the local snapshot only when node-tagged fan-out snapshots
        # will sit next to it (a bare vmsingle keeps untagged roles)
        fanned = getattr(self.storage, "profile_report", None) is not None
        return profiler.handle_http(req, Response, storage=self.storage,
                                    local_node="vmselect" if fanned
                                    else None)

    def h_slow_queries(self, req: Request) -> Response:
        """The slow-query log (vmselect -search.logSlowQueryDuration
        analog, queryable): per-record duration, per-phase split, and
        the flight-capture id when the refresh tripped one."""
        return Response.json({
            "status": "ok",
            "thresholdMs": self.slowlog.threshold_ms(),
            "data": self.slowlog.snapshot(),
        })

    def h_quarantine(self, req: Request) -> Response:
        """Parts moved aside by the open-time integrity check (torn or
        bit-flipped files): the store serves WITHOUT them, every result
        is flagged partial, and this listing is the operator's recovery
        worksheet (restore from a replica/snapshot, or delete the
        quarantine dir to accept the loss)."""
        if getattr(self.storage, "reset_partial", None) is not None:
            self.storage.reset_partial()
        rep = (self.storage.quarantine_report()
               if getattr(self.storage, "quarantine_report", None)
               is not None else [])
        # partial covers BOTH quarantined parts and nodes whose report
        # could not be fetched — an unreachable node may be the one
        # holding torn parts, and this worksheet must never read clean
        # while that is possible
        partial = bool(rep) or \
            bool(getattr(self.storage, "last_partial", False))
        return Response.json({
            "status": "success",
            "data": {"quarantined": rep, "count": len(rep),
                     "partial": partial},
        })

    def h_flight(self, req: Request) -> Response:
        """Flight-recorder captures.  No args: list capture metadata
        (newest first).  ``?id=N``: that capture's Chrome trace-event
        JSON (load it in Perfetto / chrome://tracing).  ``?capture=1``:
        take an on-demand capture of the live window first."""
        if not flightrec.enabled():
            return Response.error(
                "flight recorder disabled (VM_FLIGHTREC=0)", 503,
                "unavailable")
        if req.arg("capture") == "1":
            cap = flightrec.RECORDER.capture(
                "on_demand", meta={"source": "http"})
            return Response.json({
                "status": "ok", "captured": cap["id"],
                "data": flightrec.RECORDER.list()})
        cap_id = req.arg("id")
        if cap_id:
            try:
                cap = flightrec.RECORDER.get(int(cap_id))
            except ValueError:
                return Response.error(f"bad capture id {cap_id!r}")
            if cap is None:
                return Response.error(f"no capture with id {cap_id} "
                                      f"(captures are a bounded ring; "
                                      f"it may have aged out)", 404,
                                      "not_found")
            # the bare trace object: saving the response body to a file
            # makes it directly Perfetto-loadable
            return Response.json(cap["trace"])
        return Response.json({"status": "ok",
                              "data": flightrec.RECORDER.list()})

    # -- SLO plane / health ------------------------------------------------

    def init_sloplane(self):
        """Get-or-create the SLO engine (idempotent).  Lazy so a
        process that never enables self-scrape nor touches the SLO
        endpoints pays nothing."""
        if self.sloplane is None:
            from ..query.sloplane import SLOEngine
            self.sloplane = SLOEngine(self, role=self._role)
        return self.sloplane

    def h_slo(self, req: Request) -> Response:
        """Burn-rate dashboard (/api/v1/status/slo): every objective's
        per-window burn rates, remaining error budget, firing pairs and
        open incident id.  ``?pump=1`` forces an eval round first (the
        deterministic seam tests and operators poke instead of waiting
        out the interval)."""
        eng = self.init_sloplane()
        if req.arg("pump") == "1":
            eng.maybe_eval(force=True)
        return Response.json(eng.status())

    def h_incidents(self, req: Request) -> Response:
        """The incident ring (/api/v1/status/incidents).  No args:
        newest-first summaries.  ``?id=N``: the full frozen record —
        burn state, flight-capture id, profiler snapshot, top queries,
        tenant cost and the health verdict at breach time."""
        eng = self.init_sloplane()
        inc_id = req.arg("id")
        if inc_id:
            try:
                rec = eng.incidents.get(int(inc_id))
            except ValueError:
                return Response.error(f"bad incident id {inc_id!r}")
            if rec is None:
                return Response.error(
                    f"no incident with id {inc_id} (bounded ring; it "
                    f"may have aged out)", 404, "not_found")
            return Response.json({"status": "success", "data": rec})
        return Response.json({"status": "success",
                              "data": eng.incidents.list()})

    def h_health(self, req: Request) -> Response:
        """The health roll-up (/api/v1/status/health): one verdict
        ``ok|degraded|critical`` with machine-readable reasons.  On a
        vmselect this fans health_v1 across the storage nodes and
        merges liveness/ring state; the verdict names the nodes."""
        from ..query import sloplane
        return Response.json(sloplane.health_for_api(
            self, engine=self.sloplane, role=self._role))

    def _track_usage(self, rows):
        now = fasttime.unix_timestamp()
        for r in rows:
            g = r.metric_name.metric_group
            if not g:
                continue
            name = g.decode("utf-8", "replace")
            e = self.name_usage.get(name)
            if e is None:
                if len(self.name_usage) >= 100_000:
                    continue
                e = self.name_usage[name] = [0, 0]
            e[0] += 1
            e[1] = now

    def h_metadata(self, req: Request) -> Response:
        """Prometheus /api/v1/metadata shape. Merges the API-local store
        with storage-resident metadata (on a cluster vmselect that is the
        searchMetadata RPC fan-out)."""
        limit = int(req.arg("limit", "0") or 0)
        metric = req.arg("metric", "")
        merged = dict(self.metadata)
        if getattr(self.storage, "search_metadata", None) is not None:
            try:
                merged.update(self.storage.search_metadata(
                    limit or 100_000, metric))
            except Exception as e:
                logger.errorf("search_metadata: %s", e)
        data = {}
        for name, md in merged.items():
            if metric and name != metric:
                continue
            data[name] = [{"type": md.get("type") or "unknown",
                           "help": md.get("help", ""), "unit": ""}]
            if limit and len(data) >= limit:
                break
        return Response.json({"status": "success", "data": data})

    def h_name_stats(self, req: Request) -> Response:
        """Per-metric-name query usage (the reference's
        /api/v1/status/metric_names_stats, lib/storage/metricnamestats).
        Merges the API-local tracker with storage-resident stats (on a
        cluster vmselect that is the metricNamesUsageStats RPC)."""
        limit = int(req.arg("limit", "1000") or 1000)
        le = req.arg("le", "")
        # storage-resident stats are authoritative when available (the
        # reference serves these from vmstorage); the API-local tracker
        # records the SAME query events, so merging would double-count
        if getattr(self.storage, "metric_names_usage_stats",
                   None) is not None:
            try:
                items = self.storage.metric_names_usage_stats(
                    limit, int(le) if le else None)
                return Response.json(
                    {"status": "success",
                     "statsCollectedSince": int(self.started_at),
                     "records": items})
            except Exception as e:
                logger.errorf("metric_names_usage_stats: %s", e)
        items = [{"metricName": n, "requestsCount": c,
                  "lastRequestTimestamp": t}
                 for n, (c, t) in self.name_usage.items()]
        if le:
            items = [x for x in items if x["requestsCount"] <= int(le)]
        items.sort(key=lambda x: x["requestsCount"])
        return Response.json({"status": "success",
                              "statsCollectedSince": int(self.started_at),
                              "records": items[:limit]})

    def h_reset_name_stats(self, req: Request) -> Response:
        """/api/v1/admin/status/metric_names_stats/reset."""
        self.name_usage.clear()
        if getattr(self.storage, "reset_metric_names_stats",
                   None) is not None:
            self.storage.reset_metric_names_stats()
        return Response.json({"status": "success"})

    flags_map: dict | None = None  # set by apps for the /flags page

    def h_flags(self, req: Request) -> Response:
        """Flag values page (lib/httpserver/httpserver.go:400 /flags)."""
        flags = self.flags_map or {}
        body = "".join(f"{k}={v}\n" for k, v in sorted(flags.items()))
        return Response.text(body or "# no flags registered\n")

    def h_pprof(self, req: Request) -> Response:
        """Pythonic /debug/pprof/: goroutine analog = thread stacks;
        profile = cProfile over `seconds` of live traffic."""
        kind = req.path.rsplit("/", 1)[-1]
        if kind in ("goroutine", "threads", ""):
            import sys
            import traceback
            names = {t.ident: t.name for t in threading.enumerate()}
            parts = []
            for tid, frame in sys._current_frames().items():
                parts.append(f"Thread {names.get(tid, '?')} ({tid}):\n" +
                             "".join(traceback.format_stack(frame)))
            return Response.text("\n".join(parts))
        if kind == "profile":
            import cProfile
            import io as _io
            import pstats
            seconds = min(float(req.arg("seconds", "5")), 60.0)
            pr = cProfile.Profile()
            pr.enable()
            time.sleep(seconds)
            pr.disable()
            buf = _io.StringIO()
            pstats.Stats(pr, stream=buf).sort_stats("cumulative")\
                .print_stats(60)
            return Response.text(buf.getvalue())
        return Response.error(f"unsupported pprof kind {kind!r}", 404,
                              "not_found")

    def app_metrics(self) -> dict:
        """The app-level counters layered over the central registry —
        one collection shared by the /metrics exposition AND the
        self-scrape plane, so the scraped history matches what an
        external Prometheus would see sample-for-sample."""
        m = dict(self.storage.metrics()) \
            if getattr(self.storage, "metrics", None) is not None else {}
        srv = getattr(self, "srv", None)
        if srv is not None:
            m["vm_http_requests_all_total"] = srv.request_count
        else:
            m["vm_http_requests_all_total"] = 0
        m["vm_rows_inserted_total"] = self.rows_inserted
        m["vm_relabel_metrics_dropped_total"] = self.rows_relabel_dropped
        if self.rate_limiter is not None and \
                self.rate_limiter.global_rl is not None:
            m["vm_max_ingestion_rate_limit_reached_total"] = \
                self.rate_limiter.global_rl.limit_reached
        if self.series_limits is not None:
            m.update(self.series_limits.metrics())
        m["vm_concurrent_select_limit_reached_total"] = self.gate.rejected
        for lvl, cnt in logger.message_counters().items():
            m[metricslib.format_name("vm_log_messages_total",
                                     {"level": lvl})] = cnt
        for tkey, cnt in self.tenant_rows.items():
            m[f"vm_tenant_inserted_rows_total{tkey}"] = cnt
        return m

    def h_metrics(self, req: Request) -> Response:
        """Prometheus exposition for the whole process: the central
        registry (per-path HTTP histograms, cache hit/miss, RPC
        durations, TPU kernel split, process_*) plus the app-level
        counters collected here."""
        return Response.text(metricslib.REGISTRY.write_prometheus(
            extra=self.app_metrics()))

    def h_snapshot_create(self, req: Request) -> Response:
        name = self.storage.create_snapshot()
        return Response.json({"status": "ok", "snapshot": name})

    def h_snapshot_list(self, req: Request) -> Response:
        return Response.json({"status": "ok",
                              "snapshots": self.storage.list_snapshots()})

    def h_snapshot_delete(self, req: Request) -> Response:
        name = req.arg("snapshot")
        if self.storage.delete_snapshot(name):
            return Response.json({"status": "ok"})
        return Response.error(f"snapshot {name!r} not found", 404)

    def h_snapshot_delete_all(self, req: Request) -> Response:
        for name in self.storage.list_snapshots():
            self.storage.delete_snapshot(name)
        return Response.json({"status": "ok"})

    def h_force_flush(self, req: Request) -> Response:
        self.storage.force_flush()
        return Response.text("OK")

    def h_force_merge(self, req: Request) -> Response:
        self.storage.force_merge()
        return Response.text("OK")
