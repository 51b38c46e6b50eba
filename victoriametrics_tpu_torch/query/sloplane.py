"""SLO plane: burn-rate objectives over self-scraped telemetry, with
incident auto-diagnosis and the health roll-up verdict.

The self-scrape collector (utils/selfscrape.py) turns the process's own
``vm_*`` counters into ordinary TSDB series; this module closes the loop
by *watching* them.  Declarative :class:`SLOSpec`\\ s describe service
level indicators as MetricsQL expression templates (``{w}`` is the
window placeholder); the :class:`SLOEngine` evaluates every distinct
(expression, window) pair ONCE per round through the matstream shared
instant-eval memo — multi-window multi-burn-rate alerting
(Google SRE workbook ch. 5: a fast 5m/1h pair pages, a slow 30m/6h
pair warns) stays FLAT in SLO count: N objectives over one indicator
cost one eval per distinct window per interval.

A burn-rate breach (both windows of a pair over threshold) freezes a
bounded incident record: flight-recorder capture id, truncated profiler
snapshot, top queries, per-tenant cost, and the health verdict at the
moment of breach — every diagnosis surface linked under one incident id
in a fixed-size ring (``/api/v1/status/incidents``).

Health (``/api/v1/status/health``): :func:`local_health` folds registry
backpressure gauges, quarantine, readonly state and SLO status into a
verdict ``ok|degraded|critical`` with machine-readable reasons;
:func:`cluster_health` (vmselect) additionally fans the ``health_v1``
RPC and merges node liveness / ring-reroute state, naming the nodes.

Env knobs: ``VM_SLO_WINDOWS`` (``short:long:threshold`` pairs, default
``5m:1h:14.4,30m:6h:6``), ``VM_SLO_PERIOD`` (error-budget period,
default ``24h``), ``VM_SLO_EVAL_INTERVAL`` (seconds, default 15),
``VM_SLO_INCIDENTS`` (ring size, default 16).

The port's copy of ``victoriametrics_tpu/query/sloplane.py``.
"""

from __future__ import annotations

import os
import threading

from ..devtools.locktrace import make_lock
from ..utils import costacc, fasttime, flightrec, logger, profiler
from ..utils import metrics as metricslib

DEFAULT_WINDOWS = "5m:1h:14.4,30m:6h:6"
DEFAULT_PERIOD = "24h"
DEFAULT_EVAL_INTERVAL_S = 15.0
DEFAULT_INCIDENT_RING = 16

#: one tick per UNIQUE (expr, window) matstream eval the engine issued —
#: the flat-in-SLO-count acceptance counter
_EVALS = metricslib.REGISTRY.counter("vm_slo_evals_total")
_ROUNDS = metricslib.REGISTRY.counter("vm_slo_eval_rounds_total")


def _dur_s(s: str, default: float) -> float:
    try:
        from .metricsql.parser import parse_duration_ms
        ms, _ = parse_duration_ms(str(s).strip())
        return ms / 1e3
    except Exception:  # noqa: BLE001 — bad knob value, fall back
        return default


def parse_windows(raw: str | None) -> list[tuple[str, str, float]]:
    """``"5m:1h:14.4,30m:6h:6"`` -> ``[(short, long, threshold), ...]``.
    The first pair is the fast (paging) pair; the rest warn."""
    raw = raw if raw is not None else \
        os.environ.get("VM_SLO_WINDOWS", DEFAULT_WINDOWS)
    out: list[tuple[str, str, float]] = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 3:
            logger.errorf("sloplane: bad window pair %r (want "
                          "short:long:threshold), skipped", part)
            continue
        try:
            out.append((bits[0].strip(), bits[1].strip(),
                        float(bits[2])))
        except ValueError:
            logger.errorf("sloplane: bad burn threshold in %r, skipped",
                          part)
    return out or parse_windows(DEFAULT_WINDOWS)


def _scalar(rows) -> float:
    return sum(r["value"] for r in rows) if rows else 0.0


def ratio_fold(vals: dict) -> tuple[float, float]:
    """Default SLI fold: ``bad``/``total`` event counts from the two
    eponymous expression keys."""
    return (max(0.0, _scalar(vals.get("bad"))),
            max(0.0, _scalar(vals.get("total"))))


def latency_fold(threshold_s: float):
    """SLI fold over vmrange histogram buckets: an event is *good* when
    its bucket's upper bound is within ``threshold_s``.  Expects keys
    ``total`` (the ``_count`` increase) and ``buckets`` (the ``_bucket``
    increase grouped by ``vmrange``)."""
    def fold(vals: dict) -> tuple[float, float]:
        total = max(0.0, _scalar(vals.get("total")))
        good = 0.0
        for r in (vals.get("buckets") or ()):
            rng = r.get("metric", {}).get("vmrange", "")
            parts = rng.split("...")
            if len(parts) != 2:
                continue
            try:
                upper = float(parts[1])
            except ValueError:
                continue
            if upper <= threshold_s * (1 + 1e-9):
                good += max(0.0, r["value"])
        # bucket sums can drift past _count within one scrape (the
        # registry snapshot is not atomic across series) — clamp
        return max(0.0, total - good), total
    return fold


class SLOSpec:
    """One declarative objective: named indicator expressions (templated
    on ``{w}``), an objective percentage, and a fold turning the
    per-window results into (bad_events, total_events)."""

    def __init__(self, name: str, objective: float, exprs: dict,
                 fold=None, description: str = ""):
        self.name = name
        self.objective = float(objective)
        #: allowed error fraction; burn rate = error_ratio / budget
        self.budget = max(1e-9, 1.0 - self.objective / 100.0)
        self.exprs = dict(exprs)
        self.fold = fold or ratio_fold
        self.description = description


#: the plane's own diagnosis/admin endpoints are NOT serving-path SLIs:
#: counting them would make the plane's own eval pumps and health
#: fan-outs burn the very SLOs they diagnose (a reflexive feedback loop)
_SERVING_PATHS = '{{path!~"/api/v1/status/.*|/internal/.*"}}'


def default_specs() -> list[SLOSpec]:
    """The stock objectives over the self-scraped plane.  All sum
    across ``path``/``instance`` so one spec covers every role that
    self-scrapes into the same storage."""
    return [
        SLOSpec(
            "http-availability", 99.9,
            {"bad": "sum(increase(vm_http_request_errors_total"
                    f"{_SERVING_PATHS}[{{w}}]))",
             "total": "sum(increase(vm_http_requests_total"
                      f"{_SERVING_PATHS}[{{w}}]))"},
            description="HTTP 5xx ratio over serving API paths"),
        SLOSpec(
            "http-latency", 99.0,
            {"total": "sum(increase(vm_request_duration_seconds_count"
                      f"{_SERVING_PATHS}[{{w}}]))",
             "buckets": "sum(increase(vm_request_duration_seconds_bucket"
                        f"{_SERVING_PATHS}[{{w}}]))"
                        " by (vmrange)"},
            fold=latency_fold(1.0),
            description="serving requests answered under 1s"),
        SLOSpec(
            "ingest-durability", 99.99,
            {"bad": "sum(increase(vm_ingest_spill_errors_total[{w}]))",
             "total": "sum(increase(vm_rows_inserted_total[{w}]))"},
            description="ingested rows never lost to spill errors"),
        SLOSpec(
            "search-admission", 99.9,
            {"bad":
                "sum(increase(vm_search_requests_rejected_total[{w}]))",
             "total":
                "sum(increase(vm_search_queries_total[{w}]))"
                " + sum(increase("
                "vm_search_requests_rejected_total[{w}]))"},
            description="queries admitted without queue-depth rejection"),
    ]


class IncidentRing:
    """Bounded ring of incident records; newest kept, oldest evicted."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._items: list[dict] = []
        self._next_id = 1
        self._opened = metricslib.REGISTRY.counter  # per-slo counters
        self._lock = threading.Lock()

    def open(self, rec: dict) -> dict:
        with self._lock:
            rec["id"] = self._next_id
            self._next_id += 1
            self._items.append(rec)
            if len(self._items) > self.cap:
                self._items = self._items[-self.cap:]
        self._opened(metricslib.format_name(
            "vm_incidents_total", {"slo": rec["slo"]})).inc()
        return rec

    def resolve(self, slo: str, now_ms: int) -> dict | None:
        with self._lock:
            for rec in reversed(self._items):
                if rec["slo"] == slo and rec.get("resolvedMs") is None:
                    rec["resolvedMs"] = now_ms
                    return rec
        return None

    def open_incident(self, slo: str) -> dict | None:
        with self._lock:
            for rec in reversed(self._items):
                if rec["slo"] == slo and rec.get("resolvedMs") is None:
                    return rec
        return None

    def get(self, incident_id: int) -> dict | None:
        with self._lock:
            for rec in self._items:
                if rec["id"] == incident_id:
                    return rec
        return None

    def list(self) -> list[dict]:
        """Newest-first summaries (the heavy diagnosis blobs stay behind
        ``?id=``)."""
        with self._lock:
            items = list(self._items)
        out = []
        for rec in reversed(items):
            out.append({
                "id": rec["id"], "slo": rec["slo"],
                "severity": rec.get("severity"),
                "startedMs": rec.get("startedMs"),
                "resolvedMs": rec.get("resolvedMs"),
                "burn": rec.get("burn"),
                "flightCaptureId": rec.get("flightCaptureId"),
                "hasProfile": rec.get("profile") is not None,
                "verdict": (rec.get("health") or {}).get("verdict"),
            })
        return out


class SLOEngine:
    """Evaluates every spec's burn rates each interval, maintains the
    exported gauges, and drives incident open/resolve transitions.

    Pumped externally — ``maybe_eval`` rides the self-scrape
    ``on_tick`` (so burn rates follow the freshest sample) and the
    ``/api/v1/status/slo?pump=1`` seam forces a round for tests."""

    def __init__(self, api, specs: list[SLOSpec] | None = None,
                 windows: list[tuple[str, str, float]] | None = None,
                 interval_s: float | None = None,
                 period: str | None = None, role: str = ""):
        self.api = api
        self.role = role
        self.specs = specs if specs is not None else default_specs()
        self.windows = windows if windows is not None else parse_windows(None)
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "VM_SLO_EVAL_INTERVAL", DEFAULT_EVAL_INTERVAL_S))
            except ValueError:
                interval_s = DEFAULT_EVAL_INTERVAL_S
        self.interval_s = max(0.05, interval_s)
        self.period = period or os.environ.get("VM_SLO_PERIOD",
                                               DEFAULT_PERIOD)
        self.period_s = _dur_s(self.period, _dur_s(DEFAULT_PERIOD, 86400))
        try:
            ring_cap = int(os.environ.get("VM_SLO_INCIDENTS",
                                          DEFAULT_INCIDENT_RING))
        except ValueError:
            ring_cap = DEFAULT_INCIDENT_RING
        self.incidents = IncidentRing(ring_cap)
        self.eval_rounds = 0
        self.expr_evals = 0
        self.exprs_last_round = 0
        self.last_eval_ms = 0
        #: spec name -> {"burn": {w: rate}, "budgetRemaining": f,
        #: "firing": [pair], "noData": bool, "severity": str|None}
        self._state: dict[str, dict] = {}
        self._gauges: dict[str, metricslib.Gauge] = {}
        # one lock for ALL engine state (counters, gauge memo, _state,
        # last_eval_ms): maybe_eval rides the self-scrape tick AND the
        # ?pump=1 HTTP seam, so rounds race unless every access takes it
        self._lock = make_lock("query.SLOEngine._lock")

    # -- evaluation --------------------------------------------------------

    def _all_windows(self) -> list[str]:
        seen: dict[str, None] = {}
        for s, long_w, _thr in self.windows:
            seen.setdefault(s)
            seen.setdefault(long_w)
        seen.setdefault(self.period)
        return list(seen)

    def _eval_expr(self, expr: str, ts_ms: int):
        try:
            rows = self.api.matstreams.instant_vector(expr, ts_ms, (0, 0))
        except Exception as e:  # noqa: BLE001 — storage trouble != crash
            logger.errorf("sloplane: eval failed for %s: %s", expr, e)
            return None
        return rows

    def maybe_eval(self, now_ms: int | None = None,
                   force: bool = False) -> bool:
        """One eval round if ``interval_s`` has elapsed (or forced).
        Returns whether a round ran."""
        if now_ms is None:
            now_ms = fasttime.unix_ms()
        with self._lock:
            if not force and \
                    now_ms - self.last_eval_ms < self.interval_s * 1e3:
                return False
            self.last_eval_ms = now_ms
        try:
            self._eval_round(now_ms)
        except Exception as e:  # noqa: BLE001 — keep the pump alive
            logger.errorf("sloplane: eval round failed: %s", e)
        return True

    def _eval_round(self, now_ms: int):
        # 1) collect the distinct (expr, window) set across ALL specs —
        # identical indicators shared by several objectives dedupe here
        # (and again in the matstream memo for concurrent callers)
        windows = self._all_windows()
        needed: dict[str, None] = {}
        for spec in self.specs:
            for tmpl in spec.exprs.values():
                for w in windows:
                    needed.setdefault(tmpl.format(w=w))
        results: dict[str, list | None] = {}
        for expr in needed:
            results[expr] = self._eval_expr(expr, now_ms)
            with self._lock:
                self.expr_evals += 1
            _EVALS.inc()
        with self._lock:
            self.exprs_last_round = len(needed)
            self.eval_rounds += 1
        _ROUNDS.inc()

        # 2) fold per spec per window, update gauges + firing state
        for spec in self.specs:
            burn: dict[str, float] = {}
            no_data = False
            for w in windows:
                vals = {}
                missing = False
                for key, tmpl in spec.exprs.items():
                    rows = results.get(tmpl.format(w=w))
                    if rows is None:
                        missing = True
                    vals[key] = rows or []
                if missing:
                    no_data = True
                bad, total = spec.fold(vals)
                if total <= 0:
                    ratio = 1.0 if bad > 0 else 0.0
                else:
                    ratio = min(1.0, bad / total)
                burn[w] = ratio / spec.budget
            firing = []
            for i, (short_w, long_w, thr) in enumerate(self.windows):
                if burn.get(short_w, 0.0) >= thr and \
                        burn.get(long_w, 0.0) >= thr:
                    firing.append({
                        "short": short_w, "long": long_w,
                        "threshold": thr,
                        "severity": "page" if i == 0 else "warn"})
            budget_remaining = max(0.0, 1.0 - burn.get(self.period, 0.0))
            state = {
                "burn": burn, "firing": firing, "noData": no_data,
                "budgetRemaining": budget_remaining,
                "severity": firing[0]["severity"] if firing else None,
            }
            self._export(spec, state)
            # publish the state BEFORE the transition: an incident
            # frozen by _transition snapshots health via firing(),
            # which must already see this round's burn
            with self._lock:
                self._state[spec.name] = state
            self._transition(spec, state, now_ms)

    def _gauge(self, base: str, labels: dict) -> metricslib.Gauge:
        name = metricslib.format_name(base, labels)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = metricslib.REGISTRY.gauge(name)
                self._gauges[name] = g
            return g

    def _export(self, spec: SLOSpec, state: dict):
        for w, rate in state["burn"].items():
            self._gauge("vm_slo_burn_rate",
                        {"slo": spec.name, "window": w}).set(rate)
        self._gauge("vm_slo_error_budget_remaining",
                    {"slo": spec.name}).set(state["budgetRemaining"])

    # -- incident lifecycle ------------------------------------------------

    def _transition(self, spec: SLOSpec, state: dict, now_ms: int):
        open_rec = self.incidents.open_incident(spec.name)
        if state["firing"] and open_rec is None:
            self._freeze_incident(spec, state, now_ms)
        elif not state["firing"] and open_rec is not None:
            self.incidents.resolve(spec.name, now_ms)
            logger.infof("sloplane: incident %d (%s) resolved",
                         open_rec["id"], spec.name)

    def _freeze_incident(self, spec: SLOSpec, state: dict, now_ms: int):
        """Burn breach -> one bounded record holding every diagnosis
        surface, each captured best-effort (a dead profiler must not
        lose the flight trace)."""
        rec = {
            "slo": spec.name, "severity": state["severity"],
            "objective": spec.objective,
            "description": spec.description,
            "startedMs": now_ms, "resolvedMs": None,
            "burn": dict(state["burn"]), "firing": state["firing"],
            "flightCaptureId": None, "profile": None,
            "topQueries": None, "tenantUsage": None, "health": None,
        }
        if flightrec.enabled():
            try:
                cap = flightrec.RECORDER.capture(
                    "slo_burn", meta={"slo": spec.name},
                    defer_build=True)
                if cap:
                    rec["flightCaptureId"] = cap.get("id")
                    flightrec.note_capture(cap["id"])
            except Exception as e:  # noqa: BLE001
                logger.errorf("sloplane: flight capture failed: %s", e)
        try:
            if profiler.PROFILER.ensure_started():
                snap = profiler.PROFILER.snapshot()
                # keep the record bounded: top stacks only
                if isinstance(snap.get("stacks"), list):
                    snap["stacks"] = snap["stacks"][:50]
                rec["profile"] = snap
        except Exception as e:  # noqa: BLE001
            logger.errorf("sloplane: profiler snapshot failed: %s", e)
        api = self.api
        try:
            if getattr(api, "qstats", None) is not None:
                rec["topQueries"] = api.qstats.tops(5)
        except Exception as e:  # noqa: BLE001
            logger.errorf("sloplane: top-queries snapshot failed: %s", e)
        try:
            rec["tenantUsage"] = costacc.TENANT_USAGE.snapshot()[:20]
        except Exception as e:  # noqa: BLE001
            logger.errorf("sloplane: tenant-usage snapshot failed: %s", e)
        try:
            rec["health"] = health_for_api(api, engine=self,
                                           role=self.role)
        except Exception as e:  # noqa: BLE001
            logger.errorf("sloplane: health snapshot failed: %s", e)
        self.incidents.open(rec)
        logger.warnf(
            "sloplane: incident opened for %s (severity %s, burn %s)",
            spec.name, state["severity"],
            {w: round(r, 2) for w, r in state["burn"].items()})

    # -- reporting ---------------------------------------------------------

    def firing(self) -> list[tuple[str, dict]]:
        with self._lock:
            return [(name, st) for name, st in self._state.items()
                    if st["firing"]]

    def status(self) -> dict:
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
            counters = {"evalRounds": self.eval_rounds,
                        "exprEvals": self.expr_evals,
                        "exprsPerRound": self.exprs_last_round,
                        "lastEvalMs": self.last_eval_ms}
        slos = []
        for spec in self.specs:
            st = state.get(spec.name, {})
            open_rec = self.incidents.open_incident(spec.name)
            slos.append({
                "slo": spec.name, "objective": spec.objective,
                "description": spec.description,
                "burn": st.get("burn", {}),
                "budgetRemaining": st.get("budgetRemaining"),
                "firing": st.get("firing", []),
                "noData": st.get("noData", True),
                "severity": st.get("severity"),
                "openIncidentId":
                    open_rec["id"] if open_rec else None,
            })
        return {
            "status": "success",
            "intervalSeconds": self.interval_s,
            "windows": [{"short": s, "long": lw, "threshold": t}
                        for s, lw, t in self.windows],
            "period": self.period,
            **counters,
            "slos": slos,
        }


# -- health roll-up --------------------------------------------------------

_SEV_RANK = {"ok": 0, "degraded": 1, "critical": 2}

#: merge-queue depth beyond which the node reports merge backpressure
MERGE_PENDING_DEGRADED = 32
#: work-queue backlog factor (queue depth > factor * workers)
QUEUE_BACKLOG_FACTOR = 8


def _metric_value(name: str) -> float | None:
    m = metricslib.REGISTRY._metrics.get(name)
    if m is None or not hasattr(m, "get"):
        return None
    try:
        # a registry Gauge/Counter read, not a queue drain
        v = float(m.get())  # vmt: disable=VMT012
    except Exception:  # noqa: BLE001
        return None
    return None if v != v else v


def _verdict(reasons: list[dict]) -> str:
    worst = "ok"
    for r in reasons:
        sev = r.get("severity", "degraded")
        if _SEV_RANK.get(sev, 0) > _SEV_RANK[worst]:
            worst = sev
    return worst


def local_health(storage=None, engine: SLOEngine | None = None,
                 role: str = "") -> dict:
    """This process's own verdict: quarantine + readonly + backpressure
    gauges + SLO firing state, folded to ``ok|degraded|critical`` with
    machine-readable ``{code, severity, detail}`` reasons."""
    from ..utils import buildinfo
    reasons: list[dict] = []
    quarantined = 0
    if storage is not None:
        rep = None
        try:
            if hasattr(storage, "quarantine_report"):
                rep = storage.quarantine_report()
        except Exception:  # noqa: BLE001 — health must always answer
            rep = None
        if rep:
            quarantined = len(rep)
            reasons.append({
                "code": "quarantined_parts", "severity": "degraded",
                "detail": f"{quarantined} part(s) quarantined; results "
                          "partial until restored"})
        if getattr(storage, "readonly", False) or \
                getattr(storage, "_readonly", False):
            reasons.append({
                "code": "readonly", "severity": "degraded",
                "detail": "storage is read-only"})
    pending = _metric_value("vm_merge_pending")
    if pending is not None and pending > MERGE_PENDING_DEGRADED:
        reasons.append({
            "code": "merge_backpressure", "severity": "degraded",
            "detail": f"{int(pending)} merges pending "
                      f"(> {MERGE_PENDING_DEGRADED})"})
    depth = _metric_value("vm_workpool_queue_depth")
    workers = _metric_value("vm_workpool_workers")
    if depth is not None and workers:
        if depth > QUEUE_BACKLOG_FACTOR * workers:
            reasons.append({
                "code": "work_queue_backlog", "severity": "degraded",
                "detail": f"{int(depth)} queued tasks over "
                          f"{int(workers)} workers"})
    if engine is not None:
        for name, st in engine.firing():
            sev = "critical" if st["severity"] == "page" else "degraded"
            reasons.append({
                "code": "slo_burn", "severity": sev, "slo": name,
                "detail": f"SLO {name} burning at "
                          + ", ".join(f"{w}={r:.1f}x"
                                      for w, r in st["burn"].items())})
    out = {
        "status": "success",
        "verdict": _verdict(reasons),
        "role": role,
        "version": buildinfo.version(),
        "uptimeSeconds": round(metricslib.uptime_seconds(), 3),
        "reasons": reasons,
        "stats": {
            "quarantinedParts": quarantined,
            "mergePending": pending,
            "workQueueDepth": depth,
        },
    }
    if engine is not None:
        out["slo"] = {
            "firing": [name for name, _ in engine.firing()],
            "evalRounds": engine.eval_rounds,
        }
    return out


def cluster_health(cluster, engine: SLOEngine | None = None,
                   role: str = "vmselect", fan: bool = True) -> dict:
    """The vmselect roll-up: this process's local verdict + per-node
    ``health_v1`` reports + liveness/draining/ring state from
    ``cluster_status()``, merged into one verdict that NAMES the nodes
    behind every degradation.  ``fan=False`` (vminsert: no select
    channel to the nodes) keeps the liveness/ring merge but skips the
    health_v1 fan-out — missing reports are then expected, not a
    degradation."""
    out = local_health(storage=None, engine=engine, role=role)
    reasons = out["reasons"]
    try:
        cs = cluster.cluster_status()
    except Exception:  # noqa: BLE001
        cs = {"nodes": []}
    reports: dict = {}
    if fan:
        try:
            reports = {r.get("node"): r
                       for r in cluster.health_report()}
        except Exception:  # noqa: BLE001
            reports = {}
    nodes_out = []
    down = 0
    for n in cs.get("nodes", []):
        name = n.get("name")
        rep = reports.get(name)
        node_verdict = (rep or {}).get("verdict", "unknown")
        if not n.get("healthy", True):
            down += 1
            reasons.append({
                "code": "node_down", "severity": "degraded",
                "node": name,
                "detail": f"storage node {name} is not responding"})
        elif fan and rep is None:
            reasons.append({
                "code": "node_unreachable", "severity": "degraded",
                "node": name,
                "detail": f"no health_v1 report from {name}"})
        elif node_verdict in ("degraded", "critical"):
            codes = ",".join(r.get("code", "?")
                             for r in rep.get("reasons", [])) or "?"
            reasons.append({
                "code": "node_degraded", "severity": "degraded",
                "node": name,
                "detail": f"storage node {name} reports "
                          f"{node_verdict}: {codes}"})
        if n.get("draining"):
            reasons.append({
                "code": "node_draining", "severity": "ok",
                "node": name,
                "detail": f"storage node {name} is draining "
                          "(planned; excluded from new writes)"})
        nodes_out.append({
            "name": name,
            "healthy": bool(n.get("healthy", True)),
            "draining": bool(n.get("draining")),
            "verdict": node_verdict,
            "reasons": (rep or {}).get("reasons", []),
        })
    total = len(cs.get("nodes", []))
    if total and down >= total:
        reasons.append({
            "code": "all_nodes_down", "severity": "critical",
            "detail": "every storage node is unreachable"})
    out["nodes"] = nodes_out
    out["ring"] = {
        "filterActive": bool(cs.get("ringFilter")),
        "rerouteActive": down > 0,
    }
    out["verdict"] = _verdict(reasons)
    return out


def health_for_api(api, engine: SLOEngine | None = None,
                   role: str = "") -> dict:
    """Dispatch on the API's storage: ClusterStorage (has
    ``cluster_status``) rolls the nodes up; plain Storage answers
    locally.  A vminsert merges liveness but cannot fan health_v1
    (insert-only channels)."""
    storage = getattr(api, "storage", None)
    if storage is not None and hasattr(storage, "cluster_status"):
        return cluster_health(storage, engine=engine,
                              role=role or "vmselect",
                              fan=role != "vminsert")
    return local_health(storage=storage, engine=engine,
                        role=role or "vmsingle")
