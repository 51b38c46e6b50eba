"""Stream aggregation (reference lib/streamaggr/streamaggr.go: YAML-configured
aggregators with 20 output kinds, by/without grouping, interval flushers,
plus the standalone deduplicator).

Config entry:
  match: '{__name__=~"http_.*"}'     # optional series selector(s)
  interval: 60s
  outputs: [total, sum_samples, quantiles(0.9, 0.99), ...]
  by: [instance] | without: [pod]
  keep_metric_names: false
  dedup_interval: 0s

Aggregated rows flush every `interval` to the push callback as
{name}:{interval}_{output} series (the reference naming scheme).

The port's copy of ``victoriametrics_tpu/ingest/streamaggr.py``, whole.
"""

from __future__ import annotations

import math
import re
import threading

from ..query.metricsql import parse as mql_parse
from ..query.metricsql.ast import MetricExpr
from ..query.metricsql.parser import parse_duration_ms
from ..storage.tag_filters import TagFilter
from ..utils import fasttime

OUTPUT_KINDS = (
    "avg count_samples count_series histogram_bucket increase "
    "increase_prometheus last max min quantiles rate_avg rate_sum stddev "
    "stdvar sum_samples total total_prometheus unique_samples "
    "count_samples_total sum_samples_total"
).split()

_HIST_BUCKETS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100,
                 500, 1000, float("inf")]


class _SeriesState:
    __slots__ = ("count", "sum", "sum2", "min", "max", "last", "last_ts",
                 "first", "prev_value", "total", "uniq", "hist", "rate_prev",
                 "rate_prev_ts", "rate_acc")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.sum2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = math.nan
        self.last_ts = 0
        self.first = None
        self.prev_value = None      # across flushes, for total/increase
        self.total = 0.0
        self.uniq = set()
        self.hist = None
        self.rate_prev = None
        self.rate_prev_ts = None
        self.rate_acc = 0.0


def _match_selectors(expr):
    if expr is None:
        return None
    exprs = expr if isinstance(expr, list) else [expr]
    out = []
    for e in exprs:
        ast = mql_parse(str(e))
        if not isinstance(ast, MetricExpr):
            raise ValueError(f"streamaggr match must be a selector: {e}")
        # the match list is already a union, so a selector's OR'd filter
        # sets ({a="b" or c="d"}) expand into extra entries; one shared
        # lowering (query/eval) keeps ingest- and query-side semantics
        # identical
        from ..query.eval import filter_sets_from_metric_expr
        out.extend(filter_sets_from_metric_expr(ast))
    return out


class Aggregator:
    def __init__(self, cfg: dict, push_fn):
        self.interval_ms = int(parse_duration_ms(cfg["interval"])[0])
        if self.interval_ms <= 0:
            raise ValueError("streamaggr: bad interval")
        self.outputs = []
        self.quantile_phis = []
        for o in cfg["outputs"]:
            m = re.fullmatch(r"quantiles\(([^)]*)\)", o)
            if m:
                self.outputs.append("quantiles")
                self.quantile_phis = [float(x) for x in m.group(1).split(",")]
            elif o in OUTPUT_KINDS:
                self.outputs.append(o)
            else:
                raise ValueError(f"streamaggr: unknown output {o!r}")
        self.by = cfg.get("by") or []
        self.without = cfg.get("without") or []
        self.keep_metric_names = bool(cfg.get("keep_metric_names"))
        self.match = _match_selectors(cfg.get("match"))
        self.push_fn = push_fn
        self._lock = threading.Lock()
        self._state: dict[tuple, tuple[dict, _SeriesState, list]] = {}
        self._samples_buf: dict[tuple, list] = {}

    def matches(self, labels: dict) -> bool:
        if self.match is None:
            return True
        for filters in self.match:
            ok = True
            for tf in filters:
                key = "__name__" if tf.key == b"" else tf.key.decode()
                if not tf.match_value(labels.get(key, "").encode()):
                    ok = False
                    break
            if ok:
                return True
        return False

    def _group_key(self, labels: dict) -> tuple[tuple, dict]:
        name = labels.get("__name__", "")
        if self.by:
            kept = {k: labels[k] for k in self.by if k in labels}
        elif self.without:
            kept = {k: v for k, v in labels.items()
                    if k not in self.without and k != "__name__"}
        else:
            kept = {k: v for k, v in labels.items() if k != "__name__"}
        key = (name,) + tuple(sorted(kept.items()))
        return key, kept

    def push(self, labels: dict, ts_ms: int, value: float) -> None:
        if math.isnan(value):
            return
        key, kept = self._group_key(labels)
        with self._lock:
            entry = self._state.get(key)
            if entry is None:
                entry = (kept, _SeriesState(), [])
                self._state[key] = entry
            _, st, samples = entry
            st.count += 1
            st.sum += value
            st.sum2 += value * value
            st.min = min(st.min, value)
            st.max = max(st.max, value)
            st.last = value
            st.last_ts = ts_ms
            if st.first is None:
                st.first = value
            if "unique_samples" in self.outputs:
                st.uniq.add(value)
            if "quantiles" in self.outputs:
                samples.append(value)
            if "histogram_bucket" in self.outputs:
                if st.hist is None:
                    st.hist = [0] * len(_HIST_BUCKETS)
                for i, ub in enumerate(_HIST_BUCKETS):
                    if value <= ub:
                        st.hist[i] += 1
                        break
            if {"total", "total_prometheus", "increase",
                    "increase_prometheus", "rate_sum", "rate_avg"} & \
                    set(self.outputs):
                prev = st.rate_prev
                if prev is not None:
                    d = value - prev
                    if d < 0:  # counter reset
                        d = value
                    st.total += d
                    if st.rate_prev_ts and ts_ms > st.rate_prev_ts:
                        st.rate_acc += d / ((ts_ms - st.rate_prev_ts) / 1e3)
                elif self_outputs_include_initial(self.outputs):
                    st.total += value
                st.rate_prev = value
                st.rate_prev_ts = ts_ms

    def flush(self, now_ms: int | None = None) -> None:
        now_ms = now_ms or fasttime.unix_ms()
        with self._lock:
            state, self._state = self._state, {}
        suffix_base = _interval_str(self.interval_ms)
        out_rows = []
        n_series = {}
        for key, (kept, st, samples) in state.items():
            name = key[0]
            for o in self.outputs:
                vals: list[tuple[str, float, dict]] = []
                if o == "avg":
                    vals.append(("avg", st.sum / st.count, {}))
                elif o == "count_samples":
                    vals.append(("count_samples", float(st.count), {}))
                elif o in ("count_samples_total",):
                    vals.append(("count_samples_total", float(st.count), {}))
                elif o == "count_series":
                    vals.append(("count_series", 1.0, {}))
                elif o == "last":
                    vals.append(("last", st.last, {}))
                elif o == "min":
                    vals.append(("min", st.min, {}))
                elif o == "max":
                    vals.append(("max", st.max, {}))
                elif o in ("sum_samples", "sum_samples_total"):
                    vals.append((o, st.sum, {}))
                elif o == "stddev":
                    var = max(st.sum2 / st.count - (st.sum / st.count) ** 2, 0)
                    vals.append(("stddev", math.sqrt(var), {}))
                elif o == "stdvar":
                    var = max(st.sum2 / st.count - (st.sum / st.count) ** 2, 0)
                    vals.append(("stdvar", var, {}))
                elif o in ("total", "total_prometheus", "increase",
                           "increase_prometheus"):
                    vals.append((o, st.total, {}))
                elif o in ("rate_sum", "rate_avg"):
                    r = st.rate_acc
                    if o == "rate_avg":
                        r = r  # per-series avg handled at merge below
                    vals.append((o, r, {}))
                elif o == "unique_samples":
                    vals.append(("unique_samples", float(len(st.uniq)), {}))
                elif o == "quantiles":
                    s = sorted(samples)
                    for phi in self.quantile_phis:
                        if s:
                            idx = min(int(phi * len(s)), len(s) - 1)
                            vals.append(("quantiles", s[idx],
                                         {"quantile": str(phi)}))
                elif o == "histogram_bucket":
                    if st.hist:
                        cum = 0
                        for i, ub in enumerate(_HIST_BUCKETS):
                            cum += st.hist[i]
                            le = "+Inf" if math.isinf(ub) else str(ub)
                            vals.append(("histogram_bucket", float(cum),
                                         {"le": le}))
                for suffix, v, extra in vals:
                    if self.keep_metric_names:
                        out_name = name
                    else:
                        out_name = f"{name}:{suffix_base}_{suffix}"
                    labels = {"__name__": out_name, **kept, **extra}
                    out_rows.append((labels, now_ms, v))
        if out_rows:
            self.push_fn(out_rows)


def self_outputs_include_initial(outputs) -> bool:
    """total/increase count a series' first seen value from zero; the
    _prometheus variants don't (strict Prometheus semantics)."""
    return bool({"total", "increase"} & set(outputs)) and not (
        {"total_prometheus", "increase_prometheus"} & set(outputs))


def _interval_str(ms: int) -> str:
    if ms % 3_600_000 == 0:
        return f"{ms // 3_600_000}h"
    if ms % 60_000 == 0:
        return f"{ms // 60_000}m"
    return f"{ms // 1000}s"


class Deduplicator:
    """Standalone streaming dedup (lib/streamaggr/deduplicator.go): keeps the
    last sample per series per interval."""

    def __init__(self, interval_ms: int, push_fn):
        self.interval_ms = interval_ms
        self.push_fn = push_fn
        self._lock = threading.Lock()
        self._state: dict[tuple, tuple[dict, int, float]] = {}

    def push(self, labels: dict, ts_ms: int, value: float):
        key = tuple(sorted(labels.items()))
        with self._lock:
            cur = self._state.get(key)
            if cur is None or ts_ms >= cur[1]:
                self._state[key] = (labels, ts_ms, value)

    def flush(self, now_ms: int | None = None):
        with self._lock:
            state, self._state = self._state, {}
        rows = [(labels, ts, v) for labels, ts, v in state.values()]
        if rows:
            self.push_fn(rows)


def load_from_text(yaml_text: str, push_fn) -> "StreamAggregators":
    """Parse a YAML aggregation config (list of aggregator entries) — the
    streamaggr.LoadFromData entry point used by vmsingle/vminsert/vmagent."""
    from ..utils import configfile
    cfgs = configfile.loads(yaml_text, "streamaggr config") or []
    if not isinstance(cfgs, list):
        raise ValueError("streamaggr config must be a YAML list of "
                         "aggregator entries")
    return StreamAggregators(cfgs, push_fn)


class StreamAggregators:
    """The aggregator set + its flusher thread (streamaggr.LoadFromData)."""

    def __init__(self, configs: list[dict], push_fn):
        self.aggregators = [Aggregator(c, push_fn) for c in configs]
        self._stop = threading.Event()
        self._threads = []

    def push(self, labels: dict, ts_ms: int, value: float) -> bool:
        """Returns True if any aggregator consumed the sample."""
        consumed = False
        for a in self.aggregators:
            if a.matches(labels):
                a.push(labels, ts_ms, value)
                consumed = True
        return consumed

    def start(self):
        for a in self.aggregators:
            # one long-lived flush ticker per aggregator — not fan-out
            t = threading.Thread(  # vmt: disable=VMT011
                target=self._flush_loop, args=(a,), daemon=True)
            t.start()
            self._threads.append(t)

    def _flush_loop(self, a: Aggregator):
        while not self._stop.wait(a.interval_ms / 1e3):
            try:
                a.flush()
            except Exception:  # pragma: no cover
                import traceback
                traceback.print_exc()

    def stop(self, final_flush=True):
        self._stop.set()
        if final_flush:
            for a in self.aggregators:
                a.flush()
