"""Self-scrape: the process scrapes its own metrics registry into real
storage (reference app/victoria-metrics/self_scraper.go,
``-selfScrapeInterval``).

Every ``interval`` seconds the collector snapshots the central registry
through ``MetricsRegistry.collect_values`` — the same structured
collection pass ``/metrics`` renders, NOT a text round-trip — stamps
``job=``/``instance=`` labels, and hands the rows to a sink:

- vmsingle / vmstorage: ``Storage.add_rows`` directly;
- vmselect / vminsert: ``ClusterStorage.add_rows`` (the cluster write
  path, sharded + rerouted like any ingested series).

``vm_*`` / ``process_*`` history therefore becomes ordinary TSDB data:
MetricsQL-queryable, visible in vmui, durable across restarts — and the
substrate the SLO engine (query/sloplane.py) evaluates burn rates over.

Default OFF; ``VM_SELF_SCRAPE_INTERVAL`` (or the apps'
``-selfScrapeInterval`` flag) enables it.  A bare ``1`` means the
reference's 15s default; otherwise a duration (``15s``, ``500ms``) or
plain seconds.

The port's copy of ``victoriametrics_tpu/utils/selfscrape.py``.
"""

from __future__ import annotations

import os
import threading
import time

from . import fasttime, logger
from . import metrics as metricslib

DEFAULT_INTERVAL_S = 15.0

_SCRAPES = metricslib.REGISTRY.counter("vm_selfscrape_scrapes_total")
_ROWS = metricslib.REGISTRY.counter("vm_selfscrape_rows_total")
_ERRORS = metricslib.REGISTRY.counter("vm_selfscrape_errors_total")
_DURATION = metricslib.REGISTRY.histogram(
    "vm_selfscrape_duration_seconds")


def parse_interval(raw: str | float | None) -> float:
    """Seconds from a flag/env value: ``0``/empty = off, ``1`` = the
    15s default (the "just turn it on" spelling), else a duration
    string (``15s``, ``500ms``, ``1m``) or plain seconds."""
    if raw is None:
        return 0.0
    s = str(raw).strip()
    if not s or s in ("0", "0s", "false", "no"):
        return 0.0
    if s == "1":
        return DEFAULT_INTERVAL_S
    try:
        return float(s)
    except ValueError:
        pass
    try:
        from ..query.metricsql.parser import parse_duration_ms
        ms, _ = parse_duration_ms(s)
        return max(0.0, ms / 1e3)
    except Exception:  # noqa: BLE001 — bad flag value, not a crash
        logger.errorf("selfscrape: cannot parse interval %r, disabled", s)
        return 0.0


def configured_interval(flag_value: str | float | None = None) -> float:
    """Effective interval in seconds: the ``VM_SELF_SCRAPE_INTERVAL``
    env wins (envflag convention), else the app's flag value."""
    env = os.environ.get("VM_SELF_SCRAPE_INTERVAL")
    if env is not None:
        return parse_interval(env)
    return parse_interval(flag_value)


def _labels_of(sample_name: str) -> dict | None:
    """``name{k="v"}`` -> labels dict with ``__name__`` (the ingest
    row shape).  Registry sample names ARE series keys, so the ingest
    parser's key decomposer is the single authority."""
    from ..ingest.parsers import labels_from_series_key
    try:
        pairs = labels_from_series_key(sample_name.encode())
    except ValueError:
        return None
    return dict(pairs)


class SelfScraper:
    """Background collector: registry snapshot -> labeled rows -> sink.

    ``sink(rows, tenant)`` gets ``[(labels_dict, ts_ms, value), ...]``
    (``Storage.add_rows`` / ``ClusterStorage.add_rows`` compatible).
    ``extra`` is an optional callable returning the app-level metric
    dict (``PrometheusAPI.app_metrics``) so the scraped view matches
    ``/metrics`` exactly.  ``on_tick(now_ms)`` runs after each scrape
    on the scraper thread — the SLO engine's eval pump rides here, so
    burn rates are computed right after the freshest self-sample
    lands."""

    def __init__(self, sink, job: str | None = None,
                 instance: str | None = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 extra=None, on_tick=None, tenant=(0, 0)):
        self.sink = sink
        self.job = job if job is not None else os.environ.get(
            "VM_SELF_SCRAPE_JOB", "victoria-metrics")
        self.instance = instance if instance is not None else \
            os.environ.get("VM_SELF_SCRAPE_INSTANCE", "self")
        self.interval_s = max(0.05, float(interval_s))
        self.extra = extra
        self.on_tick = on_tick
        self.tenant = tenant
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # wrong-plane guard: a sink that keeps failing with an RPC
        # handshake rejection is misconfigured (a 2-field -storageNode
        # spec points the insert plane at a select port), not unlucky —
        # and every retry can mark healthy nodes down in the router,
        # degrading REAL query traffic.  After a few consecutive
        # handshake failures self-ingest turns itself off (scraping and
        # /metrics keep working); other sink errors retry forever.
        self._sink_fails = 0
        self._saw_handshake_fail = False
        self._sink_disabled = False

    # -- collection --------------------------------------------------------

    def collect_rows(self, ts_ms: int | None = None) -> list:
        """One registry snapshot as ingest rows.  NaN samples (a gauge
        callback mid-teardown) are skipped: a self-scraped NaN would
        read as a staleness marker in the stored history."""
        if ts_ms is None:
            ts_ms = fasttime.unix_ms()
        extra = None
        if self.extra is not None:
            try:
                extra = self.extra()
            except Exception:  # noqa: BLE001 — scrape must never fail
                extra = None
        rows = []
        for name, value in metricslib.REGISTRY.collect_values(extra=extra):
            if value != value:  # NaN
                continue
            labels = _labels_of(name)
            if labels is None:
                continue
            labels["job"] = self.job
            labels["instance"] = self.instance
            rows.append((labels, ts_ms, value))
        return rows

    def scrape_once(self, ts_ms: int | None = None) -> int:
        if self._sink_disabled:
            return 0
        t0 = time.perf_counter()
        rows = self.collect_rows(ts_ms)
        try:
            self.sink(rows, tenant=self.tenant)
        except Exception as e:  # noqa: BLE001 — sink down ≠ scraper dead
            _ERRORS.inc()
            self._sink_fails += 1
            if "handshake failed" in str(e):
                self._saw_handshake_fail = True
            if self._saw_handshake_fail and self._sink_fails >= 3:
                self._sink_disabled = True
                logger.warnf(
                    "selfscrape: %d consecutive sink failures including an "
                    "RPC handshake rejection — the write plane is "
                    "misconfigured (2-field -storageNode spec? use "
                    "host:insertPort:selectPort); self-ingest disabled, "
                    "/metrics still serves: %s", self._sink_fails, e)
                return 0
            logger.errorf("selfscrape: ingest failed: %s", e)
            return 0
        self._sink_fails = 0
        self._saw_handshake_fail = False
        _SCRAPES.inc()
        _ROWS.inc(len(rows))
        _DURATION.update(time.perf_counter() - t0)
        return len(rows)

    # -- lifecycle ---------------------------------------------------------

    def _run(self):
        # first scrape one interval in (the reference waits too: an
        # empty registry snapshot at t=0 would just store zeros)
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                _ERRORS.inc()
                logger.errorf("selfscrape: scrape failed: %s", e)
            if self.on_tick is not None:
                try:
                    self.on_tick(fasttime.unix_ms())
                except Exception as e:  # noqa: BLE001
                    logger.errorf("selfscrape: on_tick failed: %s", e)

    def start(self):
        if self._thread is not None:
            return
        # long-lived service thread (one per process), not fan-out work
        self._thread = threading.Thread(  # vmt: disable=VMT011
            target=self._run, daemon=True, name="selfscrape")
        self._thread.start()
        logger.infof("selfscrape: every %.1fs as job=%s instance=%s",
                     self.interval_s, self.job, self.instance)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


def maybe_start(sink, role: str, http_port: int,
                flag_value: str | float | None = None,
                extra=None, on_tick=None) -> SelfScraper | None:
    """App-side one-liner: start a scraper when configured, else None.
    ``instance`` defaults to ``<role>:<port>`` (overridable via
    ``VM_SELF_SCRAPE_INSTANCE``) so a multi-process cluster's series
    stay distinguishable."""
    interval = configured_interval(flag_value)
    if interval <= 0:
        return None
    instance = os.environ.get("VM_SELF_SCRAPE_INSTANCE",
                              f"{role}:{http_port}")
    s = SelfScraper(sink, instance=instance, interval_s=interval,
                    extra=extra, on_tick=on_tick)
    s.start()
    return s
