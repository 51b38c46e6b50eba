"""vmagent: scraper + remote-write forwarder (reference app/vmagent +
lib/promscrape).

- Prometheus-style scrape configs (static_configs + file_sd_configs), jittered
  scrape loops, `up`/scrape_* auto-metrics, metric_relabel_configs.
- Per -remoteWrite.url context: pending buffer -> persistent queue (crash
  safe) -> sender with exponential backoff, snappy remote-write bodies
  (app/vmagent/remotewrite/{remotewrite,pendingseries,client}.go).
- Also accepts every push protocol over HTTP like vminsert, forwarding into
  the same remote-write pipeline.

Run: python -m victoriametrics_tpu_torch.apps.vmagent
-promscrape.config=scrape.json -remoteWrite.url=http://HOST:8428/api/v1/write

The port's copy of ``victoriametrics_tpu/apps/vmagent.py``; the scrape
config loads through ``utils/configfile`` (PyYAML where it is installed,
else JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import threading
import time
import urllib.request

from ..ingest import remote_write
from ..ingest.parsers import parse_prometheus
from ..ingest.persistentqueue import PersistentQueue
from ..ingest.relabel import parse_relabel_configs
from ..utils import configfile, fasttime, logger

MAX_ROWS_PER_BLOCK = 10_000


class RemoteWriteCtx:
    """One remote storage destination (remoteWriteCtx analog)."""

    def __init__(self, url: str, queue_dir: str, flush_interval=1.0,
                 send_timeout=30):
        self.url = url
        self.queue = PersistentQueue(queue_dir)
        self._pending: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.flush_interval = flush_interval
        self.send_timeout = send_timeout
        self.sent_rows = 0
        self.send_errors = 0
        self._threads = [
            threading.Thread(target=self._flusher, daemon=True),
            threading.Thread(target=self._sender, daemon=True),
        ]

    def start(self):
        for t in self._threads:
            t.start()

    def push(self, rows: list) -> None:
        """rows: [(labels_dict, ts_ms, value)]"""
        with self._lock:
            self._pending.extend(rows)
            if len(self._pending) >= MAX_ROWS_PER_BLOCK:
                self._flush_locked()

    def _flush_locked(self):
        if not self._pending:
            return
        rows, self._pending = self._pending, []
        series = [([(k, v) for k, v in labels.items()], [(ts, val)])
                  for labels, ts, val in rows]
        body = remote_write.build_write_request(series)
        self.queue.put(body)

    def _flusher(self):
        while not self._stop.wait(self.flush_interval):
            with self._lock:
                self._flush_locked()

    def _sender(self):
        backoff = 1.0
        while not self._stop.is_set():
            block = self.queue.get(timeout=1.0)
            if block is None:
                continue
            while not self._stop.is_set():
                try:
                    req = urllib.request.Request(
                        self.url, data=block, method="POST",
                        headers={"Content-Encoding": "snappy",
                                 "Content-Type": "application/x-protobuf"})
                    with urllib.request.urlopen(req, timeout=self.send_timeout):
                        pass
                    self.sent_rows += 1
                    backoff = 1.0
                    break
                except urllib.error.HTTPError as e:
                    self.send_errors += 1
                    if 400 <= e.code < 500 and e.code != 429:
                        logger.errorf("remote write %s: dropping block: %s",
                                      self.url, e)
                        break  # unretriable
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 60)
                except OSError as e:
                    self.send_errors += 1
                    logger.throttled_warnf(
                        "rw-" + self.url, 10, "remote write %s: %s",
                        self.url, e)
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 60)

    def stop(self):
        self._stop.set()
        with self._lock:
            self._flush_locked()
        self.queue.close()


class ScrapeTarget:
    PUSH_BATCH = 5000

    def __init__(self, url: str, labels: dict, interval_s: float,
                 timeout_s: float, metric_relabel, push_fn):
        self.url = url
        self.labels = labels
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.metric_relabel = metric_relabel
        self.push_fn = push_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.health = "unknown"
        self.last_error = ""
        self.last_scrape = 0.0
        # series seen in the last successful scrape: key -> labels, used to
        # emit Prometheus staleness markers when they disappear
        # (scrapework.go:441 sendStaleSeries)
        self._prev: dict[int, dict] = {}
        self._scraped_once = False

    def start(self):
        self._thread.start()

    def stop(self, send_stale: bool = True):
        self._stop.set()
        # let an in-flight scrape finish first: samples pushed AFTER the
        # stale markers would resurrect the series forever
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=self.timeout_s + 2)
        if send_stale and self._scraped_once:
            # target removed (SD change / shutdown): mark every tracked
            # series AND the auto metrics stale so queries stop extending
            # them (the last scrape may have failed, so _prev can be empty
            # while up=0 etc are still live)
            now_ms = fasttime.unix_ms()
            from ..ops.decimal import STALE_NAN
            rows = [(labels, now_ms, STALE_NAN)
                    for labels in self._prev.values()]
            for name in ("up", "scrape_duration_seconds",
                         "scrape_samples_scraped"):
                rows.append(({"__name__": name, **self.labels}, now_ms,
                             STALE_NAN))
            self._prev = {}
            self.push_fn(rows)

    def _loop(self):
        # jitter the start so targets spread over the interval
        if self._stop.wait(random.random() * self.interval_s):
            return
        while True:
            t0 = fasttime.unix_seconds()
            self._scrape_once()
            elapsed = fasttime.unix_seconds() - t0
            if self._stop.wait(max(self.interval_s - elapsed, 0.1)):
                return

    @staticmethod
    def _series_key(labels: dict) -> int:
        return hash(tuple(sorted(labels.items())))

    def _scrape_once(self):
        from ..ops.decimal import STALE_NAN
        now_ms = fasttime.unix_ms()
        rows = []
        cur: dict[int, dict] = {}
        up = 1.0
        samples = 0
        t0 = time.perf_counter()

        def handle_line_block(text):
            nonlocal samples, rows
            for row in parse_prometheus(text, now_ms):
                labels = dict(row.labels)
                labels.update(self.labels)
                if self.metric_relabel is not None:
                    labels = self.metric_relabel.apply(labels)
                    if not labels:
                        continue
                cur[self._series_key(labels)] = labels
                rows.append((labels, row.timestamp or now_ms, row.value))
                samples += 1
                if len(rows) >= self.PUSH_BATCH:
                    self.push_fn(rows)
                    rows = []

        try:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout_s) as r:
                # stream-parse unconditionally: bounded memory regardless of
                # Content-Length (chunked responses included;
                # scrapework.go streamParse)
                tail = b""
                while True:
                    chunk = r.read(256 << 10)
                    if not chunk:
                        break
                    buf = tail + chunk
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        tail = buf
                        continue
                    handle_line_block(
                        buf[:cut + 1].decode("utf-8", "replace"))
                    tail = buf[cut + 1:]
                if tail:
                    handle_line_block(tail.decode("utf-8", "replace"))
            self.health = "up"
            self.last_error = ""
        except OSError as e:
            up = 0.0
            samples = 0
            rows = []  # drop the un-pushed partial batch
            self.health = "down"
            self.last_error = str(e)
            # scrape failed: everything from the previous scrape AND any
            # partially-pushed series from this one goes stale
            self._prev = {**self._prev, **cur}
            cur = {}
        dur = time.perf_counter() - t0
        self.last_scrape = fasttime.unix_seconds()
        self._scraped_once = True
        # staleness markers for series that vanished since the last scrape
        for key, labels in self._prev.items():
            if key not in cur:
                rows.append((labels, now_ms, STALE_NAN))
        self._prev = cur
        auto = [("up", up), ("scrape_duration_seconds", dur),
                ("scrape_samples_scraped", float(samples))]
        for name, v in auto:
            rows.append(({"__name__": name, **self.labels}, now_ms, v))
        self.push_fn(rows)


class VMAgent:
    SD_REFRESH_S = 30.0  # -promscrape.*SDCheckInterval analog

    def __init__(self, scrape_config: dict, remote_urls: list[str],
                 tmp_dir: str, global_relabel=None, sd_refresh_s=None):
        self.rw_ctxs = [
            RemoteWriteCtx(url, os.path.join(tmp_dir, f"q{i}"))
            for i, url in enumerate(remote_urls)]
        self.global_relabel = global_relabel
        self.cfg = scrape_config or {}
        self.sd_refresh_s = sd_refresh_s or self.SD_REFRESH_S
        self.targets: dict[tuple, ScrapeTarget] = {}
        self._started = False
        self._stop = threading.Event()
        self._sync_lock = threading.Lock()
        self._sd_thread = threading.Thread(target=self._sd_loop, daemon=True)
        self._sync_targets()

    def _resolve_specs(self) -> dict[tuple, tuple]:
        """Evaluate every SD provider: spec_key -> (url, labels, interval,
        timeout, metric_relabel). Meta labels flow through relabel_configs,
        then __-prefixed labels are dropped (promscrape/config.go
        mergeLabels semantics)."""
        from ..ingest.discovery import discover_targets
        if not hasattr(self, "_sd_last_good"):
            self._sd_last_good = {}
        cfg = self.cfg
        g = cfg.get("global", {})
        default_interval = _dur_s(g.get("scrape_interval", "1m"))
        specs: dict[tuple, tuple] = {}
        for sc in cfg.get("scrape_configs", []):
            job = sc.get("job_name", "")
            interval = _dur_s(sc.get("scrape_interval")) or default_interval
            timeout = _dur_s(sc.get("scrape_timeout")) or min(interval, 10)
            path = sc.get("metrics_path", "/metrics")
            scheme = sc.get("scheme", "http")
            mrc = sc.get("metric_relabel_configs")
            metric_relabel = parse_relabel_configs(mrc) if mrc else None
            rc = sc.get("relabel_configs")
            relabel = parse_relabel_configs(rc) if rc else None
            target_specs = []
            for stc in sc.get("static_configs", []):
                for t in stc.get("targets", []):
                    target_specs.append((t, stc.get("labels", {})))
            for fsd in sc.get("file_sd_configs", []):
                for fn in fsd.get("files", []):
                    try:
                        data = json.load(open(fn))
                        for entry in data:
                            for t in entry.get("targets", []):
                                target_specs.append(
                                    (t, entry.get("labels", {})))
                    except (OSError, ValueError) as e:
                        logger.errorf("file_sd %s: %s", fn, e)
            target_specs.extend(discover_targets(sc, self._sd_last_good))
            for addr, extra in target_specs:
                labels = {"job": job, "__address__": addr,
                          "__metrics_path__": path, "__scheme__": scheme,
                          **extra}
                if relabel is not None:
                    labels = relabel.apply(labels)
                    if not labels:
                        continue
                addr = labels.get("__address__", addr)
                path_f = labels.get("__metrics_path__", path)
                scheme_f = labels.get("__scheme__", scheme)
                labels.setdefault("instance", addr)
                final = {k: v for k, v in labels.items()
                         if not k.startswith("__")}
                url = f"{scheme_f}://{addr}{path_f}"
                # scrape settings are part of the identity: a reload that
                # changes interval/timeout/relabel must replace the target
                key = (url, tuple(sorted(final.items())), interval, timeout,
                       json.dumps(mrc, sort_keys=True))
                specs[key] = (url, final, interval, timeout, metric_relabel)
        return specs

    def _sync_targets(self):
        """Diff discovered specs against running scrapers; removed targets
        stop WITH staleness markers. Serialized: SIGHUP, /-/reload, and the
        SD refresh thread may all call this concurrently."""
        with self._sync_lock:
            if self._stop.is_set():
                return  # a queued SD refresh must not resurrect targets
            specs = self._resolve_specs()
            for key in list(self.targets):
                if key not in specs:
                    self.targets.pop(key).stop(send_stale=True)
            for key, (url, labels, interval, timeout, mrc) in specs.items():
                if key in self.targets:
                    continue
                t = ScrapeTarget(url, labels, interval, timeout, mrc,
                                 self.push)
                self.targets[key] = t
                if self._started:
                    t.start()

    def _sd_loop(self):
        while not self._stop.wait(self.sd_refresh_s):
            try:
                self._sync_targets()
            except Exception as e:  # pragma: no cover
                logger.errorf("vmagent sd refresh: %s", e)

    def push(self, rows: list):
        if self.global_relabel is not None:
            out = []
            for labels, ts, v in rows:
                labels = self.global_relabel.apply(labels)
                if labels is not None:
                    out.append((labels, ts, v))
            rows = out
        for ctx in self.rw_ctxs:
            ctx.push(rows)

    def start(self):
        self._started = True
        for ctx in self.rw_ctxs:
            ctx.start()
        for t in self.targets.values():
            t.start()
        self._sd_thread.start()

    def stop(self):
        self._stop.set()
        with self._sync_lock:
            targets = list(self.targets.values())
            self.targets = {}
        # signal everything first so hung scrapes time out concurrently,
        # then join + emit stale markers
        for t in targets:
            t._stop.set()
        for t in targets:
            t.stop(send_stale=True)
        for ctx in self.rw_ctxs:
            ctx.stop()

    def reload(self, scrape_config: dict):
        """Swap the scrape config in place (SIGHUP hot-reload)."""
        self.cfg = scrape_config or {}
        self._sync_targets()

    def target_status(self) -> list[dict]:
        with self._sync_lock:
            targets = list(self.targets.values())
        return [{"url": t.url, "labels": t.labels, "health": t.health,
                 "lastError": t.last_error, "lastScrape": t.last_scrape}
                for t in targets]


def _dur_s(s) -> float:
    if not s:
        return 0.0
    from ..query.metricsql.parser import parse_duration_ms
    return parse_duration_ms(str(s))[0] / 1e3


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmagent")
    p.add_argument("-promscrape.config", dest="scrape_config", default="")
    p.add_argument("-remoteWrite.url", dest="remote_urls", action="append",
                   default=[])
    p.add_argument("-remoteWrite.tmpDataPath", dest="tmp_dir",
                   default="vmagent-remotewrite-data")
    p.add_argument("-remoteWrite.relabelConfig", dest="rw_relabel", default="")
    p.add_argument("-httpListenAddr", default=":8429")
    p.add_argument("-loggerLevel", default="INFO")
    args, _ = p.parse_known_args(argv)
    return args


def build(args):
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..httpapi.server import HTTPServer, Response

    scrape_cfg = {}
    if args.scrape_config:
        scrape_cfg = configfile.load(args.scrape_config) or {}
    relabel = None
    if args.rw_relabel:
        relabel = parse_relabel_configs(open(args.rw_relabel).read())
    agent = VMAgent(scrape_cfg, args.remote_urls, args.tmp_dir, relabel)

    class _PushBackend:
        """Duck-storage: push-protocol ingestion forwards to remote write."""

        def add_rows(self, rows):
            batch = [(dict(labels) if not isinstance(labels, dict)
                      else labels, ts, v) for labels, ts, v in rows]
            agent.push([(lb if isinstance(lb, dict) else
                         {k.decode() if isinstance(k, bytes) else k:
                          v.decode() if isinstance(v, bytes) else v
                          for k, v in lb}, ts, val)
                        for lb, ts, val in batch])
            return len(batch)

        def metrics(self):
            return {
                "vmagent_remotewrite_pending_blocks":
                    sum(c.queue.pending for c in agent.rw_ctxs),
                "vmagent_remotewrite_sent_blocks_total":
                    sum(c.sent_rows for c in agent.rw_ctxs),
                "vmagent_remotewrite_errors_total":
                    sum(c.send_errors for c in agent.rw_ctxs),
                "vmagent_targets": len(agent.targets),
            }

    hh, _, hp = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(hh or "0.0.0.0", int(hp))
    api = PrometheusAPI(_PushBackend())
    api.register(srv, mode="insert")
    srv.route("/targets", lambda req: Response.json(
        {"status": "success", "data": {"activeTargets": agent.target_status()}}))
    srv.route("/api/v1/targets", lambda req: Response.json(
        {"status": "success", "data": {"activeTargets": agent.target_status()}}))
    return agent, srv


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    with configfile.exit_on_error():
        agent, srv = build(args)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    def _reload(*_):
        # SIGHUP hot-reload of -promscrape.config (the reference re-reads
        # scrape configs on SIGHUP and on /-/reload)
        if not args.scrape_config:
            return
        try:
            cfg = configfile.load(args.scrape_config) or {}
            agent.reload(cfg)
            logger.infof("vmagent: reloaded %s (%d targets)",
                         args.scrape_config, len(agent.targets))
        except Exception as e:
            logger.errorf("vmagent: reload failed, keeping old config: %s",
                          e)
    signal.signal(signal.SIGHUP, _reload)
    from ..httpapi.server import Response as _Resp

    def h_reload(req):
        _reload()
        return _Resp.text("OK")
    srv.route("/-/reload", h_reload)
    # the handlers are in place before anything is served
    agent.start()
    srv.start()
    logger.infof("vmagent started: targets=%d remotes=%d http=%d",
                 len(agent.targets), len(agent.rw_ctxs), srv.port)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        srv.stop()
        agent.stop()
        logger.infof("vmagent: shutdown complete")


if __name__ == "__main__":
    main()
