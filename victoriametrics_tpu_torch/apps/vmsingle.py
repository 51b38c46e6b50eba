"""vmsingle: the single-binary server (reference app/victoria-metrics/
main.go:53-125) — storage + query engine + HTTP API in one process.

Flags follow the reference's conventions (-storageDataPath,
-httpListenAddr, -retentionPeriod, -dedup.minScrapeInterval); every flag is
also settable via env var VM_<FLAGNAME> (lib/envflag analog).

Run: python -m victoriametrics_tpu_torch.apps.vmsingle -storageDataPath=DIR
[-search.tpuBackend=false]

The port's copy of ``victoriametrics_tpu/apps/vmsingle.py``, with the
reference's flag names.  ``-search.tpuBackend`` (on unless given
``=false``) attaches the CUDA engine (``query/cuda_engine.py``) after a
bounded probe of the card (``_attach_cuda_engine``); ``build`` waits for
the attach, and a failed one ends startup with an error naming its cause,
so no query is answered on the host once the card was asked for.
``-search.tpuBackend=false`` serves every query on the host evaluator.
``-rule`` evaluates vmalert-format rule groups in the server
(``apps/vmalert.EngineDatasource`` over the registry's
``instant_vector``, ``LocalWriter`` into the store, ``/api/v1/rules``),
and the Graphite query API (``httpapi/graphite_api.py``) is registered
beside the Prometheus one.  ``-streamAggr.config`` aggregates ingested
rows (``ingest/streamaggr.py``; reloaded on SIGHUP, flushed before the
store closes) and ``-graphiteListenAddr``, ``-influxListenAddr`` and
``-opentsdbListenAddr`` start the TCP/UDP line listeners
(``ingest/ingestserver.py``).  ``-selfScrapeInterval`` scrapes the
process's own registry into its store (``utils/selfscrape.py``, the SLO
plane's burn-rate evals riding each tick) and ``-pushmetrics.url`` pushes
``/metrics`` (``utils/pushmetrics.py``).  Config files load through
``utils/configfile`` (PyYAML where it is installed, else JSON).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from ..utils import configfile, logger


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmsingle", prefix_chars="-")
    p.add_argument("-storageDataPath", default="victoria-metrics-data")
    p.add_argument("-httpListenAddr", default=":8428")
    p.add_argument("-retentionPeriod", default="13m",
                   help="duration: 30d, 13m(onths) etc")
    p.add_argument("-dedup.minScrapeInterval", dest="dedup_interval",
                   default="0s")
    p.add_argument("-storage.maxHourlySeries", dest="max_hourly_series",
                   type=int, default=0)
    p.add_argument("-storage.maxDailySeries", dest="max_daily_series",
                   type=int, default=0)
    p.add_argument("-search.maxUniqueTimeseries", dest="max_series",
                   type=int, default=300_000)
    p.add_argument("-search.maxSamplesPerQuery", dest="max_samples_per_query",
                   type=int, default=1_000_000_000)
    p.add_argument("-search.maxMemoryPerQuery", dest="max_memory_per_query",
                   type=int, default=0)
    p.add_argument("-search.maxQueryDuration", dest="max_query_duration",
                   default="30s")
    p.add_argument("-search.maxStalenessInterval", dest="lookback",
                   default="5m")
    p.add_argument("-search.tpuBackend", dest="tpu", nargs="?", const=True,
                   default=True, type=parse_bool,
                   help="route supported rollups to the CUDA engine "
                        "(default true; =false serves on the host)")
    p.add_argument("-graphiteListenAddr", dest="graphite_addr", default="")
    p.add_argument("-influxListenAddr", dest="influx_addr", default="")
    p.add_argument("-opentsdbListenAddr", dest="opentsdb_addr", default="")
    p.add_argument("-relabelConfig", dest="relabel_config", default="",
                   help="path to global relabeling rules YAML")
    p.add_argument("-streamAggr.config", dest="streamaggr_config", default="",
                   help="path to stream aggregation config YAML")
    p.add_argument("-streamAggr.keepInput", dest="streamaggr_keep_input",
                   action="store_true")
    p.add_argument("-maxLabelsPerTimeseries", type=int, default=40)
    p.add_argument("-maxLabelValueLen", type=int, default=4096)
    p.add_argument("-maxIngestionRate", dest="max_ingestion_rate",
                   type=int, default=0,
                   help="rows/s ingest ceiling, 0 = unlimited "
                        "(lib/ratelimiter analog: bursts within ~1s are "
                        "smoothed by blocking; sustained overload gets "
                        "429 + Retry-After)")
    p.add_argument("-maxTenantIngestionRate",
                   dest="max_tenant_ingestion_rate", type=int, default=0,
                   help="per-tenant rows/s ingest ceiling, 0 = unlimited")
    p.add_argument("-selfScrapeInterval", dest="self_scrape_interval",
                   default="",
                   help="scrape own /metrics into storage every "
                        "interval (15s when set to 1); empty/0 = off")
    p.add_argument("-pushmetrics.url", dest="pushmetrics_urls",
                   action="append", default=[])
    p.add_argument("-pushmetrics.interval", dest="pushmetrics_interval",
                   default="10s")
    p.add_argument("-pushmetrics.extraLabel", dest="pushmetrics_extra",
                   default="")
    p.add_argument("-rule", action="append", default=[],
                   help="vmalert-format rule file evaluated SERVER-SIDE "
                        "through the materialized-stream engine (rules "
                        "sharing an expression share one fetch+rollup "
                        "per interval); repeatable")
    p.add_argument("-evaluationInterval", dest="eval_interval",
                   default="1m")
    p.add_argument("-loggerLevel", default="INFO")
    p.add_argument("-tls", action="store_true")
    p.add_argument("-tlsCertFile", default="")
    p.add_argument("-tlsKeyFile", default="")
    args, _ = p.parse_known_args(argv)
    # env overrides: VM_STORAGEDATAPATH etc (envflag analog)
    for name in vars(args):
        env = os.environ.get("VM_" + name.upper().replace(".", "_"))
        if env is not None:
            cur = getattr(args, name)
            if isinstance(cur, bool):
                setattr(args, name, env not in ("0", "false", ""))
            elif isinstance(cur, list):
                setattr(args, name, [x for x in env.split(",") if x])
            else:
                setattr(args, name, type(cur)(env))
    return args


def parse_bool(s: str) -> bool:
    """A boolean flag's value as the reference's flag package reads it
    (``-flag``, ``-flag=true``, ``-flag=false``, ``1``/``0``)."""
    v = str(s).strip().lower()
    if v in ("1", "t", "true", "yes", "on"):
        return True
    if v in ("0", "f", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def _dur_ms(s: str, months_ok=False) -> int:
    from ..query.metricsql.parser import parse_duration_ms
    s = s.strip()
    if months_ok and s.endswith("m") and s[:-1].isdigit():
        # retentionPeriod bare "13m" means months per reference semantics
        return int(float(s[:-1]) * 31 * 86_400_000)
    ms, step_based = parse_duration_ms(s)
    return int(ms)


def _attach_cuda_engine(api, enabled: bool) -> None:
    """-search.tpuBackend startup, before anything is served: probe the
    card with a hard deadline in a subprocess BEFORE any in-process CUDA
    init, then build the engine and warm its kernels up (their nvcc
    build on first use, then one launch each) within the same deadline
    (``VM_TPU_PROBE_TIMEOUT_S``, default 600 s).  The build runs on a helper
    thread joined at once, only so that a hang there can be timed out
    and its stack logged: a hung device init must end startup with an
    error, not wedge it.  A failed probe, build or warm-up is logged at
    error level and raises SystemExit naming the stage and its cause;
    ``api.tpu`` stays None and nothing falls back to the host.  On
    success ``api.tpu`` is the engine, ``api.probe_result`` the probe's
    result and ``api.attach_timing`` the probe's, the engine's and the
    warm-up's seconds."""
    if not enabled:
        return
    import threading
    import traceback

    from ..utils.device_probe import probe_backend

    def fail(msg, stack=""):
        logger.errorf("%s", msg)
        if stack:
            logger.errorf("its last stack:\n%s", stack)
        raise SystemExit(msg)

    timeout = float(os.environ.get("VM_TPU_PROBE_TIMEOUT_S", "600"))
    res = probe_backend(timeout)
    api.probe_result = res
    api.attach_timing = {"probe_s": res.elapsed_s}
    if res.error is not None:
        fail(f"cuda backend requested but unavailable: {res.error}",
             res.stack)
    logger.infof("accelerator probe: %d %s device(s) (%s)", res.n,
                 res.platform, res.name)
    state = {"stage": "engine build"}

    def _build():
        try:
            from ..query import cuda_engine
            t0 = time.perf_counter()
            engine = cuda_engine.CUDAEngine(mesh=cuda_engine.auto_mesh())
            t1 = time.perf_counter()
            state["stage"] = "warm-up"
            # build and launch the hot kernels BEFORE exposing the engine
            cuda_engine.warmup(engine)
            api.attach_timing.update(engine_s=t1 - t0,
                                     warmup_s=time.perf_counter() - t1)
            state["engine"] = engine
        except BaseException as e:  # noqa: BLE001 - reported below
            state["error"] = e

    t = threading.Thread(target=_build, daemon=True, name="cuda-attach")
    t.start()
    t.join(timeout)
    if t.is_alive():
        frame = sys._current_frames().get(t.ident)
        fail(f"cuda {state['stage']} hung past {timeout:g} s "
             f"(VM_TPU_PROBE_TIMEOUT_S)",
             "".join(traceback.format_stack(frame)) if frame else "")
    if "error" in state:
        e = state["error"]
        fail(f"cuda {state['stage']} failed: {type(e).__name__}: {e}")
    api.tpu = state["engine"]
    logger.infof("cuda engine attached (%s)", api.tpu.device)


def build(args):
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..httpapi.server import HTTPServer
    from ..storage.storage import Storage

    retention = _dur_ms(args.retentionPeriod, months_ok=True)
    dedup = _dur_ms(args.dedup_interval) if args.dedup_interval != "0s" else 0
    storage = Storage(args.storageDataPath, retention_ms=retention,
                      dedup_interval_ms=dedup,
                      max_hourly_series=args.max_hourly_series,
                      max_daily_series=args.max_daily_series)
    relabel = None
    if args.relabel_config:
        from ..ingest.relabel import parse_relabel_configs
        relabel = parse_relabel_configs(open(args.relabel_config).read())
    stream_aggr = None
    if args.streamaggr_config:
        from ..ingest.streamaggr import load_from_text
        stream_aggr = load_from_text(open(args.streamaggr_config).read(),
                                     lambda rows: storage.add_rows(rows))
        stream_aggr.start()
    host, _, port = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(host or "0.0.0.0", int(port),
                     tls_cert_file=args.tlsCertFile if args.tls else "",
                     tls_key_file=args.tlsKeyFile if args.tls else "")
    from ..ingest.serieslimits import SeriesLimits
    limits = SeriesLimits(max_labels_per_series=args.maxLabelsPerTimeseries,
                          max_label_value_len=args.maxLabelValueLen)
    rate_limiter = None
    if args.max_ingestion_rate > 0 or args.max_tenant_ingestion_rate > 0:
        from ..ingest.ratelimiter import TenantRateLimiters
        rate_limiter = TenantRateLimiters(
            global_limit=args.max_ingestion_rate,
            per_tenant_limit=args.max_tenant_ingestion_rate)
    api = PrometheusAPI(storage, None,
                        lookback_delta=_dur_ms(args.lookback),
                        max_series=args.max_series,
                        relabel_configs=relabel, stream_aggr=stream_aggr,
                        stream_aggr_keep_input=args.streamaggr_keep_input,
                        series_limits=limits,
                        max_samples_per_query=args.max_samples_per_query,
                        max_memory_per_query=args.max_memory_per_query,
                        max_query_duration_ms=_dur_ms(
                            args.max_query_duration),
                        rate_limiter=rate_limiter)
    api.flags_map = {k: v for k, v in vars(args).items()}
    api.register(srv)
    from ..httpapi.graphite_api import GraphiteAPI
    GraphiteAPI(storage).register(srv)
    api.ingest_servers, api.selfscraper, api.pusher = [], None, None
    api.rule_groups = []
    try:
        # the card attaches before anything is served or evaluated: no
        # query is answered on the host once the card was asked for
        _attach_cuda_engine(api, args.tpu)
        from ..utils import profiler
        profiler.ensure_started()
        if args.rule:
            _arm_rules(args, srv, api)
    except BaseException:
        shutdown(srv, storage, api)
        raise
    for proto, addr in (("graphite", args.graphite_addr),
                        ("influx", args.influx_addr),
                        ("opentsdb", args.opentsdb_addr)):
        if addr:
            from ..ingest.ingestserver import IngestServer
            h, _, p_ = addr.rpartition(":")
            isrv = IngestServer(proto, h or "0.0.0.0", int(p_),
                                api._add_rows)
            isrv.start()
            api.ingest_servers.append(isrv)
    # self-monitoring plane: own registry -> own storage as real series;
    # the SLO engine's burn-rate evals ride each scrape tick
    from ..utils import selfscrape
    api.selfscraper = selfscrape.maybe_start(
        storage.add_rows, "vmsingle", int(port),
        flag_value=args.self_scrape_interval, extra=api.app_metrics,
        on_tick=lambda now_ms: api.init_sloplane().maybe_eval(now_ms))
    if args.pushmetrics_urls:
        from ..utils.pushmetrics import MetricsPusher
        api.pusher = MetricsPusher(
            args.pushmetrics_urls,
            lambda: api.h_metrics(None).body.decode(),
            interval_s=_dur_ms(args.pushmetrics_interval) / 1e3,
            extra_labels=args.pushmetrics_extra)
        api.pusher.start()
    return storage, srv, api


def _arm_rules(args, srv, api) -> None:
    """-rule: server-side recording and alerting rules (the reference
    evaluates them in vmalert against vmselect; here they run in process
    through the shared materialized-stream registry, so rules sharing an
    expression pay one evaluation per instant, on the card when it is
    attached), their results written into the local store, and
    /api/v1/rules."""
    from ..httpapi.server import Response
    from . import vmalert
    ds = vmalert.EngineDatasource(api)
    rw = vmalert.LocalWriter(api)
    for path in args.rule:
        cfg = configfile.load(path) or {}
        for g in cfg.get("groups", []):
            api.rule_groups.append(vmalert.Group(
                g, ds, [], rw, vmalert._dur_s(args.eval_interval, 60.0)))
    for g in api.rule_groups:
        g.start()
    srv.route("/api/v1/rules", lambda req: Response.json(
        {"status": "success",
         "data": {"groups": [g.api_dict() for g in api.rule_groups]}}))
    logger.infof("vmsingle: %d server-side rule group(s) armed",
                 len(api.rule_groups))


def shutdown(srv, storage, api) -> None:
    """Stop what ``build`` started, then close the store: the rule
    groups, the listener, the line listeners, the pusher, the
    self-scraper (a late scrape must not write into a closed store) and
    the stream aggregator's final window (streamaggr MustStop ordering:
    dropping the open window on every restart would lose data)."""
    for g in getattr(api, "rule_groups", []):
        g.stop()
    srv.stop()
    for isrv in getattr(api, "ingest_servers", []):
        isrv.stop()
    if getattr(api, "pusher", None) is not None:
        api.pusher.stop()
    if getattr(api, "selfscraper", None) is not None:
        api.selfscraper.stop()
    if api.stream_aggr is not None:
        api.stream_aggr.stop(final_flush=True)
    storage.close()


def main(argv=None):
    import threading
    import faulthandler
    faulthandler.register(signal.SIGUSR1)

    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    try:
        with configfile.exit_on_error():
            storage, srv, _api = build(args)
    except SystemExit as e:
        logger.errorf("vmsingle: startup failed: %s", e.code)
        raise
    logger.infof("vmsingle started: data=%s listen=%s",
                 args.storageDataPath, args.httpListenAddr)

    # serve from a daemon thread; the main thread blocks on the stop event.
    # Calling HTTPServer.shutdown() from inside a signal handler interrupting
    # serve_forever deadlocks (shutdown() joins the loop it interrupted).
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    def _reload(*_):
        # SIGHUP hot-reload of -relabelConfig and -streamAggr.config
        try:
            if args.relabel_config:
                from ..ingest.relabel import parse_relabel_configs
                _api.relabel = parse_relabel_configs(
                    open(args.relabel_config).read())
            if args.streamaggr_config:
                from ..ingest.streamaggr import load_from_text
                new = load_from_text(
                    open(args.streamaggr_config).read(),
                    lambda rows: storage.add_rows(rows))
                old = _api.stream_aggr
                new.start()
                _api.stream_aggr = new
                if old is not None:
                    old.stop()
            logger.infof("vmsingle: config reloaded")
        except Exception as e:
            logger.errorf("vmsingle: reload failed, keeping old config: %s",
                          e)
    signal.signal(signal.SIGHUP, _reload)
    srv.start()
    try:
        while not stop.wait(1.0):
            pass
    finally:
        logger.infof("vmsingle: shutting down")
        shutdown(srv, storage, _api)
        logger.infof("vmsingle: shutdown complete")


if __name__ == "__main__":
    main()
