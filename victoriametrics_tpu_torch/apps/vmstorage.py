"""vmstorage: storage node process (reference app/vmstorage/main.go:114-217):
the Storage engine + vminsert/vmselect RPC servers + maintenance HTTP
(/metrics, /snapshot/*, /internal/force_*).

Run: python -m victoriametrics_tpu_torch.apps.vmstorage
-storageDataPath=DIR -vminsertAddr=:8400 -vmselectAddr=:8401
-httpListenAddr=:8482

The port's copy of ``victoriametrics_tpu/apps/vmstorage.py``, with the
reference's flags, environment variables, routes and shutdown order.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..utils import logger


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmstorage")
    p.add_argument("-storageDataPath", default="vmstorage-data")
    p.add_argument("-httpListenAddr", default=":8482")
    p.add_argument("-vminsertAddr", default=":8400")
    p.add_argument("-vmselectAddr", default=":8401")
    p.add_argument("-retentionPeriod", default="13m")
    p.add_argument("-dedup.minScrapeInterval", dest="dedup_interval",
                   default="0s")
    p.add_argument("-selfScrapeInterval", dest="self_scrape_interval",
                   default="",
                   help="scrape own /metrics into local storage every "
                        "interval (15s when set to 1); empty/0 = off")
    p.add_argument("-loggerLevel", default="INFO")
    args, _ = p.parse_known_args(argv)
    for name in vars(args):
        env = os.environ.get("VM_" + name.upper().replace(".", "_"))
        if env is not None:
            setattr(args, name, env)
    return args


def build(args):
    from ..httpapi.server import HTTPServer, Response
    from ..parallel.cluster_api import make_storage_handlers
    from ..parallel.rpc import HELLO_INSERT, HELLO_SELECT, RPCServer
    from ..storage.storage import Storage
    from .vmsingle import _dur_ms

    storage = Storage(args.storageDataPath,
                      retention_ms=_dur_ms(args.retentionPeriod, months_ok=True),
                      dedup_interval_ms=_dur_ms(args.dedup_interval)
                      if args.dedup_interval != "0s" else 0)
    handlers = make_storage_handlers(storage)
    ih, _, ip = args.vminsertAddr.rpartition(":")
    sh, _, sp = args.vmselectAddr.rpartition(":")
    insert_srv = RPCServer(ih or "0.0.0.0", int(ip), HELLO_INSERT, handlers)
    select_srv = RPCServer(sh or "0.0.0.0", int(sp), HELLO_SELECT, handlers)

    hh, _, hp = args.httpListenAddr.rpartition(":")
    http = HTTPServer(hh or "0.0.0.0", int(hp))
    http.route("/health", lambda req: Response.text("OK"))
    from ..utils import metrics as metricslib
    http.route("/metrics", lambda req: Response.text(
        metricslib.REGISTRY.write_prometheus(extra=storage.metrics())))
    http.route("/snapshot/create", lambda req: Response.json(
        {"status": "ok", "snapshot": storage.create_snapshot()}))
    http.route("/snapshot/list", lambda req: Response.json(
        {"status": "ok", "snapshots": storage.list_snapshots()}))
    http.route("/internal/force_flush",
               lambda req: (storage.force_flush(), Response.text("OK"))[1])
    http.route("/internal/force_merge",
               lambda req: (storage.force_merge(), Response.text("OK"))[1])
    # integrity quarantine listing (parts moved aside by the open-time
    # checksum verification; non-empty => this node serves partial)
    def h_quarantine(req):
        rep = storage.quarantine_report()
        return Response.json(
            {"status": "success",
             "data": {"quarantined": rep, "count": len(rep),
                      "partial": bool(rep)}})
    http.route("/api/v1/status/quarantine", h_quarantine)

    # chaos control seam (devtools/faultinject, shared handler): GET
    # lists, ?set= replaces, ?clear=1 disarms; 403 unless the process
    # opted into chaos via VM_FAULT_INJECT=1 / VM_FAULTS
    from ..devtools import faultinject
    http.route("/internal/faults",
               lambda req: faultinject.handle_http(req, Response))
    # cost-and-profile plane: the node's continuous profiler (also
    # served over profile_v1 to vmselects) + its node-local per-tenant
    # usage table (search RPCs account into it)
    from ..utils import costacc, profiler
    profiler.ensure_started()
    http.route("/api/v1/status/profile",
               lambda req: profiler.handle_http(req, Response))
    http.route("/api/v1/status/usage", lambda req: Response.json(
        {"status": "success",
         "data": {"tenants": costacc.TENANT_USAGE.snapshot(
             reset=req.arg("reset") == "1")}}))
    # node-local health verdict, also served to vmselects as health_v1
    from ..query import sloplane
    http.route("/api/v1/status/health", lambda req: Response.json(
        sloplane.local_health(storage=storage, role="vmstorage")))
    # self-monitoring plane: own registry -> own storage as real series
    from ..utils import selfscrape
    scraper = selfscrape.maybe_start(
        storage.add_rows, "vmstorage", int(hp),
        flag_value=args.self_scrape_interval,
        extra=lambda: dict(storage.metrics()))
    return storage, insert_srv, select_srv, http, scraper


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    storage, insert_srv, select_srv, http, scraper = build(args)
    insert_srv.start()
    select_srv.start()
    http.start()
    logger.infof("vmstorage started: data=%s insert=%d select=%d http=%d",
                 args.storageDataPath, insert_srv.port, select_srv.port,
                 http.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    finally:
        logger.infof("vmstorage: shutting down")
        insert_srv.stop()
        select_srv.stop()
        http.stop()
        if scraper is not None:
            # before storage.close(): a late scrape must not write into
            # a closed storage
            scraper.stop()
        storage.close()
        logger.infof("vmstorage: shutdown complete")


if __name__ == "__main__":
    main()
