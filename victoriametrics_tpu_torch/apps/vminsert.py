"""vminsert: ingestion router (reference app/vminsert in cluster mode):
accepts every ingest protocol over HTTP and shards rows across vmstorage
nodes by consistent hash with replication + rerouting.

Run: python -m victoriametrics_tpu_torch.apps.vminsert
-storageNode=HOST:INSERT_PORT[:SELECT_PORT],... [-replicationFactor=N]
-httpListenAddr=:8480

The port's copy of ``victoriametrics_tpu/apps/vminsert.py``, with the
reference's flags, environment variables, routes and shutdown order.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..utils import logger


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vminsert")
    p.add_argument("-storageNode", action="append", default=[],
                   help="host:insertPort:selectPort, repeatable")
    p.add_argument("-httpListenAddr", default=":8480")
    p.add_argument("-replicationFactor", type=int, default=1)
    p.add_argument("-rpc.timeout", dest="rpc_timeout", type=float,
                   default=10.0, help="storage-node RPC timeout, seconds "
                   "(-vmstorageDialTimeout analog)")
    p.add_argument("-clusternativeListenAddr", dest="native_addr", default="",
                   help="expose the vminsert RPC API so a higher-level "
                        "vminsert can chain into this one (multilevel)")
    p.add_argument("-loggerLevel", default="INFO")
    p.add_argument("-maxIngestionRate", dest="max_ingestion_rate",
                   type=int, default=0,
                   help="rows/s ingest ceiling, 0 = unlimited")
    p.add_argument("-selfScrapeInterval", dest="self_scrape_interval",
                   default="",
                   help="scrape own /metrics into the cluster every "
                        "interval (15s when set to 1); empty/0 = off")
    args, _ = p.parse_known_args(argv)
    env = os.environ.get("VM_STORAGENODE")
    if env:
        args.storageNode = env.split(",")
    return args


def make_nodes(specs: list[str], timeout: float = 10.0):
    from ..parallel.cluster_api import StorageNodeClient, parse_node_spec
    nodes = []
    for spec in specs:
        # host:insertPort:selectPort (vmstorage) or host:port (a
        # multilevel child's -clusternativeListenAddr)
        host, ip_, sp_ = parse_node_spec(spec)
        nodes.append(StorageNodeClient(host, ip_, sp_, timeout=timeout))
    return nodes


def build(args):
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..httpapi.server import HTTPServer
    from ..parallel.cluster_api import ClusterStorage

    if not args.storageNode:
        raise SystemExit("vminsert: at least one -storageNode is required")
    cluster = ClusterStorage(
        make_nodes(args.storageNode, getattr(args, "rpc_timeout", 10.0)),
        replication_factor=args.replicationFactor)
    hh, _, hp = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(hh or "0.0.0.0", int(hp))
    rate_limiter = None
    if getattr(args, "max_ingestion_rate", 0) > 0:
        from ..ingest.ratelimiter import TenantRateLimiters
        rate_limiter = TenantRateLimiters(
            global_limit=args.max_ingestion_rate)
    api = PrometheusAPI(cluster, rate_limiter=rate_limiter)
    api.register(srv, mode="insert")
    from ..parallel.cluster_api import register_cluster_admin
    register_cluster_admin(srv, cluster)
    # self-monitoring plane: own registry -> cluster write path (no SLO
    # pump here — a vminsert has no select channel to evaluate over)
    from ..utils import selfscrape
    api.selfscraper = selfscrape.maybe_start(
        cluster.add_rows, "vminsert", int(hp),
        flag_value=args.self_scrape_interval, extra=api.app_metrics)
    native_srv = None
    if getattr(args, "native_addr", ""):
        from ..parallel.cluster_api import start_native_server
        from ..parallel.rpc import HELLO_INSERT
        native_srv = start_native_server(args.native_addr, HELLO_INSERT,
                                         cluster,
                                         rate_limiter=rate_limiter)
    return cluster, srv, api, native_srv


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    cluster, srv, _api, native_srv = build(args)
    srv.start()
    logger.infof("vminsert started: nodes=%d rf=%d http=%d",
                 len(cluster.nodes), cluster.rf, srv.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    finally:
        srv.stop()
        if getattr(_api, "selfscraper", None) is not None:
            _api.selfscraper.stop()
        if native_srv is not None:
            native_srv.stop()
        cluster.close()
        logger.infof("vminsert: shutdown complete")


if __name__ == "__main__":
    main()
