"""vmselect: query node (reference app/vmselect in cluster mode): the full
MetricsQL engine over a scatter-gather ClusterStorage backend, with
partial-result tracking (isPartial) and -search.denyPartialResponse.

Run: python -m victoriametrics_tpu_torch.apps.vmselect
-storageNode=HOST:INSERT_PORT:SELECT_PORT,... [-replicationFactor=N]
[-search.tpuBackend=false] -httpListenAddr=:8481

The port's copy of ``victoriametrics_tpu/apps/vmselect.py``, with the
reference's flags, environment variables, routes and shutdown order.
``-search.tpuBackend`` (on unless given ``=false``) attaches the CUDA
engine through vmsingle's ``_attach_cuda_engine`` before ``build``
returns, and a failed attach ends startup with an error naming the
cause.  The Graphite query API
(``httpapi/graphite_api.py``) is registered over the ``ClusterStorage``.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..utils import logger
from .vminsert import make_nodes
from .vmsingle import parse_bool


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmselect")
    p.add_argument("-storageNode", action="append", default=[],
                   help="host:insertPort:selectPort, repeatable")
    p.add_argument("-httpListenAddr", default=":8481")
    p.add_argument("-search.denyPartialResponse", dest="deny_partial",
                   action="store_true")
    p.add_argument("-rpc.timeout", dest="rpc_timeout", type=float,
                   default=10.0)
    p.add_argument("-replicationFactor", dest="replication_factor",
                   type=int, default=1,
                   help="how many storage nodes hold each series (must "
                        "match vminsert): with RF=N, up to N-1 failed "
                        "nodes keep results complete (replica-covered) "
                        "instead of partial")
    p.add_argument("-search.tpuBackend", dest="tpu", nargs="?", const=True,
                   default=True, type=parse_bool,
                   help="route supported rollups to the CUDA engine "
                        "(default true; =false serves on the host)")
    p.add_argument("-search.maxUniqueTimeseries", dest="max_series",
                   type=int, default=300_000)
    p.add_argument("-search.maxSamplesPerQuery", dest="max_samples_per_query",
                   type=int, default=1_000_000_000)
    p.add_argument("-search.maxMemoryPerQuery", dest="max_memory_per_query",
                   type=int, default=0)
    p.add_argument("-search.maxQueryDuration", dest="max_query_duration",
                   default="30s")
    p.add_argument("-clusternativeListenAddr", dest="native_addr", default="",
                   help="expose the vmselect RPC API so a higher-level "
                        "vmselect can use this node as a storage backend "
                        "(multilevel federation)")
    p.add_argument("-selfScrapeInterval", dest="self_scrape_interval",
                   default="",
                   help="scrape own /metrics into the cluster every "
                        "interval (15s when set to 1); empty/0 = off")
    p.add_argument("-loggerLevel", default="INFO")
    args, _ = p.parse_known_args(argv)
    env = os.environ.get("VM_STORAGENODE")
    if env:
        args.storageNode = env.split(",")
    return args


def build(args):
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..httpapi.server import HTTPServer
    from ..parallel.cluster_api import ClusterStorage

    if not args.storageNode:
        raise SystemExit("vmselect: at least one -storageNode is required")
    cluster = ClusterStorage(
        make_nodes(args.storageNode, getattr(args, "rpc_timeout", 10.0)),
        replication_factor=getattr(args, "replication_factor", 1),
        deny_partial_response=args.deny_partial)
    hh, _, hp = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(hh or "0.0.0.0", int(hp))
    from .vmsingle import _attach_cuda_engine, _dur_ms
    api = PrometheusAPI(
        cluster, None, max_series=args.max_series,
        max_samples_per_query=args.max_samples_per_query,
        max_memory_per_query=args.max_memory_per_query,
        max_query_duration_ms=_dur_ms(args.max_query_duration))
    api.register(srv, mode="select")
    from ..parallel.cluster_api import register_cluster_admin
    register_cluster_admin(srv, cluster)
    from ..httpapi.graphite_api import GraphiteAPI
    GraphiteAPI(cluster).register(srv)
    try:
        # the card attaches before anything is served
        _attach_cuda_engine(api, args.tpu)
    except BaseException:
        srv.stop()
        cluster.close()
        raise
    from ..utils import profiler
    profiler.ensure_started()
    # self-monitoring plane: own registry -> cluster write path (sharded
    # + rerouted like any ingested series); SLO evals ride the tick
    from ..utils import selfscrape
    api.selfscraper = selfscrape.maybe_start(
        cluster.add_rows, "vmselect", int(hp),
        flag_value=args.self_scrape_interval, extra=api.app_metrics,
        on_tick=lambda now_ms: api.init_sloplane().maybe_eval(now_ms))
    native_srv = None
    if getattr(args, "native_addr", ""):
        from ..parallel.cluster_api import start_native_server
        from ..parallel.rpc import HELLO_SELECT
        native_srv = start_native_server(args.native_addr, HELLO_SELECT,
                                         cluster)
    return cluster, srv, api, native_srv


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    try:
        cluster, srv, _api, native_srv = build(args)
    except SystemExit as e:
        logger.errorf("vmselect: startup failed: %s", e.code)
        raise
    srv.start()
    logger.infof("vmselect started: nodes=%d http=%d", len(cluster.nodes),
                 srv.port)
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
        logger.infof("vmselect: shutdown complete")


if __name__ == "__main__":
    main()
