"""The port's cluster (``parallel/rpc``, ``consistenthash``, ``ringfilter``,
``cluster_api``) held to the reference's cluster tests: every case of
``tests/test_cluster.py``, ``test_cluster_columnar.py``,
``test_vmselectapi_parity.py`` and ``test_elastic_cluster.py`` and the
cluster cases of ``test_tenant_gate.py`` (deadline-propagating RPC, the
killed node, pooled selects, shed load across the hop), written once and
run against both packages (``pkg``), each node a real ``Storage`` behind
real RPC servers on localhost.  The data sits two days back (inside the
13-month retention; the reference's own files date theirs July 2025).

Beside them:

- the wire: the port's hello bytes, frames and placement are the
  reference's, and a frame the port writes with zlib (a host without
  zstd) is read by the reference;
- mixed clusters: the reference's ``ClusterStorage`` over the port's
  storage nodes, the port's over the reference's, and one cluster of
  both, each answering as a single node does (columns exactly, a query
  at rtol 1e-12);
- the device path: vmselect's ``sum by (instance)(rate(m[5m]))`` over a
  cluster through the port's ``PrometheusAPI`` with ``CUDAEngine(device=
  "cpu", min_series=4)`` (the kernels' plain versions; route K1 + K2 by
  the engine's dispatches) against the reference's with ``TPUEngine`` and
  against the host evaluator, at rtol 1e-12.

The process-level chaos scenarios (``tests/test_chaos_cluster.py``) stay
out of tier 1, as the reference keeps them; the apps as processes are in
``tests/test_torch_cluster_apps.py``.
"""

import collections
import json
import socket
import threading
import time
import types

import numpy as np
import pytest

DAY = 86_400_000
T0 = (int(time.time() * 1000) - 2 * DAY) // 60_000 * 60_000


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu import native
        from victoriametrics_tpu.devtools import faultinject
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.httpapi.server import HTTPServer
        from victoriametrics_tpu.ops import compress
        from victoriametrics_tpu.parallel import cluster_api, ringfilter, rpc
        from victoriametrics_tpu.parallel.consistenthash import \
            ConsistentHash
        from victoriametrics_tpu.query.exec import exec_query
        from victoriametrics_tpu.query.types import EvalConfig
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import (
            TagFilter, filters_from_dict)
        from victoriametrics_tpu.utils import costacc
        from victoriametrics_tpu.utils import fs as fslib
        from victoriametrics_tpu.utils import metrics as metricslib
        from victoriametrics_tpu.utils import querytracer
        from victoriametrics_tpu.utils.workpool import SearchLimitError
    else:
        from victoriametrics_tpu_torch import native
        from victoriametrics_tpu_torch.devtools import faultinject
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.httpapi.server import HTTPServer
        from victoriametrics_tpu_torch.ops import compress
        from victoriametrics_tpu_torch.parallel import (cluster_api,
                                                        ringfilter, rpc)
        from victoriametrics_tpu_torch.parallel.consistenthash import \
            ConsistentHash
        from victoriametrics_tpu_torch.query.exec import exec_query
        from victoriametrics_tpu_torch.query.types import EvalConfig
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import (
            TagFilter, filters_from_dict)
        from victoriametrics_tpu_torch.utils import costacc
        from victoriametrics_tpu_torch.utils import fs as fslib
        from victoriametrics_tpu_torch.utils import metrics as metricslib
        from victoriametrics_tpu_torch.utils import querytracer
        from victoriametrics_tpu_torch.utils.workpool import SearchLimitError
    return types.SimpleNamespace(
        name=name, native=native, faultinject=faultinject,
        PrometheusAPI=PrometheusAPI, HTTPServer=HTTPServer,
        compress=compress, cluster_api=cluster_api, ringfilter=ringfilter,
        rpc=rpc, ConsistentHash=ConsistentHash, exec_query=exec_query,
        EvalConfig=EvalConfig, Storage=Storage, TagFilter=TagFilter,
        filters_from_dict=filters_from_dict, costacc=costacc, fslib=fslib,
        metricslib=metricslib, querytracer=querytracer,
        SearchLimitError=SearchLimitError,
        ClusterStorage=cluster_api.ClusterStorage,
        StorageNodeClient=cluster_api.StorageNodeClient,
        make_storage_handlers=cluster_api.make_storage_handlers,
        PartialResultError=cluster_api.PartialResultError,
        RPCServer=rpc.RPCServer, RPCClient=rpc.RPCClient,
        RPCError=rpc.RPCError, RPCDeadlineError=rpc.RPCDeadlineError,
        Writer=rpc.Writer, HELLO_INSERT=rpc.HELLO_INSERT,
        HELLO_SELECT=rpc.HELLO_SELECT)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    for name in ("ref", "port"):
        _package(name).faultinject.configure("")


def serve(srv):
    """Start an RPCServer whose accept loop polls every 20 ms instead of
    0.5 s (its stop waits out one poll: the tests stop hundreds)."""
    srv._thread = threading.Thread(target=srv._srv.serve_forever,
                                   args=(0.02,), daemon=True)
    srv.start()
    return srv


class StorageNode:
    """One in-process vmstorage of package `pkg`: a Storage and both RPC
    planes on localhost."""

    def __init__(self, pkg, path, legacy=False):
        self.pkg = pkg
        self.storage = pkg.Storage(str(path))
        handlers = pkg.make_storage_handlers(self.storage)
        if legacy:  # a node from before the columnar protocol
            handlers.pop("writeRowsColumnar_v1")
            handlers.pop("searchColumns_v1")
        self.insert_srv = serve(pkg.RPCServer(
            "127.0.0.1", 0, pkg.HELLO_INSERT, handlers))
        self.select_srv = serve(pkg.RPCServer(
            "127.0.0.1", 0, pkg.HELLO_SELECT, handlers))
        self.stopped = False

    def client(self, pkg=None, timeout=10.0):
        """A client of package `pkg` (the node's own by default)."""
        return (pkg or self.pkg).StorageNodeClient(
            "127.0.0.1", self.insert_srv.port, self.select_srv.port,
            timeout=timeout)

    @property
    def spec(self) -> str:
        return f"127.0.0.1:{self.insert_srv.port}:{self.select_srv.port}"

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        side_by_side([self.insert_srv.stop, self.select_srv.stop])
        self.storage.close()


def side_by_side(fns):
    """Call each of `fns` in a thread of its own and wait for all: a
    server's shutdown waits out its accept loop's 0.5 s poll, so servers
    stopped one after another cost that much each."""
    ths = [threading.Thread(target=fn) for fn in fns]
    for t in ths:
        t.start()
    for t in ths:
        t.join()


def stop_all(nodes):
    side_by_side([n.stop for n in nodes])


def make_nodes(pkg, tmp_path, n=3, legacy_idx=(), tag="n"):
    return [StorageNode(pkg, tmp_path / f"{tag}{i}", legacy=i in legacy_idx)
            for i in range(n)]


@pytest.fixture()
def nodes3(pkg, tmp_path):
    nodes = make_nodes(pkg, tmp_path)
    yield nodes
    stop_all(nodes)


@pytest.fixture()
def nodes2(pkg, tmp_path):
    nodes = make_nodes(pkg, tmp_path, n=2)
    yield nodes
    stop_all(nodes)


def seed_rows(n_series=30, n_samples=10):
    return [({"__name__": "cm", "idx": str(i)}, T0 + j * 15_000,
             float(i * 100 + j))
            for i in range(n_series) for j in range(n_samples)]


def cm(pkg):
    return pkg.filters_from_dict({"__name__": "cm"})


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------

class TestConsistentHash:
    def test_stable_and_balanced(self, pkg):
        ch = pkg.ConsistentHash(["a", "b", "c"])
        keys = [f"key{i}".encode() for i in range(3000)]
        place = [ch.nodes_for_key(k, 1)[0] for k in keys]
        assert place == [ch.nodes_for_key(k, 1)[0] for k in keys]
        counts = [place.count(i) for i in range(3)]
        assert min(counts) > 1000 * 0.7
        assert len(set(ch.nodes_for_key(b"x", 3))) == 3

    def test_exclusion_reroutes_minimally(self, pkg):
        ch = pkg.ConsistentHash(["a", "b", "c"])
        keys = [f"key{i}".encode() for i in range(1000)]
        base = [ch.nodes_for_key(k, 1)[0] for k in keys]
        moved = sum(1 for k, b in zip(keys, base)
                    if b != 2 and ch.nodes_for_key(k, 1, {2})[0] != b)
        assert moved == 0


class TestClusterWriteRead:
    def test_sharding_distributes_series(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        cluster.add_rows(seed_rows())
        for n in nodes3:
            n.storage.force_flush()
        per_node = [n.storage.series_count() for n in nodes3]
        assert sum(per_node) == 30
        assert all(c > 0 for c in per_node)
        res = cluster.search_series(cm(pkg), T0, T0 + 10_000_000)
        assert len(res) == 30
        assert all(r.timestamps.size == 10 for r in res)
        cluster.close()

    def test_replication_and_dedup(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3],
                                     replication_factor=2)
        cluster.add_rows(seed_rows())
        assert sum(n.storage.series_count() for n in nodes3) == 60
        res = cluster.search_series(cm(pkg), T0, T0 + 10_000_000)
        assert len(res) == 30
        assert all(r.timestamps.size == 10 for r in res)
        cluster.close()

    def test_node_failure_rf2_full_results(self, pkg, nodes3):
        avoided = pkg.cluster_api._PARTIAL_AVOIDED
        cluster = pkg.ClusterStorage([n.client() for n in nodes3],
                                     replication_factor=2)
        cluster.add_rows(seed_rows())
        nodes3[0].stop()
        before = avoided.get()
        res = cluster.search_series(cm(pkg), T0, T0 + 10_000_000)
        assert not cluster.last_partial
        assert avoided.get() > before
        assert len(res) == 30
        cluster.close()

    def test_node_failure_rf1_partial(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        cluster.add_rows(seed_rows())
        nodes3[1].stop()
        res = cluster.search_series(cm(pkg), T0, T0 + 10_000_000)
        assert cluster.last_partial
        assert 0 < len(res) < 30
        cluster.close()

    def test_deny_partial_response(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3],
                                     deny_partial_response=True)
        cluster.add_rows(seed_rows())
        nodes3[2].stop()
        with pytest.raises(pkg.PartialResultError):
            cluster.search_series(cm(pkg), T0, T0 + 10_000_000)
        cluster.close()

    def test_write_rerouting_on_dead_node(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        nodes3[0].stop()
        cluster.add_rows(seed_rows())
        assert cluster.reroutes >= 0
        assert sum(n.storage.series_count() for n in nodes3[1:]) == 30
        cluster.close()

    def test_label_apis_and_delete(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        cluster.add_rows(seed_rows(n_series=6))
        assert cluster.label_names() == ["__name__", "idx"]
        assert cluster.label_values("idx") == [str(i) for i in range(6)]
        assert cluster.series_count() == 6
        assert cluster.tsdb_status()["totalSeries"] == 6
        assert cluster.delete_series(pkg.filters_from_dict({"idx": "0"})) == 1
        assert len(cluster.search_series(cm(pkg), T0, T0 + 10_000_000)) == 5
        cluster.close()


class TestClusterQueryEngine:
    def test_metricsql_over_cluster(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3],
                                     replication_factor=2)
        cluster.add_rows([({"__name__": "reqs", "inst": f"h{i % 4}",
                            "cpu": str(i)}, T0 + j * 15_000, float(10 * j))
                          for i in range(12) for j in range(41)])
        ec = pkg.EvalConfig(start=T0 + 300_000, end=T0 + 600_000,
                            step=60_000, storage=cluster)
        out = pkg.exec_query(ec, "sum by (inst) (rate(reqs[5m]))")
        assert len(out) == 4
        for ts in out:
            np.testing.assert_allclose(ts.values, 3 * 10 / 15, rtol=1e-9)
        cluster.close()

    def test_http_cluster_roundtrip(self, pkg, nodes3):
        from tests.apptest_helpers import Client
        insert_cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        select_cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        isrv = pkg.HTTPServer("127.0.0.1", 0)
        pkg.PrometheusAPI(insert_cluster).register(isrv, mode="insert")
        isrv.start()
        ssrv = pkg.HTTPServer("127.0.0.1", 0)
        pkg.PrometheusAPI(select_cluster).register(ssrv, mode="select")
        ssrv.start()
        try:
            ic, sc = Client(isrv.port), Client(ssrv.port)
            line = json.dumps({"metric": {"__name__": "hm", "a": "b"},
                               "values": [4.5], "timestamps": [T0]})
            code, _ = ic.post("/api/v1/import", line.encode())
            assert code == 204
            res = sc.query("hm", T0 / 1e3 + 10)
            assert res["data"]["result"][0]["value"][1] == "4.5"
            assert res["isPartial"] is False
            assert ic.get("/api/v1/query", query="hm")[0] == 404
            assert sc.post("/api/v1/import", line.encode())[0] == 404
        finally:
            isrv.stop()
            ssrv.stop()
            insert_cluster.close()
            select_cluster.close()


class TestRPCFailureHandling:
    def test_no_deadlock_on_dead_node_concurrent_calls(self, pkg, tmp_path):
        node = StorageNode(pkg, tmp_path / "n")
        client = node.client()
        client.write_rows([(b"m", T0, 1.0)])
        node.stop()
        # the dead node's select port stays bound, not listening: a
        # server of another test process cannot take it and answer
        held = socket.socket()
        held.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        held.bind(("127.0.0.1", node.select_srv.port))
        errs, done = [], []

        def caller():
            try:
                client.search_series(pkg.filters_from_dict(
                    {"__name__": "m"}), T0, T0 + 1000)
            except Exception as e:
                errs.append(type(e).__name__)
            done.append(1)

        ths = [threading.Thread(target=caller, daemon=True)
               for _ in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=15)
        assert len(done) == 3, "callers deadlocked on the connection lock"
        assert len(errs) == 3
        client.close()
        held.close()

    def test_stale_connection_retries_after_node_restart(self, pkg,
                                                         tmp_path):
        node = StorageNode(pkg, tmp_path / "n")
        ip, sp = node.insert_srv.port, node.select_srv.port
        client = pkg.StorageNodeClient("127.0.0.1", ip, sp)
        client.write_rows([(b"m1", T0, 1.0)])
        node.insert_srv.stop()
        node.select_srv.stop()
        handlers = pkg.make_storage_handlers(node.storage)
        node.insert_srv = serve(pkg.RPCServer(
            "127.0.0.1", ip, pkg.HELLO_INSERT, handlers))
        node.select_srv = serve(pkg.RPCServer(
            "127.0.0.1", sp, pkg.HELLO_SELECT, handlers))
        client.write_rows([(b"m2", T0, 2.0)])
        assert node.storage.series_count() >= 1
        client.close()
        node.stop()


class TestMultilevel:
    def test_vmselect_over_vmselect(self, pkg, nodes3):
        lower = pkg.ClusterStorage([n.client() for n in nodes3])
        lower.add_rows(seed_rows(n_series=8))
        lower_rpc = serve(pkg.RPCServer("127.0.0.1", 0, pkg.HELLO_SELECT,
                                        pkg.make_storage_handlers(lower)))
        upper = pkg.ClusterStorage([pkg.StorageNodeClient(
            "127.0.0.1", lower_rpc.port, lower_rpc.port)])
        try:
            res = upper.search_series(cm(pkg), T0, T0 + 10_000_000)
            assert len(res) == 8
            assert upper.label_values("idx") == [str(i) for i in range(8)]
            ec = pkg.EvalConfig(start=T0, end=T0 + 120_000, step=60_000,
                                storage=upper)
            assert pkg.exec_query(ec, "count(cm)")[0].values[-1] == 8.0
        finally:
            upper.close()
            lower_rpc.stop()
            lower.close()

    def test_parse_node_spec_forms(self, pkg):
        parse = pkg.cluster_api.parse_node_spec
        assert parse("127.0.0.1:8400:8401") == ("127.0.0.1", 8400, 8401)
        assert parse("10.0.0.5:9000") == ("10.0.0.5", 9000, 9000)
        with pytest.raises(ValueError):
            parse("nonsense")

    def test_tree_rows_byte_identical_to_flat(self, pkg, nodes2):
        """vmselect -> vmselect -> 2x vmstorage rows equal the flat
        fan-out's; the cost, the trace and a partial cross the tree."""
        flat = pkg.ClusterStorage([n.client() for n in nodes2])
        seed_em(flat, name="ml", n=80)
        mid = pkg.ClusterStorage([n.client() for n in nodes2])
        mid_srv = pkg.cluster_api.start_native_server(
            "127.0.0.1:0", pkg.HELLO_SELECT, mid)
        try:
            top = pkg.ClusterStorage([pkg.StorageNodeClient(
                "127.0.0.1", mid_srv.port, mid_srv.port)])
            want = fetch_em(pkg, flat, "ml")
            assert want.n_series == 80
            assert_same(want, fetch_em(pkg, top, "ml"))
            tr = pkg.costacc.CostTracker()
            prev = pkg.costacc.set_current(tr)
            try:
                fetch_em(pkg, top, "ml")
            finally:
                pkg.costacc.set_current(prev)
            assert tr.storage_samples > 0 and tr.remote_nodes >= 1
            qt = pkg.querytracer.new(True, "top")
            top.search_columns([pkg.TagFilter(b"", b"ml")], T0, T0 + 60_000,
                               tracer=qt)
            qt.donef("done")
            assert json.dumps(qt.to_dict()).count("searchColumns_v1") >= 3
            mid.nodes[0].mark_down(30.0)
            top.reset_partial()
            part = fetch_em(pkg, top, "ml")
            assert top.last_partial and 0 < part.n_series < 80
            mid.nodes[0].down_until = 0.0
            top.close()
        finally:
            mid_srv.stop()
            mid.close()
            flat.close()


class TestClusterMultitenancy:
    def test_tenant_isolation_across_nodes(self, pkg, nodes3):
        cs = pkg.ClusterStorage([n.client() for n in nodes3])
        t1, t2 = (5, 0), (5, 1)
        cs.add_rows([({"__name__": "mt", "i": str(i)}, T0, float(i))
                     for i in range(20)], tenant=t1)
        cs.add_rows([({"__name__": "mt", "i": str(i)}, T0, float(i + 100))
                     for i in range(10)], tenant=t2)
        f = pkg.filters_from_dict({"__name__": "mt"})
        r1 = cs.search_series(f, T0 - 1000, T0 + 1000, tenant=t1)
        r2 = cs.search_series(f, T0 - 1000, T0 + 1000, tenant=t2)
        assert len(r1) == 20 and len(r2) == 10
        assert {float(s.values[0]) for s in r2} == {
            float(i + 100) for i in range(10)}
        assert cs.search_series(f, T0 - 1000, T0 + 1000) == []
        assert set(cs.tenants()) >= {t1, t2}
        assert cs.series_count(tenant=t1) == 20
        assert cs.delete_series(f, tenant=t2) == 10
        assert cs.search_series(f, T0 - 1000, T0 + 1000, tenant=t2) == []
        assert len(cs.search_series(f, T0 - 1000, T0 + 1000,
                                    tenant=t1)) == 20
        cs.close()


# ---------------------------------------------------------------------------
# tests/test_cluster_columnar.py
# ---------------------------------------------------------------------------

def columnar_batch(pkg, n_series=40, n_samples=12, name="ccm", t0=T0):
    keys = [f'{name}{{idx="{i}",job="j{i % 4}"}}'.encode()
            for i in range(n_series)]
    klens = np.fromiter((len(k) for k in keys), np.int64, n_series)
    koffs = np.concatenate([[0], np.cumsum(klens)[:-1]])
    ts = t0 + np.arange(n_samples, dtype=np.int64)[None, :] * 15_000
    ts = np.broadcast_to(ts, (n_series, n_samples)).reshape(-1)
    vals = (np.arange(n_series, dtype=np.float64)[:, None] * 100 +
            np.arange(n_samples)[None, :]).reshape(-1)
    return pkg.native.ColumnarRows(b"".join(keys),
                                   np.repeat(koffs, n_samples),
                                   np.repeat(klens, n_samples),
                                   ts.copy(), vals.copy())


def fetch_all(pkg, cluster, name="ccm"):
    cols = cluster.search_columns(pkg.filters_from_dict({"__name__": name}),
                                  T0 - 10**6, T0 + 10**9)
    return {cols.raw_names[s]: (cols.ts[s, :int(cols.counts[s])].tolist(),
                                cols.vals[s, :int(cols.counts[s])].tolist())
            for s in range(cols.n_series)}


class TestColumnarWrite:
    def test_shards_and_reads_back(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        assert cluster.add_rows_columnar(columnar_batch(pkg)) == 40 * 12
        for n in nodes3:
            n.storage.force_flush()
        per_node = [n.storage.series_count() for n in nodes3]
        assert sum(per_node) == 40 and all(c > 0 for c in per_node)
        res = fetch_all(pkg, cluster)
        assert len(res) == 40
        assert all(len(ts) == 12 for ts, _ in res.values())
        cluster.close()

    def test_replication_and_replica_dedup(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3],
                                     replication_factor=2)
        cluster.add_rows_columnar(columnar_batch(pkg))
        assert sum(n.storage.series_count() for n in nodes3) == 80
        res = fetch_all(pkg, cluster)
        assert len(res) == 40
        assert all(len(ts) == 12 for ts, _ in res.values())
        cluster.close()

    def test_reroute_on_dead_node(self, pkg, nodes3):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        nodes3[1].stop()
        assert cluster.add_rows_columnar(columnar_batch(pkg)) == 40 * 12
        assert sum(nodes3[i].storage.series_count() for i in (0, 2)) == 40
        cluster.close()

    def test_transform_relabels_before_sharding(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])

        def transform(labels):
            d = dict(labels)
            if d.get("idx") == "0":
                return None
            d["dc"] = "eu"
            return list(d.items())

        stats = {}
        n_ok = cluster.add_rows_columnar(columnar_batch(pkg),
                                         transform=transform,
                                         drop_stats=stats)
        assert n_ok == 39 * 12
        assert stats["transform"] == 12
        res = fetch_all(pkg, cluster)
        assert len(res) == 39
        assert all(b"dc" in raw for raw in res)
        cluster.close()

    def test_unroundtrippable_transformed_name_uses_legacy_path(self, pkg,
                                                                 nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])

        def transform(labels):
            d = dict(labels)
            d['weird="x"'] = "v"
            return list(d.items())

        n_ok = cluster.add_rows_columnar(columnar_batch(pkg, n_series=5),
                                         transform=transform)
        assert n_ok == 5 * 12
        assert sum(n.storage.series_count() for n in nodes2) == 5
        res = cluster.search_series(pkg.filters_from_dict(
            {"__name__": "ccm"}), T0 - 10**6, T0 + 10**9)
        assert len(res) == 5
        assert all(sd.metric_name.get_label(b'weird="x"') == b"v"
                   for sd in res)
        cluster.close()

    def test_rpc_and_transform_paths_do_not_share_verdicts(self, pkg,
                                                           nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        cluster.add_rows_columnar(columnar_batch(pkg, n_series=4))

        def transform(labels):
            d = dict(labels)
            if d.get("idx") == "1":
                return None
            d["dc"] = "eu"
            return list(d.items())

        stats: dict = {}
        n_ok = cluster.add_rows_columnar(columnar_batch(pkg, n_series=4),
                                         transform=transform,
                                         drop_stats=stats)
        assert n_ok == 3 * 12
        assert stats.get("transform") == 12
        cluster.close()

    def test_legacy_node_fallback(self, pkg, tmp_path):
        nodes = make_nodes(pkg, tmp_path, n=2, legacy_idx=(1,))
        try:
            cluster = pkg.ClusterStorage([n.client() for n in nodes])
            assert cluster.add_rows_columnar(columnar_batch(pkg)) == 40 * 12
            assert sum(n.storage.series_count() for n in nodes) == 40
            assert nodes[1].storage.series_count() > 0
            res = fetch_all(pkg, cluster)
            assert len(res) == 40
            assert all(len(ts) == 12 for ts, _ in res.values())
            cluster.close()
        finally:
            stop_all(nodes)


def assert_columns_equal(a, b):
    """Two ColumnarSeries: the same names in the same order, counts,
    timestamps and values (bit for bit)."""
    assert a.raw_names == b.raw_names and a.raw_names
    np.testing.assert_array_equal(a.counts, b.counts)
    for s in range(a.n_series):
        n = int(a.counts[s])
        np.testing.assert_array_equal(a.ts[s, :n], b.ts[s, :n])
        np.testing.assert_array_equal(a.vals[s, :n].view(np.int64),
                                      b.vals[s, :n].view(np.int64))


class TestColumnarReadEquivalence:
    def test_matches_single_node_storage(self, pkg, nodes3, tmp_path):
        single = pkg.Storage(str(tmp_path / "single"))
        try:
            cluster = pkg.ClusterStorage([n.client() for n in nodes3])
            cluster.add_rows_columnar(columnar_batch(pkg))
            single.add_rows_columnar(columnar_batch(pkg))
            f = pkg.filters_from_dict({"__name__": "ccm"})
            assert_columns_equal(
                cluster.search_columns(f, T0 - 10**6, T0 + 10**9),
                single.search_columns(f, T0 - 10**6, T0 + 10**9))
            sa = cluster.search_series(f, T0 - 10**6, T0 + 10**9)
            sb = single.search_series(f, T0 - 10**6, T0 + 10**9)
            assert [s.metric_name.marshal() for s in sa] == \
                [s.metric_name.marshal() for s in sb]
            cluster.close()
        finally:
            single.close()

    def test_query_engine_over_columnar_cluster(self, pkg, nodes3,
                                                tmp_path):
        single = pkg.Storage(str(tmp_path / "single"))
        try:
            cluster = pkg.ClusterStorage([n.client() for n in nodes3])
            cluster.add_rows_columnar(columnar_batch(pkg))
            single.add_rows_columnar(columnar_batch(pkg))
            q = "sum by (job)(rate(ccm[1m]))"
            kw = dict(start=T0 + 60_000, end=T0 + 150_000, step=30_000,
                      tpu=None)
            ra = pkg.exec_query(pkg.EvalConfig(storage=cluster, **kw), q)
            rb = pkg.exec_query(pkg.EvalConfig(storage=single, **kw), q)
            assert len(ra) == len(rb) == 4
            da = {ts.metric_name.marshal(): ts.values for ts in ra}
            db = {ts.metric_name.marshal(): ts.values for ts in rb}
            assert set(da) == set(db)
            for k in da:
                np.testing.assert_allclose(da[k], db[k], rtol=1e-12)
            cluster.close()
        finally:
            single.close()


# ---------------------------------------------------------------------------
# tests/test_vmselectapi_parity.py
# ---------------------------------------------------------------------------

def seed_parity(cluster):
    cluster.add_rows([({"__name__": name, "idx": str(i)},
                       T0 + i * 15_000, float(i))
                      for name in ("foo.bar.baz", "foo.bar.qux",
                                   "foo.other", "top") for i in range(3)])


class TestVmselectApiParity:
    def test_graphite_path_expansion(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        seed_parity(cluster)
        assert cluster.tag_value_suffixes("__name__", "", ".") == \
            ["foo.", "top"]
        assert cluster.tag_value_suffixes("__name__", "foo.", ".") == \
            ["bar.", "other"]
        assert cluster.tag_value_suffixes("__name__", "foo.bar.", ".") == \
            ["baz", "qux"]
        assert cluster.tag_value_suffixes("idx", "", ".") == ["0", "1", "2"]
        cluster.close()

    def test_single_node_storage(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            st.add_rows([({"__name__": "a.b.c", "x": "1"}, T0, 1.0)])
            assert st.tag_value_suffixes("__name__", "") == ["a."]
            assert st.tag_value_suffixes("__name__", "a.") == ["b."]
            assert st.tag_value_suffixes("__name__", "a.b.") == ["c"]
        finally:
            st.close()

    def test_tracks_and_resets_across_cluster(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        seed_parity(cluster)
        for _ in range(2):
            cluster.search_columns(pkg.filters_from_dict(
                {"__name__": ("=~", "foo\\..*")}), T0 - 1000, T0 + 10**6)
        cluster.search_columns(pkg.filters_from_dict({"__name__": "top"}),
                               T0 - 1000, T0 + 10**6)
        stats = cluster.metric_names_usage_stats()
        by_name = {x["metricName"]: x["requestsCount"] for x in stats}
        per_store: dict[str, int] = {}
        for n in nodes2:
            for x in n.storage.metric_names_usage_stats(10_000):
                per_store[x["metricName"]] = \
                    per_store.get(x["metricName"], 0) + x["requestsCount"]
        assert by_name == per_store
        assert by_name.get("top", 0) >= 1
        assert by_name.get("foo.other", 0) >= 2
        assert all(x["lastRequestTimestamp"] > 0 for x in stats)
        cluster.reset_metric_names_stats()
        assert cluster.metric_names_usage_stats() == []
        cluster.close()

    def test_search_metadata_fanout_merge(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        nodes2[0].storage.set_metadata(
            {"m1": {"type": "counter", "help": "h1"}})
        nodes2[1].storage.set_metadata(
            {"m2": {"type": "gauge", "help": "h2"}})
        assert cluster.search_metadata() == {
            "m1": {"type": "counter", "help": "h1"},
            "m2": {"type": "gauge", "help": "h2"}}
        assert cluster.search_metadata(metric="m2") == {
            "m2": {"type": "gauge", "help": "h2"}}
        cluster.close()


# ---------------------------------------------------------------------------
# tests/test_elastic_cluster.py
# ---------------------------------------------------------------------------

@pytest.fixture()
def fast_migration_grace(monkeypatch):
    """No concurrent readers in these tests: a 50 ms source-copy grace
    window (VM_MIGRATE_GRACE_MS) so drains don't sleep 1.5 s."""
    monkeypatch.setenv("VM_MIGRATE_GRACE_MS", "50")


def seed_em(cluster, name="em", n=60, k=3):
    rows = [({"__name__": name, "series": str(i)}, T0 + j * 15_000,
             float(i * 100 + j)) for i in range(n) for j in range(k)]
    cluster.add_rows(rows)
    return rows


def fetch_em(pkg, cluster, name="em", lo=T0, hi=T0 + 60_000):
    return cluster.search_columns([pkg.TagFilter(b"", name.encode())],
                                  lo, hi)


def assert_same(a, b):
    assert a.raw_names == b.raw_names
    assert np.array_equal(a.counts, b.counts)
    assert np.array_equal(a.ts, b.ts)
    assert np.array_equal(a.vals, b.vals)


class TestRingFilteredReads:
    def test_ring_on_equals_ring_off(self, pkg, nodes2, monkeypatch):
        for rf in (1, 2):
            cluster = pkg.ClusterStorage([n.client() for n in nodes2],
                                         replication_factor=rf)
            seed_em(cluster, name=f"rr{rf}")
            on = fetch_em(pkg, cluster, f"rr{rf}")
            monkeypatch.setenv("VM_RING_FILTER", "0")
            off = fetch_em(pkg, cluster, f"rr{rf}")
            monkeypatch.delenv("VM_RING_FILTER")
            assert on.n_series == 60
            assert_same(on, off)
            cluster.close()

    def test_rf2_suppresses_duplicate_replica_rows(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2],
                                     replication_factor=2)
        seed_em(cluster)
        rings = [pkg.ringfilter.get_ring(cluster.node_names(), 2, i,
                                         frozenset()) for i in (0, 1)]
        f = [pkg.TagFilter(b"", b"em")]
        served = sum(len(cluster.nodes[i].search_columns(
            f, T0, T0 + 60_000, ring=rings[i])[0]) for i in (0, 1))
        assert served == 60, f"primary shares must partition: {served}"
        assert sum(len(cluster.nodes[i].search_columns(
            f, T0, T0 + 60_000)[0]) for i in (0, 1)) == 120
        cluster.close()

    def test_down_node_rerouted_complete(self, pkg, nodes2):
        reroutes = pkg.ringfilter.REROUTE_READS
        cluster = pkg.ClusterStorage([n.client() for n in nodes2],
                                     replication_factor=2)
        seed_em(cluster)
        before = fetch_em(pkg, cluster)
        r0 = reroutes.get()
        cluster.nodes[0].mark_down(30.0)
        cluster.reset_partial()
        assert_same(before, fetch_em(pkg, cluster))
        assert not cluster.last_partial
        assert reroutes.get() > r0
        cluster.nodes[0].down_until = 0.0
        cluster.close()

    def test_unmarked_failure_goes_partial_not_silent(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2],
                                     replication_factor=2)
        seed_em(cluster, name="uf")
        orig = cluster.nodes[0].search_columns

        def boom(*a, **k):
            err = pkg.RPCDeadlineError("budget pre-exhausted before I/O")
            err.waited = False
            raise err

        cluster.nodes[0].search_columns = boom
        try:
            cluster.reset_partial()
            cols = fetch_em(pkg, cluster, "uf")
            assert cluster.last_partial
            assert 0 < cols.n_series < 60
            assert cluster.nodes[0].healthy
        finally:
            cluster.nodes[0].search_columns = orig
        cluster.reset_partial()
        assert fetch_em(pkg, cluster, "uf").n_series == 60
        assert not cluster.last_partial
        cluster.close()

    def test_write_reroute_marks_exempt(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        seed_em(cluster, name="wr", n=40)
        nodes2[0].insert_srv.stop()
        nodes2[0].select_srv.stop()
        cluster.nodes[0].insert.close()
        cluster.add_rows([({"__name__": "wr", "series": str(i)},
                           T0 + 90_000, float(i)) for i in range(40)])
        n0 = nodes2[0]
        handlers = pkg.make_storage_handlers(n0.storage)
        n0.insert_srv = serve(pkg.RPCServer(
            "127.0.0.1", 0, pkg.HELLO_INSERT, handlers))
        n0.select_srv = serve(pkg.RPCServer(
            "127.0.0.1", 0, pkg.HELLO_SELECT, handlers))
        revived = pkg.StorageNodeClient("127.0.0.1", n0.insert_srv.port,
                                        n0.select_srv.port,
                                        name=cluster.nodes[0].name)
        cluster._set_nodes([revived, cluster.nodes[1]])
        cols = fetch_em(pkg, cluster, "wr", hi=T0 + 120_000)
        assert cols.n_series == 40
        assert int(cols.counts.sum()) == 40 * 4
        assert len(nodes2[1].storage.ring_exempt_names) > 0
        cluster.close()


class TestLiveResharding:
    def test_export_adopt_roundtrip_direct(self, pkg, tmp_path):
        a = pkg.Storage(str(tmp_path / "a"))
        b = pkg.Storage(str(tmp_path / "b"))
        try:
            a.add_rows([({"__name__": "mg", "series": str(i)},
                         T0 + j * 15_000, float(i + j))
                        for i in range(25) for j in range(3)])
            a.force_flush()
            inv = a.list_file_parts()
            assert inv and all(r["rows"] > 0 for r in inv)
            want = a.search_columns([pkg.TagFilter(b"", b"mg")], T0,
                                    T0 + 60_000)
            for row in inv:
                files, entries, meta = a.export_part(row["partition"],
                                                     row["part"])
                assert entries
                got_rows, _ = b.adopt_part(row["partition"], files,
                                           entries, meta["min_ts"],
                                           meta["max_ts"])
                assert got_rows == row["rows"]
            got = b.search_columns([pkg.TagFilter(b"", b"mg")], T0,
                                   T0 + 60_000)
            assert got.raw_names == want.raw_names
            assert np.array_equal(got.vals, want.vals)
            assert got.metric_names[0].metric_group == b"mg"
            assert b._mid_gen.next_id() > max(int(m) for m in got.metric_ids)
        finally:
            a.close()
            b.close()

    def test_adopt_rejects_torn_transfer(self, pkg, tmp_path):
        a = pkg.Storage(str(tmp_path / "a"))
        b = pkg.Storage(str(tmp_path / "b"))
        try:
            a.add_rows([({"__name__": "tn", "series": str(i)},
                         T0 + j * 15_000, float(i * 7 + j * 3 + 1))
                        for i in range(20) for j in range(5)])
            a.force_flush()
            row = a.list_file_parts()[0]
            files, entries, meta = a.export_part(row["partition"],
                                                 row["part"])
            victim = next(n for n, d in files if n.endswith(".bin") and d)
            files = [(n, (bytes([d[0] ^ 0xFF]) + d[1:] if n == victim
                          else d)) for n, d in files]
            with pytest.raises(pkg.fslib.IntegrityError):
                b.adopt_part(row["partition"], files, entries,
                             meta["min_ts"], meta["max_ts"])
            assert b.list_file_parts() == []
            with pytest.raises(ValueError):
                b.adopt_part("../a_bc", files, entries)
            with pytest.raises(ValueError):
                b.adopt_part("2026_xx", files, entries)
        finally:
            a.close()
            b.close()

    def test_drain_node_byte_exact(self, pkg, nodes3, fast_migration_grace):
        migrated = pkg.cluster_api._PARTS_MIGRATED
        moved = pkg.cluster_api._REBALANCE_BYTES
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        seed_em(cluster, n=90)
        for n in nodes3:
            n.storage.force_flush()
        want = fetch_em(pkg, cluster)
        assert want.n_series == 90
        m0, b0 = migrated.get(), moved.get()
        stat = cluster.drain_node(cluster.node_names()[0])
        assert stat["removed"] and stat["parts"] >= 1
        assert migrated.get() > m0 and moved.get() > b0
        assert len(cluster.nodes) == 2
        assert_same(want, fetch_em(pkg, cluster))
        assert nodes3[0].storage.list_file_parts() == []
        cluster.close()

    def test_drain_includes_unflushed_acked_writes(self, pkg, nodes3,
                                                   fast_migration_grace):
        cluster = pkg.ClusterStorage([n.client() for n in nodes3])
        seed_em(cluster, name="uf", n=50)
        want = fetch_em(pkg, cluster, "uf")
        cluster.drain_node(cluster.node_names()[2])
        assert_same(want, fetch_em(pkg, cluster, "uf"))
        cluster.close()

    def test_join_and_rebalance(self, pkg, nodes2, tmp_path,
                                fast_migration_grace):
        joiner = StorageNode(pkg, tmp_path / "joiner")
        try:
            cluster = pkg.ClusterStorage([n.client() for n in nodes2])
            for b in range(3):
                cluster.add_rows([({"__name__": "jn", "series": str(i)},
                                   T0 + (3 * b + j) * 15_000, float(i + b))
                                  for i in range(40) for j in range(3)])
                for n in nodes2:
                    n.storage.force_flush()
            want = fetch_em(pkg, cluster, "jn", hi=T0 + 10 * 15_000)
            cluster.add_node(joiner.spec)
            assert len(cluster.nodes) == 3
            cluster.add_rows([({"__name__": "jn2", "series": str(i)}, T0,
                               float(i)) for i in range(60)])
            assert joiner.storage.rows_added > 0
            stat = cluster.rebalance_to(joiner.client().name)
            assert stat["parts"] >= 1, stat
            assert joiner.storage.list_file_parts() != []
            assert_same(want, fetch_em(pkg, cluster, "jn",
                                       hi=T0 + 10 * 15_000))
            cluster.close()
        finally:
            joiner.stop()

    def test_drain_rejects_when_no_targets(self, pkg, nodes2,
                                           fast_migration_grace):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        seed_em(cluster, name="nt", n=10)
        cluster.drain_node(cluster.node_names()[0])
        last = cluster.node_names()[0]
        with pytest.raises((pkg.RPCError, ValueError)):
            cluster.drain_node(last)
        assert last not in cluster._draining
        cluster.add_rows([({"__name__": "nt2", "series": "0"}, T0, 1.0)])
        assert fetch_em(pkg, cluster, "nt2").n_series == 1
        cluster.close()


# ---------------------------------------------------------------------------
# tests/test_tenant_gate.py: deadline-propagating RPC, the killed node
# ---------------------------------------------------------------------------

def tg_seed(cluster, n_series=24):
    cluster.add_rows([({"__name__": "tg", "idx": str(i)}, T0 + j * 15_000,
                       float(i * 10 + j))
                      for i in range(n_series) for j in range(4)])


def tg(pkg):
    return pkg.filters_from_dict({"__name__": "tg"})


class StallNode:
    """A storage node whose select server takes the handshake and then
    never answers (the SIGSTOP shape, in-process)."""

    def __init__(self, pkg, real):
        def h_stall(r):
            time.sleep(300)
        self.pkg = pkg
        self.select_srv = serve(pkg.RPCServer(
            "127.0.0.1", 0, pkg.HELLO_SELECT,
            {m: h_stall for m in ("searchColumns_v1", "search_v1")}))
        self.insert_port = real.insert_srv.port

    def client(self, timeout=10.0):
        return self.pkg.StorageNodeClient("127.0.0.1", self.insert_port,
                                          self.select_srv.port,
                                          timeout=timeout)


class TestDeadlineRPC:
    def test_stalled_node_costs_one_deadline_not_timeout(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        tg_seed(cluster)
        cluster.reset_partial()
        full = cluster.search_columns(tg(pkg), T0, T0 + 60_000)
        assert full.n_series == 24 and not cluster.last_partial
        stalled = StallNode(pkg, nodes2[1])
        try:
            cluster2 = pkg.ClusterStorage([nodes2[0].client(),
                                           stalled.client()])
            cluster2.reset_partial()
            t0 = time.perf_counter()
            cols = cluster2.search_columns(tg(pkg), T0, T0 + 60_000,
                                           deadline=time.monotonic() + 0.6)
            assert time.perf_counter() - t0 < 5.0
            assert cluster2.last_partial
            assert 0 < cols.n_series < 24
        finally:
            stalled.select_srv.stop()

    def test_killed_node_partial_with_surviving_exact_rows(self, pkg,
                                                           nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        tg_seed(cluster)
        cluster.reset_partial()
        assert cluster.search_columns(tg(pkg), T0,
                                      T0 + 60_000).n_series == 24
        survivor = nodes2[0].storage.search_columns(tg(pkg), T0,
                                                    T0 + 60_000)
        nodes2[1].stop()
        cluster.nodes[1].close()
        cluster.reset_partial()
        cols = cluster.search_columns(tg(pkg), T0, T0 + 60_000)
        assert cluster.last_partial is True
        assert cols.raw_names == survivor.raw_names
        np.testing.assert_array_equal(cols.counts, survivor.counts)
        sel = np.arange(cols.ts.shape[1])[None, :] < cols.counts[:, None]
        sel2 = np.arange(survivor.ts.shape[1])[None, :] < \
            survivor.counts[:, None]
        np.testing.assert_array_equal(cols.ts[sel], survivor.ts[sel2])
        np.testing.assert_array_equal(cols.vals[sel], survivor.vals[sel2])

    def test_dripping_stream_costs_one_deadline(self, pkg):
        def h_drip(r):
            for i in range(50):
                time.sleep(0.12)
                yield pkg.Writer().u64(i)
        srv = serve(pkg.RPCServer("127.0.0.1", 0, pkg.HELLO_SELECT,
                                  {"drip_v1": h_drip}))
        try:
            c = pkg.RPCClient("127.0.0.1", srv.port, pkg.HELLO_SELECT,
                              timeout=10.0)
            t0 = time.perf_counter()
            with pytest.raises(pkg.RPCDeadlineError):
                c.call_stream("drip_v1", pkg.Writer(),
                              deadline=time.monotonic() + 0.4)
            assert time.perf_counter() - t0 < 2.0
        finally:
            srv.stop()

    def test_connect_respects_deadline_on_dead_port(self, pkg):
        import socket
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(0)
        port = lst.getsockname()[1]
        burners = []
        for _ in range(64):
            s = socket.socket()
            s.setblocking(False)
            try:
                s.connect_ex(("127.0.0.1", port))
            except OSError:
                pass
            burners.append(s)
        try:
            c = pkg.RPCClient("127.0.0.1", port, pkg.HELLO_SELECT,
                              timeout=30.0)
            t0 = time.perf_counter()
            with pytest.raises((pkg.RPCError, OSError)):
                c.call("x_v1", pkg.Writer(), deadline=time.monotonic() + 0.4)
            assert time.perf_counter() - t0 < 5.0
        finally:
            for s in burners:
                s.close()
            lst.close()

    def test_select_connections_do_not_serialize(self, pkg, nodes2):
        client = nodes2[0].client()
        tg_seed(pkg.ClusterStorage([n.client() for n in nodes2]))
        pkg.faultinject.configure("rpc:searchColumns_v1=delay:400")
        done = []

        def one():
            t0 = time.perf_counter()
            client.search_columns(tg(pkg), T0, T0 + 60_000)
            done.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=one) for _ in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        wall = time.perf_counter() - t0
        pkg.faultinject.configure("")
        assert len(done) == 2
        assert wall < 0.7, f"concurrent selects serialized: {wall:.2f}s"

    def test_shed_load_crosses_rpc_boundary_as_itself(self, pkg, nodes2,
                                                      monkeypatch):
        monkeypatch.setenv("VM_TENANT_QUOTAS", "9:0=1:50")
        tg_seed(pkg.ClusterStorage([n.client() for n in nodes2]))
        cluster = pkg.ClusterStorage([nodes2[0].client()])
        pkg.faultinject.configure("storage:search:9:0=delay:600")
        holder = threading.Thread(
            target=lambda: nodes2[0].storage.search_columns(
                tg(pkg), T0, T0 + 60_000, tenant=(9, 0)))
        holder.start()
        time.sleep(0.2)
        errs = pkg.metricslib.REGISTRY.counter(
            'vm_rpc_server_errors_total{method="searchColumns_v1"}')
        errs_before = errs.get()
        with pytest.raises(pkg.SearchLimitError):
            cluster.search_columns(tg(pkg), T0, T0 + 60_000, tenant=(9, 0))
        holder.join(timeout=10)
        pkg.faultinject.configure("")
        assert errs.get() == errs_before
        assert all(n.healthy for n in cluster.nodes)
        cluster.reset_partial()
        cols = cluster.search_columns(tg(pkg), T0, T0 + 60_000)
        assert cols.n_series > 0 and not cluster.last_partial

    def test_exhausted_deadline_does_not_mark_nodes_down(self, pkg, nodes2):
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        tg_seed(cluster)
        with pytest.raises(pkg.RPCError):
            cluster.search_columns(tg(pkg), T0, T0 + 60_000,
                                   deadline=time.monotonic() - 1.0)
        assert all(n.healthy for n in cluster.nodes)
        cluster.reset_partial()
        cols = cluster.search_columns(tg(pkg), T0, T0 + 60_000)
        assert cols.n_series == 24 and not cluster.last_partial

    def test_backoff_retry_recovers_from_resets(self, pkg, nodes2,
                                                monkeypatch):
        monkeypatch.setenv("VM_RPC_RETRIES", "4")
        monkeypatch.setenv("VM_RPC_BACKOFF_MS", "5")
        cluster = pkg.ClusterStorage([n.client() for n in nodes2])
        tg_seed(cluster)
        retries = pkg.metricslib.REGISTRY.counter("vm_rpc_retries_total")
        before = retries.get()
        pkg.faultinject.configure("rpc:searchColumns_v1=reset::0.3")
        ok = 0
        for _ in range(10):
            cluster.reset_partial()
            try:
                cols = cluster.search_columns(tg(pkg), T0, T0 + 60_000)
                ok += cols.n_series == 24 and not cluster.last_partial
            except pkg.RPCError:
                pass
        pkg.faultinject.configure("")
        assert ok >= 7, f"only {ok}/10 full results under 30% resets"
        assert retries.get() > before


def test_refan_ships_the_lost_node_down_when_its_mark_expired(tmp_path,
                                                             monkeypatch):
    """A node that dies under a fan-out longer than its 2 s down-mark
    (the full width's does, on the card's host): the re-fan must ship it
    as down although the mark has expired, so the survivors serve its
    shares and RF 2 keeps the answer whole.  Here the mark expires at
    once.  The reference re-reads the node's health, finds it healthy,
    re-fans with its shares suppressed and answers partial."""
    port = _package("port")
    monkeypatch.setattr(port.StorageNodeClient, "mark_down",
                        lambda self, seconds=2.0: setattr(
                            self, "down_until", time.monotonic()))
    nodes = make_nodes(port, tmp_path)
    try:
        cluster = port.ClusterStorage([n.client() for n in nodes],
                                      replication_factor=2)
        seed_em(cluster, n=60)
        want = fetch_em(port, cluster)
        nodes[0].stop()
        cluster.nodes[0].close()
        cluster.reset_partial()
        got = fetch_em(port, cluster)
        assert not cluster.last_partial
        assert_same(want, got)
        cluster.close()
    finally:
        stop_all(nodes)


# ---------------------------------------------------------------------------
# the wire: hello bytes, frames, placement
# ---------------------------------------------------------------------------

def test_hello_bytes_and_markers_are_the_reference_s():
    ref, port = _package("ref").rpc, _package("port").rpc
    for name in ("HELLO_INSERT", "HELLO_SELECT", "HELLO_OK", "MAX_FRAME",
                 "_SHED_PREFIX", "_DEADLINE_PREFIX", "_RATELIMIT_PREFIX",
                 "_UNAVAIL_PREFIX", "_PARTIAL_PREFIX"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.HELLO_INSERT == b"vmtpu-insert.v2\n"
    assert port.HELLO_SELECT == b"vmtpu-select.v2\n"
    assert port.HELLO_OK == b"ok:zstd\n"


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_frames_cross_between_packages(codec, monkeypatch):
    """A frame each package writes is read by the other, the port's also
    when it falls back to zlib (a host with neither the zstandard package
    nor libzstd); the field encoding is byte for byte the same."""
    import io
    ref, port = _package("ref"), _package("port")
    if codec == "zlib":
        monkeypatch.setattr(port.compress, "zstandard", None)
        monkeypatch.setattr(port.compress, "_native_zstd", False)
        assert port.rpc.frame_codec() == "zlib"
    else:
        assert port.rpc.frame_codec() in ("zstd", "zstd-native")
    arr = np.arange(40, dtype=np.float64) / 7

    def body(p):
        return (p.Writer().str_("searchColumns_v1").u64(2**40 + 3)
                .i64(-T0).f64(-0.0).bytes_(b"\x00\xff" * 9).array(arr)
                .payload())

    assert body(port) == body(ref)
    # a host without any zstd binding writes zlib and cannot read zstd
    # frames (ops/compress): the reference's frames reach it only with zstd
    pairs = [(port, ref)] + ([(ref, port)] if codec == "zstd" else [])
    for src, dst in pairs:
        f = io.BytesIO()
        src.rpc.write_frame(f, body(src))
        f.seek(0)
        r = dst.rpc.Reader(dst.rpc.read_frame(f))
        assert (r.str_(), r.u64(), r.i64()) == (
            "searchColumns_v1", 2**40 + 3, -T0)
        assert np.signbit(r.f64()) and r.bytes_() == b"\x00\xff" * 9
        np.testing.assert_array_equal(r.array(), arr)


def test_placement_is_the_reference_s():
    """Both packages place every series on the same nodes (the port
    hashes with native.xxh64, the reference with the xxhash package)."""
    names = [f"127.0.0.1:{8400 + i}" for i in range(5)]
    ref = _package("ref").ConsistentHash(names)
    port = _package("port").ConsistentHash(names)
    rng = np.random.default_rng(3)
    for k in range(2000):
        key = rng.bytes(int(rng.integers(1, 60)))
        for rf in (1, 2, 3):
            ex = {int(rng.integers(0, 5))} if k % 3 == 0 else None
            assert port.nodes_for_key(key, rf, ex) == \
                ref.nodes_for_key(key, rf, ex)


# ---------------------------------------------------------------------------
# mixed clusters: one package's router over the other's nodes
# ---------------------------------------------------------------------------

MIX_Q = "sum by (job)(rate(mx[1m]))"


@pytest.mark.parametrize("router,nodes", [
    ("ref", ("port", "port", "port")),
    ("port", ("ref", "ref", "ref")),
    ("port", ("ref", "port", "ref")),
    ("ref", ("port", "ref", "port")),
])
def test_mixed_cluster_answers_as_a_single_node(router, nodes, tmp_path):
    """The router's package writes both row paths at RF 2 and reads the
    columns and a query back over the other package's nodes (or a mix):
    the columns equal a single node's exactly, the query at rtol 1e-12;
    each series sits on exactly two nodes; a killed node changes
    nothing."""
    rp = _package(router)
    ns = [StorageNode(_package(p), tmp_path / f"n{i}")
          for i, p in enumerate(nodes)]
    single = rp.Storage(str(tmp_path / "single"))
    try:
        cluster = rp.ClusterStorage([n.client(rp) for n in ns],
                                    replication_factor=2)
        batch = columnar_batch(rp, n_series=30, name="mx")
        rows = [({"__name__": "mx", "idx": str(i), "job": f"j{i % 4}"},
                 T0 + (12 + j) * 15_000, float(3000 + i * 7 + j))
                for i in range(30) for j in range(4)]
        assert cluster.add_rows_columnar(batch) == 30 * 12
        assert cluster.add_rows(rows) == len(rows)
        single.add_rows_columnar(columnar_batch(rp, n_series=30, name="mx"))
        single.add_rows(rows)
        assert sum(n.storage.series_count() for n in ns) == 60
        f = rp.filters_from_dict({"__name__": "mx"})
        lo, hi = T0 - 10**6, T0 + 10**9
        assert_columns_equal(cluster.search_columns(f, lo, hi),
                             single.search_columns(f, lo, hi))
        kw = dict(start=T0 + 60_000, end=T0 + 225_000, step=15_000,
                  tpu=None, disable_cache=True)
        want = {ts.metric_name.marshal(): ts.values for ts in rp.exec_query(
            rp.EvalConfig(storage=single, **kw), MIX_Q)}
        assert len(want) == 4
        for kill in (False, True):
            if kill:
                # sever the router's kept-alive connections too, as the
                # process's death would (an in-process server stop leaves
                # them served by a closed store)
                ns[1].stop()
                cluster.nodes[1].close()
            cluster.reset_partial()
            got = {ts.metric_name.marshal(): ts.values
                   for ts in rp.exec_query(
                       rp.EvalConfig(storage=cluster, **kw), MIX_Q)}
            assert not cluster.last_partial
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           atol=0)
        cluster.close()
    finally:
        stop_all(ns)
        single.close()


# ---------------------------------------------------------------------------
# the device path: vmselect with the CUDA engine on the kernels' plain
# versions, against the reference's TPUEngine and the host
# ---------------------------------------------------------------------------

DEV_Q = "sum by (instance)(rate(dm[5m]))"


def dev_rows(n_series=48, n=60):
    rng = np.random.default_rng(11)
    ts = T0 + np.arange(n, dtype=np.int64)[None, :] * 15_000 + \
        rng.integers(-2000, 2001, (n_series, n))
    vals = np.cumsum(rng.integers(0, 50, (n_series, n)), axis=1)
    return [({"__name__": "dm", "instance": f"h{i % 6}", "id": str(i)},
             int(ts[i, j]), float(vals[i, j]))
            for i in range(n_series) for j in range(n)]


def test_vmselect_device_path_against_tpu_engine_and_host(tmp_path,
                                                          monkeypatch):
    """vmselect's sum by (instance)(rate) over a 3-node RF-2 cluster: the
    port's PrometheusAPI with CUDAEngine(device="cpu", min_series=4)
    routes it to K1 + K2 (read from the engine's dispatches), and its
    values equal the reference's PrometheusAPI with TPUEngine over its own
    cluster and the port's host evaluator at rtol 1e-12; a refresh one
    step on, after one more scrape, answers again on the card (K1 + K2
    over the fetched tail) at the same tolerance."""
    from tests.apptest_helpers import Client
    from victoriametrics_tpu.query.tpu_engine import TPUEngine
    from victoriametrics_tpu_torch.query import cuda_engine as ce
    dispatched = collections.Counter()
    real = ce.timed_kernel_call

    def counting(kernel, fn, *a, **kw):
        dispatched[kernel] += 1
        return real(kernel, fn, *a, **kw)

    monkeypatch.setattr(ce, "timed_kernel_call", counting)
    sides = {}
    rows = dev_rows()
    try:
        for name in ("ref", "port"):
            p = _package(name)
            ns = make_nodes(p, tmp_path, tag=name)
            cluster = p.ClusterStorage([n.client() for n in ns],
                                       replication_factor=2)
            cluster.add_rows(rows)
            srv = p.HTTPServer("127.0.0.1", 0)
            api = p.PrometheusAPI(cluster)
            api.tpu = (ce.CUDAEngine(device="cpu", min_series=4)
                       if name == "port" else
                       TPUEngine(min_series=4, value_dtype=np.float64))
            api.register(srv, mode="select")
            srv.start()
            sides[name] = (ns, cluster, srv, api, Client(srv.port))
        start, end, step = T0 + 300_000, T0 + 59 * 15_000, 15_000
        for refresh in (False, True):
            if refresh:
                extra = [({"__name__": "dm", "instance": f"h{i % 6}",
                           "id": str(i)}, end + 7_500, 1e6 + i)
                         for i in range(48)]
                for _, cluster, _, _, _ in sides.values():
                    cluster.add_rows(extra)
                end += step
            dispatched.clear()
            got = {}
            for name, (_, cluster, _, api, c) in sides.items():
                code, body = c.get("/api/v1/query_range", query=DEV_Q,
                                   start=start / 1e3, end=end / 1e3,
                                   step=step / 1e3)
                assert code == 200, body
                res = json.loads(body)
                assert res["isPartial"] is False
                got[name] = {e["metric"]["instance"]:
                             [(float(t), float(v)) for t, v in e["values"]]
                             for e in res["data"]["result"]}
            assert dispatched["decode_tiles"] == 1 and \
                dispatched["rollup_aggregate_tile"] == 1, dispatched
            assert not dispatched["append_tile"]
            p = _package("port")
            ec = p.EvalConfig(start=start, end=end, step=step,
                              storage=sides["port"][1], tpu=None,
                              disable_cache=True)
            host = {ts.metric_name.get_label(b"instance").decode():
                    ts.values for ts in p.exec_query(ec, DEV_Q)}
            assert got["port"].keys() == got["ref"].keys() == host.keys()
            assert len(host) == 6
            for inst, pts in got["port"].items():
                t_p, v_p = zip(*pts)
                t_r, v_r = zip(*got["ref"][inst])
                assert t_p == t_r
                np.testing.assert_allclose(v_p, v_r, rtol=1e-12, atol=0)
                h = host[inst][~np.isnan(host[inst])]
                np.testing.assert_allclose(v_p, h, rtol=1e-12, atol=0)
    finally:
        for ns, cluster, srv, _, _ in sides.values():
            srv.stop()
            cluster.close()
            stop_all(ns)
