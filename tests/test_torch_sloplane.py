"""The self-monitoring plane (``query/sloplane``, ``utils/selfscrape``,
``utils/pushmetrics``) held to the reference's tests: every case of
``tests/test_sloplane.py`` and ``tests/test_selfscrape.py``, written once
and run against both packages (``pkg``).  The reference's two
process-level cases (a vmsingle with ``-selfScrapeInterval`` serving its
own history, and its health/SLO/incident routes) run here on the
package's vmsingle built in-process; the port's as a process is in
``tests/test_torch_cluster_apps.py``.  Beside them: ``MetricsPusher``
posting ``/metrics`` to a local receiver with its extra labels."""

import json
import threading
import time
import types

import pytest

T0_MS = int(time.time() * 1e3)


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu.apps import vmsingle
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.parallel import cluster_api, rpc
        from victoriametrics_tpu.query import sloplane
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import \
            filters_from_dict
        from victoriametrics_tpu.utils import metrics as metricslib
        from victoriametrics_tpu.utils import pushmetrics, selfscrape
    else:
        from victoriametrics_tpu_torch.apps import vmsingle
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.parallel import cluster_api, rpc
        from victoriametrics_tpu_torch.query import sloplane
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import \
            filters_from_dict
        from victoriametrics_tpu_torch.utils import metrics as metricslib
        from victoriametrics_tpu_torch.utils import pushmetrics, selfscrape
    return types.SimpleNamespace(
        name=name, vmsingle=vmsingle, PrometheusAPI=PrometheusAPI,
        cluster_api=cluster_api, rpc=rpc, sloplane=sloplane,
        Storage=Storage, filters_from_dict=filters_from_dict,
        metricslib=metricslib, pushmetrics=pushmetrics,
        selfscrape=selfscrape)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(autouse=True)
def _stop_profilers():
    """An incident's snapshot and vmsingle's build start the package's
    sampling profiler: stop both packages' after each case, so no sampler
    outlives it into another test of the worker (the reference's
    ``test_cluster_cost.py`` reads its profiler's samples after a
    reset)."""
    yield
    from victoriametrics_tpu.utils import profiler as ref_profiler
    from victoriametrics_tpu_torch.utils import profiler as port_profiler
    ref_profiler.PROFILER.stop()
    port_profiler.PROFILER.stop()


# ---------------------------------------------------------------------------
# tests/test_sloplane.py
# ---------------------------------------------------------------------------

class TestParseWindows:
    def test_default(self, pkg):
        assert pkg.sloplane.parse_windows(None) == [("5m", "1h", 14.4),
                                                    ("30m", "6h", 6.0)]

    def test_custom(self, pkg):
        assert pkg.sloplane.parse_windows("5s:15s:5") == [("5s", "15s", 5.0)]

    def test_garbage_falls_back(self, pkg):
        pw, default = pkg.sloplane.parse_windows, \
            pkg.sloplane.DEFAULT_WINDOWS
        assert pw("nope,also:bad") == pw(default)
        assert pw("a:b:notafloat") == pw(default)


class TestFolds:
    def test_ratio_fold(self, pkg):
        vals = {"bad": [{"value": 3.0}, {"value": 2.0}],
                "total": [{"value": 100.0}]}
        assert pkg.sloplane.ratio_fold(vals) == (5.0, 100.0)
        assert pkg.sloplane.ratio_fold({}) == (0.0, 0.0)

    def test_latency_fold_buckets(self, pkg):
        fold = pkg.sloplane.latency_fold(1.0)
        vals = {"total": [{"value": 100.0}],
                "buckets": [
                    {"metric": {"vmrange": "8.799e-01...1.000e+00"},
                     "value": 90.0},
                    {"metric": {"vmrange": "1.000e+00...1.136e+00"},
                     "value": 10.0},
                    {"metric": {"vmrange": "garbage"}, "value": 5.0}]}
        assert fold(vals) == (10.0, 100.0)

    def test_latency_fold_clamps_drift(self, pkg):
        fold = pkg.sloplane.latency_fold(1.0)
        vals = {"total": [{"value": 10.0}],
                "buckets": [{"metric": {"vmrange": "0...1.000e-09"},
                             "value": 12.0}]}
        assert fold(vals) == (0.0, 10.0)


@pytest.fixture()
def api(pkg, tmp_path):
    s = pkg.Storage(str(tmp_path / "data"))
    try:
        yield pkg.PrometheusAPI(s)
    finally:
        s.close()


def _counter_rows(name: str, points):
    return [({"__name__": name, "job": "t"}, ts, v) for ts, v in points]


def test_flat_in_slo_count_counter_asserted(pkg, api):
    sp = pkg.sloplane
    windows = sp.parse_windows("5m:1h:14.4,30m:6h:6")
    e1 = sp.SLOEngine(api, windows=windows, interval_s=0.01, period="24h")
    before = sp._EVALS.get()
    assert e1.maybe_eval(force=True)
    n1 = sp._EVALS.get() - before
    assert n1 == e1.exprs_last_round > 0
    specs = sp.default_specs()
    specs.append(sp.SLOSpec("dup-availability", 99.5,
                            dict(specs[0].exprs)))
    e2 = sp.SLOEngine(api, specs=specs, windows=windows, interval_s=0.01,
                      period="24h")
    before = sp._EVALS.get()
    assert e2.maybe_eval(force=True)
    assert sp._EVALS.get() - before == n1
    assert {s["slo"] for s in e2.status()["slos"]} == {
        x.name for x in specs}


def test_interval_gating(pkg, api):
    eng = pkg.sloplane.SLOEngine(
        api, specs=[], windows=pkg.sloplane.parse_windows("5s:15s:5"),
        interval_s=3600, period="1m")
    assert eng.maybe_eval(now_ms=T0_MS) is True
    assert eng.maybe_eval(now_ms=T0_MS + 1000) is False
    assert eng.maybe_eval(now_ms=T0_MS + 1000, force=True) is True
    assert eng.maybe_eval(now_ms=T0_MS + 3601 * 1000) is True


def test_burn_incident_lifecycle_and_diagnosis(pkg, api):
    sp = pkg.sloplane
    s = api.storage
    spec = sp.SLOSpec(
        "unit-avail", 99.0,
        {"bad": "sum(increase(unit_bad_total[{w}]))",
         "total": "sum(increase(unit_total_total[{w}]))"},
        description="unit test objective")
    s.add_rows(_counter_rows("unit_bad_total",
                             [(T0_MS - 10_000 + i * 2_000, 3.0 * i)
                              for i in range(6)]) +
               _counter_rows("unit_total_total",
                             [(T0_MS - 10_000 + i * 2_000, 10.0 * i)
                              for i in range(6)]))
    s.force_flush()
    eng = sp.SLOEngine(api, specs=[spec],
                       windows=sp.parse_windows("5s:10s:2"),
                       interval_s=0.01, period="1m")
    eng.maybe_eval(now_ms=T0_MS, force=True)
    st = eng.status()["slos"][0]
    assert st["firing"] and st["severity"] == "page"
    assert 10 < st["burn"]["10s"] < 50, st["burn"]
    assert st["openIncidentId"] is not None
    assert st["budgetRemaining"] == 0.0
    rec = eng.incidents.get(st["openIncidentId"])
    assert rec["slo"] == "unit-avail" and rec["resolvedMs"] is None
    assert rec["flightCaptureId"] is not None
    assert rec["profile"] is not None and "stacks" in rec["profile"]
    assert rec["health"]["verdict"] == "critical"
    assert any(r["code"] == "slo_burn" and r["slo"] == "unit-avail"
               for r in rec["health"]["reasons"])
    g = pkg.metricslib.REGISTRY._metrics[pkg.metricslib.format_name(
        "vm_slo_burn_rate", {"slo": "unit-avail", "window": "10s"})]
    assert g.get() == st["burn"]["10s"]
    eng.maybe_eval(now_ms=T0_MS + 600_000, force=True)
    st = eng.status()["slos"][0]
    assert not st["firing"] and st["openIncidentId"] is None
    assert st["budgetRemaining"] == 1.0
    rec = eng.incidents.get(rec["id"])
    assert rec["resolvedMs"] is not None
    listed = eng.incidents.list()
    assert listed[0]["id"] == rec["id"]
    assert listed[0]["resolvedMs"] == rec["resolvedMs"]
    assert listed[0]["hasProfile"] is True


def test_total_on_dead_shard_still_burns(pkg, api):
    sp = pkg.sloplane
    s = api.storage
    s.add_rows(_counter_rows("orphan_bad_total",
                             [(T0_MS - 8_000 + i * 2_000, 2.0 * i)
                              for i in range(5)]))
    s.force_flush()
    spec = sp.SLOSpec(
        "orphan", 99.0,
        {"bad": "sum(increase(orphan_bad_total[{w}]))",
         "total": "sum(increase(orphan_total_total[{w}]))"})
    eng = sp.SLOEngine(api, specs=[spec],
                       windows=sp.parse_windows("5s:10s:2"),
                       interval_s=0.01, period="1m")
    eng.maybe_eval(now_ms=T0_MS, force=True)
    st = eng.status()["slos"][0]
    assert st["firing"], st
    assert st["burn"]["10s"] == pytest.approx(1.0 / spec.budget)


def test_incident_ring_bounded(pkg):
    ring = pkg.sloplane.IncidentRing(2)
    for i in range(3):
        ring.open({"slo": f"s{i}", "startedMs": i, "resolvedMs": None})
    assert [r["slo"] for r in ring.list()] == ["s2", "s1"]
    assert ring.get(1) is None
    assert ring.get(3)["slo"] == "s2"
    assert ring.resolve("s0", 9) is None


def test_local_health_reasons(pkg):
    class Quarantined:
        def quarantine_report(self):
            return [{"part": "x"}]
    h = pkg.sloplane.local_health(storage=Quarantined(), role="vmstorage")
    assert h["verdict"] == "degraded"
    assert [r["code"] for r in h["reasons"]] == ["quarantined_parts"]
    assert h["stats"]["quarantinedParts"] == 1
    assert h["role"] == "vmstorage" and h["uptimeSeconds"] >= 0

    class ReadOnly:
        readonly = True
    h = pkg.sloplane.local_health(storage=ReadOnly())
    assert any(r["code"] == "readonly" for r in h["reasons"])
    h = pkg.sloplane.local_health()
    assert h["verdict"] == "ok" and h["reasons"] == []


def rpc_nodes(pkg, tmp_path, n=2, drop=None):
    """n Storages behind both RPC planes: (storages, servers, clients);
    node `drop` answers without health_v1 (an older binary)."""
    ca, rpc = pkg.cluster_api, pkg.rpc
    storages = [pkg.Storage(str(tmp_path / f"n{i}")) for i in range(n)]
    servers, clients = [], []
    for i, st in enumerate(storages):
        h = ca.make_storage_handlers(st)
        if i == drop:
            del h["health_v1"]
        ins = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_INSERT, h)
        sel = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_SELECT, h)
        ins.start()
        sel.start()
        servers += [ins, sel]
        clients.append(ca.StorageNodeClient("127.0.0.1", ins.port, sel.port))
    return storages, servers, clients


def stop_rpc_nodes(storages, servers):
    ths = [threading.Thread(target=s.stop) for s in servers]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for st in storages:
        st.close()


def test_cluster_health_tolerates_old_nodes(pkg, tmp_path):
    storages, servers, clients = rpc_nodes(pkg, tmp_path, drop=1)
    try:
        cluster = pkg.cluster_api.ClusterStorage(clients)
        assert clients[0].health()["verdict"] in ("ok", "degraded",
                                                  "critical")
        assert clients[0].health()["role"] == "vmstorage"
        assert clients[1].health() is None
        by_node = {r["node"]: r for r in cluster.health_report()}
        assert by_node[clients[0].name]["verdict"] in (
            "ok", "degraded", "critical")
        assert by_node[clients[1].name]["verdict"] == "unknown"
        h = pkg.sloplane.cluster_health(cluster, role="vmselect")
        assert h["verdict"] == "ok", h["reasons"]
        assert {n["name"] for n in h["nodes"]} == {c.name for c in clients}
        assert h["ring"]["rerouteActive"] is False
        assert isinstance(h["ring"]["filterActive"], bool)
        cluster.close()
    finally:
        stop_rpc_nodes(storages, servers)


# ---------------------------------------------------------------------------
# tests/test_selfscrape.py
# ---------------------------------------------------------------------------

class TestParseInterval:
    def test_off_spellings(self, pkg):
        for raw in (None, "", "0", "0s", "false", "no"):
            assert pkg.selfscrape.parse_interval(raw) == 0.0

    def test_bare_one_means_default(self, pkg):
        assert pkg.selfscrape.parse_interval("1") == \
            pkg.selfscrape.DEFAULT_INTERVAL_S

    def test_durations_and_seconds(self, pkg):
        pi = pkg.selfscrape.parse_interval
        assert (pi("15s"), pi("500ms"), pi("2.5"), pi("1m")) == \
            (15.0, 0.5, 2.5, 60.0)

    def test_garbage_disables(self, pkg):
        assert pkg.selfscrape.parse_interval("often") == 0.0

    def test_env_wins_over_flag(self, pkg, monkeypatch):
        monkeypatch.setenv("VM_SELF_SCRAPE_INTERVAL", "3s")
        assert pkg.selfscrape.configured_interval("30s") == 3.0
        monkeypatch.delenv("VM_SELF_SCRAPE_INTERVAL")
        assert pkg.selfscrape.configured_interval("30s") == 30.0


class TestCollectRows:
    def test_rows_are_labeled_ingest_shape(self, pkg):
        rows = pkg.selfscrape.SelfScraper(
            lambda rows, tenant: None, job="j",
            instance="i").collect_rows(ts_ms=1234)
        assert rows
        names = set()
        for labels, ts, val in rows:
            assert ts == 1234
            assert labels["job"] == "j" and labels["instance"] == "i"
            assert labels["__name__"]
            assert val == val
            names.add(labels["__name__"])
        assert "vm_app_uptime_seconds" in names
        assert any(n.startswith("process_") for n in names)

    def test_extra_metrics_are_included(self, pkg):
        s = pkg.selfscrape.SelfScraper(
            lambda rows, tenant: None,
            extra=lambda: {"vm_extra_metric": 7.0})
        vals = {lb["__name__"]: v for lb, _, v in s.collect_rows(ts_ms=1)}
        assert vals.get("vm_extra_metric") == 7.0

    def test_sink_failure_counts_not_raises(self, pkg):
        def sink(rows, tenant):
            raise OSError("down")
        s = pkg.selfscrape.SelfScraper(sink)
        before = pkg.selfscrape._ERRORS.get()
        assert s.scrape_once() == 0
        assert pkg.selfscrape._ERRORS.get() == before + 1

    def test_persistent_handshake_failure_disables_sink(self, pkg):
        calls = []

        def sink(rows, tenant):
            calls.append(1)
            raise ConnectionError("handshake failed: b'bad hello'")
        s = pkg.selfscrape.SelfScraper(sink)
        for _ in range(5):
            s.scrape_once()
        assert s._sink_disabled
        assert len(calls) == 3

    def test_transient_failures_keep_retrying(self, pkg):
        flaky = {"n": 0}

        def sink(rows, tenant):
            flaky["n"] += 1
            if flaky["n"] < 5:
                raise OSError("connection refused")
        s = pkg.selfscrape.SelfScraper(sink)
        for _ in range(6):
            s.scrape_once()
        assert not s._sink_disabled
        assert s._sink_fails == 0
        assert flaky["n"] == 6


def test_scrape_into_local_storage_queryable(pkg, tmp_path):
    s = pkg.Storage(str(tmp_path / "data"))
    try:
        n = pkg.selfscrape.SelfScraper(
            s.add_rows, job="victoria-metrics",
            instance="test:1").scrape_once()
        assert n > 50
        s.force_flush()
        now_ms = int(time.time() * 1e3)
        res = s.search_series(pkg.filters_from_dict(
            {"__name__": "vm_app_uptime_seconds"}), now_ms - 60_000,
            now_ms + 60_000)
        assert res
        mn = res[0].metric_name
        assert mn.get_label(b"job") == b"victoria-metrics"
        assert mn.get_label(b"instance") == b"test:1"
    finally:
        s.close()


def test_cluster_sink_shards_across_nodes(pkg, tmp_path):
    storages, servers, clients = rpc_nodes(pkg, tmp_path)
    try:
        cluster = pkg.cluster_api.ClusterStorage(clients)
        n = pkg.selfscrape.SelfScraper(cluster.add_rows,
                                       instance="self").scrape_once()
        assert n > 50
        assert cluster.rows_sent == n
        for st in storages:
            st.force_flush()
        now_ms = int(time.time() * 1e3)
        per_node = [len(st.search_series(
            pkg.filters_from_dict({"job": "victoria-metrics"}),
            now_ms - 60_000, now_ms + 60_000)) for st in storages]
        assert all(c > 0 for c in per_node), per_node
        assert sum(per_node) == n
        cluster.close()
    finally:
        stop_rpc_nodes(storages, servers)


def get(port: int, path: str, **params):
    import urllib.error
    import urllib.parse
    import urllib.request
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def scraping_vmsingle(pkg, tmp_path):
    """The package's vmsingle built in-process with -selfScrapeInterval
    0.2 s on a free port (its scraper's instance label names the port):
    (port, api)."""
    from tests.apptest_helpers import free_ports
    port = free_ports(1)[0]
    host = ["-search.tpuBackend=false"] if pkg.name == "port" else []
    storage, srv, api = pkg.vmsingle.build(pkg.vmsingle.parse_flags([
        f"-storageDataPath={tmp_path / 'data'}",
        f"-httpListenAddr=127.0.0.1:{port}", "-selfScrapeInterval=0.2",
        *host]))
    srv.start()
    try:
        yield srv.port, api
    finally:
        srv.stop()
        api.selfscraper.stop()
        storage.close()


def test_vmsingle_selfscrape_e2e(scraping_vmsingle):
    """vmsingle with -selfScrapeInterval serves its own history through
    query_range within a few intervals, labeled with its job and
    instance; the scraper counts on /metrics."""
    port, _ = scraping_vmsingle
    deadline = time.time() + 15
    rows = []
    while time.time() < deadline:
        now = time.time()
        code, body = get(port, "/api/v1/query_range",
                         query="vm_app_uptime_seconds", start=now - 60,
                         end=now, step="1s")
        assert code == 200, body
        rows = json.loads(body)["data"]["result"]
        if rows and len({v for _, v in rows[0]["values"]}) >= 2:
            break
        time.sleep(0.2)
    assert rows, "self-scraped series never became queryable"
    assert rows[0]["metric"]["job"] == "victoria-metrics"
    assert rows[0]["metric"]["instance"] == f"vmsingle:{port}"
    vals = [float(v) for _, v in rows[0]["values"]]
    assert vals[-1] > vals[0] >= 0.0
    assert b"vm_selfscrape_scrapes_total" in get(port, "/metrics")[1]


def test_vmsingle_health_and_slo_endpoints(scraping_vmsingle):
    port, _ = scraping_vmsingle
    code, body = get(port, "/api/v1/status/health")
    assert code == 200, body
    h = json.loads(body)
    assert h["verdict"] == "ok" and h["role"] == "vmsingle"
    assert h["reasons"] == [] and h["uptimeSeconds"] >= 0.0
    code, body = get(port, "/api/v1/status/slo", pump="1")
    assert code == 200, body
    st = json.loads(body)
    assert st["evalRounds"] >= 1
    assert {s["slo"] for s in st["slos"]} >= {
        "http-availability", "http-latency", "ingest-durability",
        "search-admission"}
    assert all(not s["firing"] for s in st["slos"]), st["slos"]
    code, body = get(port, "/api/v1/status/incidents")
    assert code == 200 and json.loads(body)["data"] == []


def test_metrics_pusher_posts_with_extra_labels(pkg):
    """-pushmetrics.url: the pusher POSTs the collected text, gzipped,
    with each -pushmetrics.extraLabel spliced into every sample."""
    import gzip
    from http.server import BaseHTTPRequestHandler, HTTPServer
    got = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            if self.headers.get("Content-Encoding") == "gzip":
                body = gzip.decompress(body)
            got.append(body.decode())
            self.send_response(204)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pusher = pkg.pushmetrics.MetricsPusher(
        [f"http://127.0.0.1:{srv.server_address[1]}/api/v1/import/"
         "prometheus"],
        lambda: 'vm_pushed_total{a="b"} 3\nvm_plain 1\n',
        interval_s=0.05, extra_labels='dc="eu"')
    try:
        pusher.start()
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.02)
    finally:
        pusher.stop()
        srv.shutdown()
    assert got, "nothing pushed"
    lines = [ln for ln in got[0].splitlines() if ln]
    assert all('dc="eu"' in ln for ln in lines), lines
    assert any(ln.startswith("vm_pushed_total{") and ln.endswith(" 3")
               for ln in lines)
