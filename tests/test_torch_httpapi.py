"""The port's HTTP layer (``victoriametrics_tpu_torch/httpapi``, built by
its ``apps/vmsingle.build``) against the reference's vmsingle, side by
side in one process on real localhost ports.

Both servers are fed the same bodies on every insert route the port
registers (remote write, Prometheus text and Influx lines through each
side's native columnar branch, which both must take: the same series in
their columnar key maps) and asked the same ``query``, ``query_range``,
``series``, ``labels``, ``label/<n>/values``, ``export``, ``export/native`` ->
``import/native`` round trip, ``federate``, ``status/tsdb``,
``prettify-query``, ``parse-query``, ``metadata`` and ``delete_series``;
their bodies must be equal as JSON (or as bytes), with only the volatile
fields (timings, start times) removed.  The 400/422/429/503 answers to
bad arguments and limits compare the same way.  Under
``-streamAggr.config`` the rows take the row path on both sides (stream
aggregation must see every row) and the aggregates flushed into each
store answer the same.

Then the device path: the port with ``api.tpu = CUDAEngine(device="cpu",
min_series=4)`` (the kernels' plain versions) against the reference with
``TPUEngine(min_series=4)`` on the dashboard's nine panels over HTTP,
cold, as a full cache hit and advanced one step (a partial hit of the
rollup cache, or for the sum and the quantile the device-resident
window): the same series, values at rtol 1e-12 (quantile and median at
the reference's own 1e-6).  The data is anchored to the wall clock
(inside the 13-month retention; the queried windows end ten minutes
before it, outside the rollup cache's five-minute offset, so that a
repeat is a full hit)."""

import collections
import json
import time

import numpy as np
import pytest

from tests.apptest_helpers import Client
from victoriametrics_tpu.apps import vmsingle as ref_vmsingle
from victoriametrics_tpu.ingest import remote_write as ref_rw
from victoriametrics_tpu.query import rollup_result_cache as ref_rrc
from victoriametrics_tpu.utils import profiler as ref_profiler
from victoriametrics_tpu_torch.apps import vmsingle as port_vmsingle
from victoriametrics_tpu_torch.ingest import remote_write as port_rw
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import fleet
from victoriametrics_tpu_torch.query import rollup_result_cache as port_rrc
from victoriametrics_tpu_torch.utils import profiler as port_profiler

DAY = 86_400_000
STEP = 60_000
SCRAPE = 15_000
#: history anchored a day before the wall clock, on the minute
T0 = (int(time.time() * 1000) - DAY) // STEP * STEP

#: fields whose values are timings or start times, not results
VOLATILE = frozenset({"duration", "durationMs", "duration_msec",
                      "startTime", "start_time", "statsCollectedSince",
                      "trace", "sumDuration", "avgDuration", "maxDuration",
                      "timeRangeSeconds", "lastRequestTimestamp",
                      "sumCpuMs", "avgCpuMs", "remoteAddr", "elapsed"})


def scrub(x):
    """A JSON body with the volatile fields removed, recursively."""
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    return x


class Side:
    """One vmsingle built in-process (its package's ``apps.vmsingle``) and
    serving on a free localhost port."""

    def __init__(self, vmsingle, path, flags=()):
        args = vmsingle.parse_flags([f"-storageDataPath={path}",
                                     "-httpListenAddr=127.0.0.1:0", *flags])
        self.storage, self.srv, self.api = vmsingle.build(args)
        self.srv.start()
        self.client = Client(self.srv.port)

    def close(self):
        self.srv.stop()
        self.storage.close()


class HttpPair:
    """The reference's and the port's vmsingle side by side, each on its
    own data directory."""

    def __init__(self, tmp_path, flags=()):
        self.ref = Side(ref_vmsingle, tmp_path / "ref", flags)
        try:
            # the port serves on the host here: no card on the CPU
            self.port = Side(port_vmsingle, tmp_path / "port",
                             ("-search.tpuBackend=false", *flags))
        except BaseException:
            self.ref.close()
            raise

    def close(self):
        try:
            self.port.close()
        finally:
            self.ref.close()
            # build() started each package's sampling profiler: stop them,
            # so that no sampler thread outlives the test in this worker
            ref_profiler.PROFILER.stop()
            port_profiler.PROFILER.stop()

    def post(self, path, body, headers=None, **params):
        """The same POST to both: the same status and body."""
        got = self.port.client.post(path, body, headers=headers, **params)
        want = self.ref.client.post(path, body, headers=headers, **params)
        assert got[0] == want[0], (path, got, want)
        assert_same_body(path, got[1], want[1])
        return got

    def get(self, path, **params):
        """The same GET to both: the same status and body (JSON bodies
        with the volatile fields removed)."""
        got = self.port.client.get(path, **params)
        want = self.ref.client.get(path, **params)
        assert got[0] == want[0], (path, params, got, want)
        assert_same_body(f"{path} {params}", got[1], want[1])
        return got[0], got[1]

    def flush(self):
        for side in (self.ref, self.port):
            side.client.force_flush()


def assert_same_body(what, got: bytes, want: bytes):
    try:
        g, w = json.loads(got), json.loads(want)
    except ValueError:
        assert got == want, what
        return
    assert scrub(g) == scrub(w), what


@pytest.fixture()
def pair(tmp_path):
    p = HttpPair(tmp_path)
    yield p
    p.close()


# -- every insert route, then the read routes ---------------------------------

def _scrapes(name, n_series, n, seed, t0=T0, gauge=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        ts = t0 + np.arange(n, dtype=np.int64) * SCRAPE + \
            rng.integers(0, 2000, n)
        if gauge:
            vals = np.round(rng.normal(50, 10, n), 3)
        else:
            vals = np.cumsum(rng.integers(0, 40, n)).astype(float)
        out.append(({"__name__": name, "instance": f"h{i % 4}",
                     "id": str(i)}, ts.tolist(), vals.tolist()))
    return out


def _otlp_body():
    from test_torch_ingest import _otlp_payload
    from victoriametrics_tpu_torch.ingest import protowire
    return _otlp_payload(protowire, 0, T0)


def ingest_everywhere(pair):
    """One payload on every insert route the port registers."""
    rw = [(sorted(lab.items()), list(zip(ts, vals)))
          for lab, ts, vals in _scrapes("rw_m", 6, 40, 1)]
    body = port_rw.build_write_request(rw)
    assert body == ref_rw.build_write_request(rw)
    pair.post("/api/v1/write", body, headers={"Content-Encoding": "snappy"})
    pair.post("/api/v1/push", port_rw.build_write_request(
        [([("__name__", "push_m")], [(T0, 1.0)])], compress="zstd"),
        headers={"Content-Encoding": "zstd"})
    pair.post("/prometheus/api/v1/write", port_rw.build_write_request(
        [([("__name__", "prw_m"), ("a", "b")], [(T0, 2.5)])]))
    lines = [json.dumps({"metric": lab, "values": vals, "timestamps": ts})
             for lab, ts, vals in _scrapes("imp_m", 5, 40, 2, gauge=True)]
    pair.post("/api/v1/import", "\n".join(lines).encode())
    text = "".join(f'prom_m{{instance="{lab["instance"]}",id="{lab["id"]}"}}'
                   f" {v} {t}\n"
                   for lab, ts, vals in _scrapes("p", 4, 30, 3)
                   for t, v in zip(ts, vals))
    pair.post("/api/v1/import/prometheus",
              ("# HELP prom_m a counter\n# TYPE prom_m counter\n" + text
               ).encode())
    pair.post("/api/v1/import/csv", f"h1,42.5,{T0 // 1000}\nh2,7.5,"
              f"{T0 // 1000}\n".encode(),
              format="1:label:host,2:metric:csv_temp,3:time:unix_s")
    pair.post("/write", f"cpu,host=h1 usage_user=42.5,usage_system=7 "
              f"{T0 * 10**6}".encode())
    pair.post("/influx/write", f"mem,host=h2 free=10i {T0 * 10**6}".encode(),
              db="telegraf")
    pair.post("/api/put", json.dumps([{"metric": "ot.m",
                                       "timestamp": T0 // 1000, "value": 9.5,
                                       "tags": {"t": "x"}}]).encode())
    pair.post("/opentsdb/api/put", json.dumps(
        {"metric": "ot2.m", "timestamp": T0, "value": 3,
         "tags": {"t": "y"}}).encode())
    pair.post("/zabbixconnector/api/v1/history", json.dumps(
        {"host": {"host": "zh", "name": "Z"}, "name": "load",
         "clock": T0 // 1000, "ns": 0, "value": 1.25, "type": 0,
         "item_tags": [], "groups": []}).encode())
    pair.post("/graphite", f"foo.bar;dc=east 10.5 {T0 // 1000}".encode())
    pair.post("/datadog/api/v1/series", json.dumps(
        {"series": [{"metric": "dd.m", "points": [[T0 // 1000, 1.5]],
                     "host": "h1", "tags": ["env:prod"]}]}).encode())
    pair.post("/datadog/api/v2/series", json.dumps(
        {"series": [{"metric": "dd2.m", "points": [
            {"timestamp": T0 // 1000, "value": 4.25}],
            "resources": [{"name": "h", "type": "host"}]}]}).encode())
    pair.post("/datadog/api/v1/validate", b"")
    pair.post("/newrelic/infra/v2/metrics/events/bulk", json.dumps(
        [{"Events": [{"eventType": "SystemSample", "timestamp": T0 // 1000,
                      "cpuPercent": 25, "entityKey": "h1"}]}]).encode())
    otlp = _otlp_body()
    for path in ("/opentelemetry/v1/metrics", "/opentelemetry/api/v1/push",
                 "/v1/metrics"):
        pair.post(path, otlp)
    pair.post("/insert/7:3/prometheus/api/v1/import/prometheus",
              f"tenant_m 5 {T0}\n".encode())
    pair.flush()


QUERIES = ["rw_m", "sum by (instance)(rate(rw_m[5m]))", "imp_m",
           "avg_over_time(imp_m[2m])", "rate(prom_m[1m])", "csv_temp",
           "cpu_usage_user", "mem_free", '{__name__="ot.m"}',
           '{__name__="ot2.m"}', "load", '{__name__="foo.bar"}',
           "dd_m", "dd2_m",
           "system_sample_cpu_percent", '{__name__=~"otlp.*"}',
           "push_m", "prw_m", "histogram_quantile(0.5, "
           'sum by (le)({__name__="otlp.latency_bucket"}))',
           "topk(2, rw_m)", "count(rw_m) by (instance)"]


def columnar_keys(side) -> dict:
    """The raw series keys each tenant's columnar space holds: only the
    native columnar branch (add_rows_columnar) fills them."""
    return {tenant: len(sp.keymap)
            for tenant, sp in side.storage._cspaces.items()}


def test_every_insert_route_then_queries(pair):
    ingest_everywhere(pair)
    # remote write (6 series on /api/v1/write, one each on /api/v1/push
    # and /prometheus/api/v1/write), Prometheus text (4), Influx lines (3:
    # two fields of /write, one of /influx/write), the tenant's text (1)
    want = {(0, 0): 15, (7, 3): 1}
    assert columnar_keys(pair.port) == columnar_keys(pair.ref) == want
    assert pair.port.api.columnar_drop_stats == \
        pair.ref.api.columnar_drop_stats == {}
    t = T0 / 1e3
    for q in QUERIES:
        code, body = pair.get("/api/v1/query", query=q, time=t + 590)
        assert code == 200
        pair.get("/api/v1/query_range", query=q, start=t, end=t + 600,
                 step="60")
    # a query that matched something on every route
    for q in QUERIES[:18]:
        res = json.loads(pair.port.client.get(
            "/api/v1/query_range", query=q, start=t - 60, end=t + 600,
            step="60")[1])
        assert res["data"]["result"], q
    pair.get("/select/7:3/prometheus/api/v1/query", query="tenant_m",
             time=t + 10)
    assert json.loads(pair.port.client.get(
        "/select/7:3/prometheus/api/v1/query", query="tenant_m",
        time=t + 10)[1])["data"]["result"]


def test_metadata_routes(pair):
    ingest_everywhere(pair)
    t = T0 / 1e3
    rng = dict(start=t - 60, end=t + 900)
    for m in ("rw_m", '{__name__=~"imp_m|prom_m"}', '{instance="h1"}'):
        pair.get("/api/v1/series", **{"match[]": m}, **rng)
    pair.get("/api/v1/series", **{"match[]": ["rw_m", "imp_m"]}, limit=3,
             **rng)
    pair.get("/api/v1/labels", **rng)
    for label in ("instance", "__name__", "id", "nosuch"):
        pair.get(f"/api/v1/label/{label}/values", **rng)
    pair.get("/api/v1/status/tsdb", topN="5")
    pair.get("/api/v1/status/tsdb", topN="3", **{"match[]": "rw_m"},
             focusLabel="instance")
    pair.get("/api/v1/metadata")
    pair.get("/api/v1/metadata", metric="prom_m", limit="1")
    for q in ("sum(rate(x[5m])) by (a)", "a + on(b) group_left c",
              "with (f(x) = x*2) f(m)", "bad(("):
        pair.get("/prettify-query", query=q)
        pair.get("/api/v1/parse-query", query=q)
    pair.get("/expand-with-exprs", query="with (f(x) = x*2) f(m)")
    pair.get("/metric-relabel-debug", metric='m{a="1",b="2"}',
             relabel_configs=json.dumps([{"action": "replace",
                                          "source_labels": ["a"],
                                          "target_label": "c"}]))


def test_export_native_round_trip_federate_delete(pair, tmp_path):
    ingest_everywhere(pair)
    for m in ("rw_m", "imp_m"):
        pair.get("/api/v1/export", **{"match[]": m})
        code, blob = pair.get("/api/v1/export/native", **{"match[]": m})
        assert code == 200 and blob.startswith(b"vmtpu-native-v1\n")
        # the port's export into a fresh port server and the reference's
        # into a fresh reference server: the same series come back
        other = HttpPair(tmp_path / f"rt-{m}")
        try:
            ref_blob = pair.ref.client.get("/api/v1/export/native",
                                           **{"match[]": m})[1]
            for side, b in ((other.port, blob), (other.ref, ref_blob)):
                assert side.client.post("/api/v1/import/native", b)[0] == 204
            other.flush()
            other.get("/api/v1/export", **{"match[]": m})
            assert other.port.client.get(
                "/api/v1/export", **{"match[]": m})[1] == \
                pair.port.client.get("/api/v1/export", **{"match[]": m})[1]
        finally:
            other.close()
    pair.post("/api/v1/import/native", b"garbage")
    # federate reads the last lookback delta: live samples
    now = int(time.time() * 1000)
    pair.post("/api/v1/import/prometheus",
              f'fed_m{{a="x\\"y"}} 1.5 {now - 30_000}\n'.encode())
    pair.flush()
    pair.get("/federate", **{"match[]": "fed_m"})
    assert b"fed_m" in pair.port.client.get("/federate",
                                            **{"match[]": "fed_m"})[1]
    pair.post("/api/v1/admin/tsdb/delete_series", b"",
              **{"match[]": "rw_m"})
    t = T0 / 1e3
    pair.get("/api/v1/query_range", query="rw_m", start=t, end=t + 600,
             step="60", nocache="1")
    pair.get("/api/v1/series", **{"match[]": "rw_m"}, start=t - 60,
             end=t + 900)


ERROR_GETS = [
    ("/api/v1/query", {}), ("/api/v1/query", {"query": "sum(("}),
    ("/api/v1/query", {"query": "m", "time": "nonsense"}),
    ("/api/v1/query", {"query": "m", "step": "bad"}),
    ("/api/v1/query_range", {"query": "m", "start": "10", "end": "5"}),
    ("/api/v1/query_range", {"query": "m", "step": "x"}),
    ("/api/v1/query_range", {"query": "m +"}),
    ("/api/v1/series", {}), ("/api/v1/series", {"match[]": "sum(m)"}),
    ("/api/v1/export", {}), ("/api/v1/export/native", {}),
    ("/federate", {}), ("/api/v1/admin/tsdb/delete_series", {}),
    ("/api/v1/labels", {"start": "bad"}),
    ("/api/v1/label/x/values", {"end": "bad"}),
    ("/api/v1/status/tsdb", {"topN": "x"}),
    ("/api/v1/watch", {}), ("/api/v1/watch", {"query": "m", "step": "x"}),
    ("/metric-relabel-debug", {}),
    ("/select/bad/prometheus/api/v1/query", {"query": "m"}),
    ("/select/1/prometheus/no/such/path", {}),
    ("/no/such/route", {}),
]


@pytest.mark.parametrize("i", range(len(ERROR_GETS)))
def test_error_answers(pair, i):
    path, params = ERROR_GETS[i]
    code, _ = pair.get(path, **params)
    assert code >= 400


@pytest.mark.parametrize("path,body", [
    ("/api/v1/write", b"\xff\xfe not protobuf"),
    ("/api/v1/import", b"{not json"),
    ("/api/v1/import/prometheus", b'bad{a="1" 2\n'),
    ("/api/v1/import/csv", b"a,b"),
    ("/write", b"broken line"),
    ("/api/put", b"not json"),
    ("/opentelemetry/v1/metrics", b"\x01\x02 not a protobuf"),
    ("/datadog/api/v1/series", b"{bad"),
    ("/newrelic/infra/v2/metrics/events/bulk", b"{bad"),
])
def test_bad_insert_bodies(pair, path, body):
    """The same status (400, or 204 where the parser skips bad lines) and
    body from both."""
    pair.post(path, body)


AGG_YML = """- match: '{__name__=~"agg_.*"}'
  interval: 1m
  outputs: [sum_samples, count_series, max]
  by: [instance]
- interval: 1m
  outputs: [last]
  without: [id]
"""


def test_stream_aggregation_route(tmp_path):
    """Both servers under -streamAggr.config (and -streamAggr.keepInput):
    the same remote-write and Prometheus-text bodies take the row path
    (no columnar key), and after each side's final flush the aggregates
    and the kept input answer the same."""
    cfg = tmp_path / "agg.yml"
    cfg.write_text(AGG_YML)
    p = HttpPair(tmp_path, [f"-streamAggr.config={cfg}",
                            "-streamAggr.keepInput"])
    try:
        now = int(time.time() * 1000)
        text = "".join(f'agg_m{{instance="{lab["instance"]}",id="{lab["id"]}"'
                       f"}} {v} {t}\n"
                       for lab, ts, vals in _scrapes("a", 6, 8, 21,
                                                     t0=now - 180_000)
                       for t, v in zip(ts, vals))
        p.post("/api/v1/import/prometheus", text.encode())
        rw = [(sorted(lab.items()), list(zip(ts, vals)))
              for lab, ts, vals in _scrapes("agg_rw", 4, 8, 22,
                                            t0=now - 180_000)]
        p.post("/api/v1/write", port_rw.build_write_request(rw),
               headers={"Content-Encoding": "snappy"})
        for side in (p.ref, p.port):
            assert columnar_keys(side) == {}
            assert side.api.rows_inserted == 6 * 8 + 4 * 8
            side.api.stream_aggr.stop(final_flush=True)
        p.flush()
        t = time.time() + 1
        for q in ("agg_m:1m_sum_samples", "agg_m:1m_count_series",
                  "agg_rw:1m_max", '{__name__=~".*:1m_last"}',
                  "count(agg_m)", "count(agg_rw)"):
            code, body = p.get("/api/v1/query", query=q, time=t)
            assert code == 200 and json.loads(body)["data"]["result"], q
    finally:
        p.close()


def test_limits_429_and_503(tmp_path, monkeypatch):
    """429 from the ingest rate limiter, the per-series limits' drop, and
    503 from /api/v1/watch with materialized streams off."""
    p = HttpPair(tmp_path, ["-maxIngestionRate=50",
                            "-maxLabelsPerTimeseries=3"])
    try:
        for side in (p.ref, p.port):
            side.api.rate_limiter.max_wait_s = 0  # reject, never block
        body = "".join(f'rl_m{{i="{i}"}} {i} {T0}\n'
                       for i in range(50)).encode()
        p.post("/api/v1/import/prometheus", body)
        code, _ = p.post("/api/v1/import/prometheus", body)
        assert code == 429
        ok = f'fits{{a="1"}} 1 {T0}\n'
        bad = f'toomany{{a="1",b="2",c="3",d="4"}} 1 {T0}\n'
        time.sleep(1.1)
        p.post("/api/v1/import/prometheus", (ok + bad).encode())
        monkeypatch.setenv("VM_MATSTREAM", "0")
        code, _ = p.get("/api/v1/watch", query="m", step="15s", range="5m")
        assert code == 503
    finally:
        p.close()


# -- the device path over HTTP ------------------------------------------------

#: the dashboard's nine panels (chip_smoke.py's PANEL_TEXTS) on this store
PANELS = {
    "sum_by_instance": "sum by (instance)(rate(http_requests_total[5m]))",
    "rate": "rate(http_requests_total[5m])",
    "topk": "topk(3, rate(http_requests_total[5m]))",
    "bottomk": "bottomk(3, rate(http_requests_total[5m]))",
    "topk_avg": "topk_avg(3, rate(http_requests_total[5m]))",
    "topk_median": "topk_median(3, rate(http_requests_total[5m]))",
    "topk_last": "topk_last(3, rate(http_requests_total[5m]))",
    "quantile_by_instance":
        "quantile(0.9, rate(http_requests_total[5m])) by (instance)",
    "median": "median(rate(http_requests_total[5m]))",
}
#: the reference's own bound for its fused quantile against its host path
QUANTILE_RTOL = 1e-6
DEV_SERIES, DEV_SAMPLES = 32, 360
#: the panels the evaluator keeps a device-resident rolling window for
RESIDENT = ("sum_by_instance", "quantile_by_instance", "median")


def _rtol(panel):
    return QUANTILE_RTOL if panel in ("quantile_by_instance", "median") \
        else 1e-12


def values_close(what, got: bytes, want: bytes, rtol: float):
    """Two query_range bodies: the same series in the same order at the
    same timestamps, values at rtol."""
    g, w = json.loads(got), json.loads(want)
    assert g["status"] == w["status"] == "success", what
    gr, wr = g["data"]["result"], w["data"]["result"]
    assert [r["metric"] for r in gr] == [r["metric"] for r in wr], what
    assert gr, what
    for a, b in zip(gr, wr):
        ta = [t for t, _ in a["values"]]
        assert ta == [t for t, _ in b["values"]], (what, a["metric"])
        np.testing.assert_allclose(
            [float(v) for _, v in a["values"]],
            [float(v) for _, v in b["values"]], rtol=rtol, atol=0,
            err_msg=f"{what} {a['metric']}")


@pytest.fixture()
def device_pair(tmp_path, monkeypatch):
    """Both servers with their device engines on the dashboard's counters,
    90 minutes of history up to the wall clock."""
    from victoriametrics_tpu.query.tpu_engine import TPUEngine
    calls = collections.Counter()
    real = ce.timed_kernel_call

    def counting(kernel, fn, *a, **kw):
        calls[kernel] += 1
        return real(kernel, fn, *a, **kw)

    monkeypatch.setattr(ce, "timed_kernel_call", counting)
    monkeypatch.setattr(fleet, "timed_kernel_call", counting)
    ref_rrc.GLOBAL.reset()
    port_rrc.GLOBAL.reset()
    p = HttpPair(tmp_path)
    p.port.api.tpu = ce.CUDAEngine(device="cpu", min_series=4)
    p.ref.api.tpu = TPUEngine(min_series=4)
    now = int(time.time() * 1000)
    t0 = (now - DEV_SAMPLES * SCRAPE) // STEP * STEP
    feed = _scrapes("http_requests_total", DEV_SERIES, DEV_SAMPLES, 11, t0)
    text = "".join(f'http_requests_total{{instance="{lab["instance"]}",'
                   f'id="{lab["id"]}"}} {v} {t}\n'
                   for lab, ts, vals in feed for t, v in zip(ts, vals))
    p.post("/api/v1/import/prometheus", text.encode())
    p.flush()
    p.calls = calls
    try:
        yield p
    finally:
        p.close()


def _panel_range(p, q, start, end, rtol, what, **extra):
    kw = dict(query=q, start=start / 1e3, end=end / 1e3, step="60", **extra)
    got = p.port.client.get("/api/v1/query_range", **kw)
    want = p.ref.client.get("/api/v1/query_range", **kw)
    assert got[0] == want[0] == 200, (what, got, want)
    values_close(what, got[1], want[1], rtol)
    return got[1]


def test_device_panels_cold_hit_partial_refresh(device_pair):
    p = device_pair
    end = int(time.time() * 1000) // STEP * STEP - 10 * STEP
    start = end - 20 * STEP
    cold = {}
    for panel, q in PANELS.items():
        p.calls.clear()
        cold[panel] = _panel_range(p, q, start, end, _rtol(panel),
                                   f"{panel} cold")
        assert p.calls.get("rollup_tile") or \
            p.calls.get("rollup_aggregate_tile"), (panel, p.calls)
    # the same requests again: rollup-cache full hits (no kernel), but for
    # the aggregates whose device window is resident (the sum, the
    # quantile, the median): their warm path (K2, or B5 + B8), no decode
    for panel, q in PANELS.items():
        p.calls.clear()
        got = _panel_range(p, q, start, end, _rtol(panel), f"{panel} hit")
        values_close(f"{panel} hit vs cold", got, cold[panel], 0.0)
        if panel in RESIDENT:
            assert p.calls and not p.calls.get("decode_tiles"), \
                (panel, p.calls)
        else:
            assert not p.calls, (panel, p.calls)
    # advanced one step: the sum and the quantile through their resident
    # windows (K3 appends the new step's samples, no K1), the others
    # through the rollup cache's partial hit
    for panel, q in PANELS.items():
        p.calls.clear()
        _panel_range(p, q, start + STEP, end + STEP, _rtol(panel),
                     f"{panel} advanced")
        if panel == "sum_by_instance":
            assert p.calls.get("append_tile") and \
                not p.calls.get("decode_tiles"), (panel, p.calls)
        _panel_range(p, q, start + STEP, end + STEP, _rtol(panel),
                     f"{panel} nocache", nocache="1")


def test_device_instant_queries(device_pair):
    p = device_pair
    t = (int(time.time() * 1000) // STEP * STEP - STEP) / 1e3
    for q in ("quantile(0.9, rate(http_requests_total[5m])) by (instance)",
              "topk(3, rate(http_requests_total[5m]))",
              "sum by (instance)(rate(http_requests_total[5m]))"):
        got = p.port.client.get("/api/v1/query", query=q, time=t)
        want = p.ref.client.get("/api/v1/query", query=q, time=t)
        assert got[0] == want[0] == 200
        g, w = json.loads(got[1]), json.loads(want[1])
        gr, wr = g["data"]["result"], w["data"]["result"]
        assert [r["metric"] for r in gr] == [r["metric"] for r in wr], q
        assert gr, q
        np.testing.assert_allclose(
            [float(r["value"][1]) for r in gr],
            [float(r["value"][1]) for r in wr],
            rtol=QUANTILE_RTOL if q.startswith("quantile") else 1e-12)
