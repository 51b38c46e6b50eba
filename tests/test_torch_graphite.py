"""Graphite's query API on the port (``httpapi/graphite_api.py`` and
``graphite_funcs.py``) against the reference's.

Every case of ``tests/test_graphite_api.py`` and
``tests/test_graphite_funcs.py`` runs with the reference's and the port's
vmsingle side by side on the same data: each request goes to both, the
status and the JSON body must be equal, and the reference's assertion
holds on the body.  The fixture's anchor is a day-aligned instant two
days back (the reference's fixed July 2025 lies outside the retention).
Then ``/render`` through the port's vmselect over three in-process
vmstorage nodes equals the same request to one store holding the same
rows, as strings.
"""

import json
import threading
import time

import numpy as np
import pytest

from tests.apptest_helpers import Client
from tests.test_graphite_funcs import GRAPHITE_FUNCTIONS_JSON
from victoriametrics_tpu.apps import vmsingle as ref_vmsingle
from victoriametrics_tpu.utils import profiler as ref_profiler
from victoriametrics_tpu_torch.apps import vmsingle as port_vmsingle
from victoriametrics_tpu_torch.httpapi import graphite_api as port_ga
from victoriametrics_tpu_torch.utils import profiler as port_profiler

DAY = 86_400_000
T0 = (int(time.time() * 1000) - 2 * DAY) // DAY * DAY


def _rows():
    # graphite-style series: dotted names and one tagged series
    rows = []
    for host in ("web1", "web2"):
        for j in range(30):
            rows.append(({"__name__": f"servers.{host}.cpu.load"},
                         T0 + j * 60_000, float(j)))
    for j in range(30):
        rows.append(({"__name__": "servers.web1.mem.used", "dc": "east"},
                     T0 + j * 60_000, 100.0 + j))
    return rows


class Pair:
    """The reference's and the port's vmsingle in process, each on its
    own data directory; ``get`` sends a request to both, holds the
    statuses and JSON bodies equal and returns the port's."""

    def __init__(self, path, rows):
        self.sides = []
        for name, mod, flags in (
                ("ref", ref_vmsingle, []),
                ("port", port_vmsingle, ["-search.tpuBackend=false"])):
            storage, srv, api = mod.build(mod.parse_flags([
                f"-storageDataPath={path / name}",
                "-httpListenAddr=127.0.0.1:0", *flags]))
            srv.start()
            storage.add_rows(rows)
            self.sides.append((storage, srv, Client(srv.port)))

    def get(self, path, **params):
        (rc, rb), (pc, pb) = (c.get(path, **params)
                              for _, _, c in self.sides)
        assert pc == rc, (path, params, pc, rc, pb[:300])
        if rc == 200:
            assert json.loads(pb) == json.loads(rb), (path, params)
        return pc, pb

    def close(self):
        for storage, srv, _ in self.sides:
            srv.stop()
            storage.close()
        ref_profiler.PROFILER.stop()
        port_profiler.PROFILER.stop()


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    pair = Pair(tmp_path_factory.mktemp("gpair"), _rows())
    yield pair
    pair.close()


def render(app, target, **kw):
    params = {"target": target, "from": str((T0 - 60_000) // 1000),
              "until": str((T0 + 29 * 60_000) // 1000),
              "format": "json", **kw}
    code, body = app.get("/render", **params)
    assert code == 200, body
    return json.loads(body)


def vals(series):
    return [p[0] for p in series["datapoints"] if p[0] is not None]


# -- tests/test_graphite_api.py ----------------------------------------------

class TestMetricsFind:
    def test_top_level(self, app):
        code, body = app.get("/metrics/find", query="*")
        assert code == 200
        assert json.loads(body) == [{"text": "servers", "id": "servers",
                                     "leaf": 0, "expandable": 1,
                                     "allowChildren": 1, "context": {}}]

    def test_glob_level(self, app):
        code, body = app.get("/metrics/find", query="servers.*")
        assert [n["text"] for n in json.loads(body)] == ["web1", "web2"]

    def test_leaf(self, app):
        code, body = app.get("/metrics/find", query="servers.web1.cpu.*")
        nodes = json.loads(body)
        assert nodes[0]["leaf"] == 1 and \
            nodes[0]["id"] == "servers.web1.cpu.load"

    def test_braces(self, app):
        code, body = app.get("/metrics/find", query="servers.{web1}.*")
        assert [n["text"] for n in json.loads(body)] == ["cpu", "mem"]

    def test_expand(self, app):
        code, body = app.get("/metrics/expand", query="servers.*.cpu")
        assert json.loads(body)["results"] == [
            "servers.web1.cpu", "servers.web2.cpu"]


class TestTagsAPI:
    def test_tags_list(self, app):
        code, body = app.get("/tags")
        tags = [t["tag"] for t in json.loads(body)]
        assert "name" in tags and "dc" in tags

    def test_tag_values(self, app):
        code, body = app.get("/tags/dc")
        d = json.loads(body)
        assert d["tag"] == "dc"
        assert [v["value"] for v in d["values"]] == ["east"]

    def test_autocomplete(self, app):
        code, body = app.get("/tags/autoComplete/tags", tagPrefix="d")
        assert json.loads(body) == ["dc"]
        code, body = app.get("/tags/autoComplete/values", tag="dc",
                             valuePrefix="e")
        assert json.loads(body) == ["east"]

    def test_find_series(self, app):
        code, body = app.get("/tags/findSeries", expr="dc=east")
        assert json.loads(body) == ["servers.web1.mem.used;dc=east"]


class TestRender:
    def test_plain_path_glob(self, app):
        out = render(app, "servers.*.cpu.load")
        assert {s["target"] for s in out} == {
            "servers.web1.cpu.load", "servers.web2.cpu.load"}
        assert vals(out[0])[:3] == [0.0, 1.0, 2.0]
        # datapoint timestamps are epoch seconds
        assert out[0]["datapoints"][0][1] * 1000 >= T0 - 120_000

    def test_sum_and_alias(self, app):
        out = render(app, 'alias(sumSeries(servers.*.cpu.load), "tot")')
        assert len(out) == 1 and out[0]["target"] == "tot"
        assert vals(out[0])[:3] == [0.0, 2.0, 4.0]  # two series summed

    def test_scale_and_nnderivative(self, app):
        out = render(app,
                     "scale(nonNegativeDerivative(servers.web1.cpu.load), 2)")
        assert all(v == 2.0 for v in vals(out[0]))  # slope 1/min * 2

    def test_alias_by_node_and_group(self, app):
        out = render(app, "aliasByNode(servers.*.cpu.load, 1)")
        assert {s["target"] for s in out} == {"web1", "web2"}
        out = render(app, 'groupByNode(servers.*.cpu.load, 1, "sum")')
        assert {s["target"] for s in out} == {"web1", "web2"}

    def test_series_by_tag(self, app):
        out = render(app, "seriesByTag('dc=east')")
        assert len(out) == 1
        assert out[0]["target"] == "servers.web1.mem.used"
        assert out[0]["tags"]["dc"] == "east"

    def test_max_data_points(self, app):
        out = render(app, "servers.web1.cpu.load", maxDataPoints="5")
        assert len(out[0]["datapoints"]) <= 7  # ceil-rounded grid ends

    def test_bad_target(self, app):
        code, body = app.get("/render", target="nosuchfunc(",
                             **{"from": "-1h"})
        assert code == 400


class TestReviewRegressions:
    def test_leaf_and_branch_node(self, tmp_path):
        pair = Pair(tmp_path, [({"__name__": "a.b"}, T0, 1.0),
                               ({"__name__": "a.b.c"}, T0, 2.0)])
        try:
            code, body = pair.get("/metrics/find", query="a.*")
            n = json.loads(body)[0]
            assert n["leaf"] == 1 and n["expandable"] == 1  # both roles
            code, body = pair.get("/metrics/find", query="?.b")  # '?'
            assert [x["id"] for x in json.loads(body)] == ["a.b"]
            # a bad `from` is a 400, not a 500
            code, _ = pair.get("/render", target="a.b",
                               **{"from": "tomorrow"})
            assert code == 400
        finally:
            pair.close()

    def test_alias_by_tags(self, app):
        code, body = app.get(
            "/render", target="aliasByTags(seriesByTag('dc=east'), 'dc')",
            **{"from": str((T0 - 60_000) // 1000),
               "until": str((T0 + 29 * 60_000) // 1000)})
        out = json.loads(body)
        assert out and out[0]["target"] == "east"


# -- tests/test_graphite_funcs.py --------------------------------------------

class TestCombiners:
    def test_diff_series(self, app):
        out = render(app, "diffSeries(servers.web1.mem.used,"
                          "servers.web1.cpu.load)")
        assert vals(out[0])[:3] == [100.0, 100.0, 100.0]

    def test_multiply_series(self, app):
        out = render(app, "multiplySeries(servers.*.cpu.load)")
        assert vals(out[0])[:4] == [0.0, 1.0, 4.0, 9.0]

    def test_range_count_stddev(self, app):
        assert vals(render(app, "rangeOfSeries(servers.*.cpu.load)")[0]
                    )[:2] == [0.0, 0.0]
        assert vals(render(app, "countSeries(servers.*.cpu.load)")[0]
                    )[:2] == [2.0, 2.0]
        assert vals(render(app, "stddevSeries(servers.*.cpu.load)")[0]
                    )[:2] == [0.0, 0.0]

    def test_aggregate_generic(self, app):
        out = render(app, 'aggregate(servers.*.cpu.load, "max")')
        assert vals(out[0])[:3] == [0.0, 1.0, 2.0]

    def test_percentile_of_series(self, app):
        out = render(app, "percentileOfSeries(servers.*.cpu.load, 50)")
        assert vals(out[0])[:3] == [0.0, 1.0, 2.0]

    def test_group_by_tags(self, app):
        out = render(app, 'groupByTags(seriesByTag(\'dc=east\'), "sum", '
                          '"dc")')
        assert len(out) == 1 and out[0]["tags"].get("dc") == "east"

    def test_pow_series_lists(self, app):
        out = render(app, "sumSeriesLists(servers.web1.cpu.load,"
                          "servers.web2.cpu.load)")
        assert vals(out[0])[:3] == [0.0, 2.0, 4.0]


class TestTransforms:
    def test_invert_log_sqrt(self, app):
        v = vals(render(app, "invert(servers.web1.mem.used)")[0])
        assert abs(v[0] - 0.01) < 1e-12
        v = vals(render(app, "squareRoot(servers.web1.mem.used)")[0])
        assert abs(v[0] - 10.0) < 1e-12
        v = vals(render(app, "logarithm(servers.web1.mem.used)")[0])
        assert abs(v[0] - 2.0) < 1e-12

    def test_offset_to_zero(self, app):
        v = vals(render(app, "offsetToZero(servers.web1.mem.used)")[0])
        assert v[:3] == [0.0, 1.0, 2.0]

    def test_transform_null_is_non_null(self, app):
        out = render(app, "transformNull(servers.web1.cpu.load, -1)")
        assert -1 in [p[0] for p in out[0]["datapoints"]]
        out = render(app, "isNonNull(servers.web1.cpu.load)")
        assert set(vals(out[0])) <= {0.0, 1.0}

    def test_integral(self, app):
        v = vals(render(app, "integral(servers.web1.cpu.load)")[0])
        assert v[:4] == [0.0, 1.0, 3.0, 6.0]

    def test_derivative_round(self, app):
        v = vals(render(app, "derivative(servers.web1.cpu.load)")[0])
        assert all(x == 1.0 for x in v)
        v = vals(render(app, "round(scale(servers.web1.cpu.load, 0.3))")[0])
        assert v[:4] == [0.0, 0.0, 1.0, 1.0]

    def test_time_shift(self, app):
        out = render(app, 'timeShift(servers.web1.cpu.load, "5min")')
        v = vals(out[0])
        assert v[0] == 0.0 and len(v) <= 26  # values lag by 5
        assert out[0]["target"].startswith("timeShift(")

    def test_moving_average(self, app):
        v = vals(render(app, "movingAverage(servers.web1.cpu.load, 3)")[0])
        assert v[:4] == [0.0, 0.5, 1.0, 2.0]

    def test_moving_sum_median(self, app):
        v = vals(render(app, "movingSum(servers.web1.cpu.load, 2)")[0])
        assert v[:4] == [0.0, 1.0, 3.0, 5.0]
        v = vals(render(app, "movingMedian(servers.web1.cpu.load, 3)")[0])
        assert v[2:5] == [1.0, 2.0, 3.0]

    def test_ema(self, app):
        v = vals(render(
            app, "exponentialMovingAverage(servers.web1.cpu.load, 3)")[0])
        assert abs(v[0]) < 1e-12 and 0 < v[1] < 1

    def test_stdev_linearreg(self, app):
        v = vals(render(app, "stdev(servers.web1.cpu.load, 3)")[0])
        assert abs(v[2] - np.std([0, 1, 2])) < 1e-9
        v = vals(render(app, "linearRegression(servers.web1.cpu.load)")[0])
        d = np.diff(v)
        assert np.allclose(d, d[0])

    def test_n_percentile(self, app):
        v = vals(render(app, "nPercentile(servers.web1.cpu.load, 100)")[0])
        assert all(x == 29.0 for x in v)


class TestFilters:
    def test_above_below(self, app):
        out = render(app, "maximumAbove(servers.*.*.*, 50)")
        assert {s["target"] for s in out} == {"servers.web1.mem.used"}
        out = render(app, "maximumBelow(servers.*.*.*, 50)")
        assert {s["target"] for s in out} == {"servers.web1.cpu.load",
                                              "servers.web2.cpu.load"}
        assert len(render(app, "averageAbove(servers.*.*.*, 50)")) == 1

    def test_highest_lowest(self, app):
        out = render(app, 'highest(servers.*.*.*, 1, "average")')
        assert out[0]["target"] == "servers.web1.mem.used"
        out = render(app, "lowestAverage(servers.*.*.*, 2)")
        assert {s["target"] for s in out} == {"servers.web1.cpu.load",
                                              "servers.web2.cpu.load"}
        out = render(app, "highestCurrent(servers.*.*.*, 1)")
        assert out[0]["target"] == "servers.web1.mem.used"

    def test_remove_value_filters(self, app):
        v = vals(render(app, "removeAboveValue(servers.web1.cpu.load, 5)")[0])
        assert max(v) <= 5
        v = vals(render(app, "removeBelowValue(servers.web1.cpu.load, 5)")[0])
        assert min(v) >= 5

    def test_grep_exclude_unique_limit(self, app):
        assert len(render(app, 'grep(servers.*.*.*, "mem")')) == 1
        assert len(render(app, 'exclude(servers.*.*.*, "mem")')) == 2
        assert len(render(app, "limit(servers.*.*.*, 2)")) == 2
        assert len(render(app, "unique(group(servers.web1.cpu.load,"
                               "servers.web1.cpu.load))")) == 1

    def test_filter_series(self, app):
        out = render(app, 'filterSeries(servers.*.*.*, "max", ">", 50)')
        assert {s["target"] for s in out} == {"servers.web1.mem.used"}


class TestSortDivide:
    def test_sort_by_name_total(self, app):
        names = [s["target"] for s in render(app, "sortByName(servers.*.*.*)")]
        assert names == sorted(names)
        out = render(app, "sortByTotal(servers.*.*.*)")
        assert out[0]["target"] == "servers.web1.mem.used"

    def test_divide_series(self, app):
        out = render(app, "divideSeries(servers.web1.mem.used,"
                          "servers.web1.mem.used)")
        assert all(x == 1.0 for x in vals(out[0]))

    def test_as_percent(self, app):
        out = render(app, "asPercent(servers.*.cpu.load)")
        # two equal series: each is 50% where nonzero
        assert all(abs(x - 50.0) < 1e-9 for x in vals(out[0])[1:])

    def test_weighted_average(self, app):
        out = render(app, "weightedAverage(servers.*.cpu.load,"
                          "servers.*.cpu.load, 1)")
        assert len(out) == 1


class TestSynthetic:
    def test_constant_threshold_time(self, app):
        assert all(x == 4.5 for x in vals(render(app, "constantLine(4.5)")[0]))
        assert render(app, 'threshold(3, "lim")')[0]["target"] == "lim"
        v = vals(render(app, "time()")[0])
        assert v[1] - v[0] == 60.0

    def test_fallback(self, app):
        out = render(app, "fallbackSeries(no.such.path,"
                          "servers.web1.cpu.load)")
        assert out and out[0]["target"] == "servers.web1.cpu.load"

    def test_holt_winters(self, app):
        out = render(app, "holtWintersForecast(servers.web1.cpu.load)")
        assert len(out) == 1 and out[0]["target"].startswith("holtWinters")
        assert len(render(
            app, "holtWintersConfidenceBands(servers.web1.cpu.load)")) == 2

    def test_alias_sub(self, app):
        out = render(app,
                     'aliasSub(servers.web1.cpu.load, "web(\\d)", "w\\1")')
        assert out[0]["target"] == "servers.w1.cpu.load"

    def test_substr(self, app):
        out = render(app, "substr(servers.web1.cpu.load, 1, 3)")
        assert out[0]["target"] == "web1.cpu"


class TestIntrospection:
    def test_functions_endpoint(self, app):
        code, body = app.get("/functions")
        assert code == 200
        fns = json.loads(body)
        assert len(fns) >= 140
        for must in ("sumSeries", "movingAverage", "asPercent",
                     "holtWintersForecast", "timeShift", "sortByName",
                     "reduceSeries", "groupByTags"):
            assert must in fns, must


def test_full_reference_function_parity():
    missing = [n for n in GRAPHITE_FUNCTIONS_JSON
               if n not in port_ga._G_FUNCS]
    assert not missing, f"graphite functions missing: {missing}"
    assert len(GRAPHITE_FUNCTIONS_JSON) == 151


# -- vmselect over three storage nodes ---------------------------------------

def _serve_rpc(srv):
    srv._thread = threading.Thread(target=srv._srv.serve_forever,
                                   args=(0.02,), daemon=True)
    srv.start()
    return srv


def test_render_through_vmselect_equals_the_single_store(tmp_path):
    """Graphite's /render, /metrics/find and /tags through the port's
    vmselect (``GraphiteAPI`` over ``ClusterStorage``) across three
    vmstorage nodes at replication factor 2 equal the same requests to
    one vmsingle holding the same rows, as strings."""
    from victoriametrics_tpu_torch.apps import vminsert, vmselect
    from victoriametrics_tpu_torch.parallel import rpc
    from victoriametrics_tpu_torch.parallel.cluster_api import \
        make_storage_handlers
    from victoriametrics_tpu_torch.storage.storage import Storage
    nodes, specs = [], []
    for i in range(3):
        st = Storage(str(tmp_path / f"n{i}"))
        h = make_storage_handlers(st)
        ins = _serve_rpc(rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_INSERT, h))
        sel = _serve_rpc(rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_SELECT, h))
        nodes.append((st, ins, sel))
        specs.append(f"-storageNode=127.0.0.1:{ins.port}:{sel.port}")
    rng = np.random.default_rng(3)
    rows = [({"__name__": "g_requests_total", "instance": f"i{i}",
              "s": str(j)}, T0 + k * 15_000, float(v))
            for i in range(4) for j in range(8)
            for k, v in enumerate(np.cumsum(rng.integers(0, 50, 240)))]
    ins_cluster, isrv, _, _ = vminsert.build(vminsert.parse_flags(
        specs + ["-replicationFactor=2", "-httpListenAddr=127.0.0.1:0"]))
    sel_cluster, ssrv, sapi, _ = vmselect.build(vmselect.parse_flags(
        specs + ["-replicationFactor=2", "-search.tpuBackend=false",
                 "-httpListenAddr=127.0.0.1:0"]))
    ssrv.start()
    single = port_vmsingle.build(port_vmsingle.parse_flags([
        f"-storageDataPath={tmp_path / 'single'}",
        "-httpListenAddr=127.0.0.1:0", "-search.tpuBackend=false"]))
    single[1].start()
    try:
        ins_cluster.add_rows(rows)
        single[0].add_rows(rows)
        for st, _, _ in nodes:
            st.force_flush()
        single[0].force_flush()
        span = {"from": str(T0 // 1000),
                "until": str((T0 + 3600_000) // 1000)}
        reqs = [("/render", {"target": "sumSeries(seriesByTag("
                             "'name=g_requests_total','instance=i1'))",
                             **span}),
                ("/render", {"target": "groupByTags(seriesByTag("
                             "'name=g_requests_total'),'sum','instance')",
                             **span}),
                ("/render", {"target": "perSecond(seriesByTag("
                             "'name=g_requests_total','instance=i2'))",
                             **span}),
                ("/metrics/find", {"query": "*"}), ("/tags", {}),
                ("/tags/instance", {})]
        for path, params in reqs:
            got = Client(ssrv.port).get(path, **params)
            want = Client(single[1].port).get(path, **params)
            assert got[0] == want[0] == 200, (path, got, want)
            assert got[1] == want[1], (path, params)
        path, params = reqs[1]
        body = json.loads(Client(ssrv.port).get(path, **params)[1])
        assert sorted(s["tags"]["instance"] for s in body) == [
            "i0", "i1", "i2", "i3"]
    finally:
        ssrv.stop()
        sel_cluster.close()
        ins_cluster.close()
        single[1].stop()
        single[0].close()
        for st, ins, sel in nodes:
            ins.stop()
            sel.stop()
            st.close()
        port_profiler.PROFILER.stop()
