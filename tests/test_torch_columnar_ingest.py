"""The columnar native ingest (``native/ingest.cpp``, ``native/parse.cpp``,
``Storage.add_rows_columnar`` and the HTTP layer's columnar branches):
the reference's ``tests/test_columnar_ingest.py``, every case written
once and run against both packages (``pkg`` = the reference or the port),
then the port held against the reference on the same bytes:

- the same bodies (remote write, Prometheus text, Influx lines, malformed
  and escaped cases) give the same ``ColumnarRows`` from both packages'
  parsers: keybuf bytes, offsets, lengths, timestamps and values bit for
  bit, and the same fallbacks (None);
- the same snappy blocks decode to the same bytes;
- a port store written by ``add_rows_columnar`` equals the reference's
  store written by ``add_rows_columnar`` and the port's store written by
  ``add_rows`` with the same rows: ``search_columns`` compared by raw
  name and row order (metric ids are seeded from the clock), timestamps
  exactly and values bit for bit.
"""

import random
import time
import types

import numpy as np
import pytest


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu import native
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.ingest import (parsers, relabel,
                                                remote_write, serieslimits,
                                                snappy)
        from victoriametrics_tpu.storage import storage
        from victoriametrics_tpu.storage.tag_filters import filters_from_dict
    else:
        from victoriametrics_tpu_torch import native
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.ingest import (parsers, relabel,
                                                      remote_write,
                                                      serieslimits, snappy)
        from victoriametrics_tpu_torch.storage import storage
        from victoriametrics_tpu_torch.storage.tag_filters import \
            filters_from_dict
    return types.SimpleNamespace(
        name=name, native=native, parsers=parsers, remote_write=remote_write,
        snappy=snappy, Storage=storage.Storage,
        ColumnarSpace=storage._ColumnarSpace,
        filters_from_dict=filters_from_dict, PrometheusAPI=PrometheusAPI,
        parse_relabel_configs=relabel.parse_relabel_configs,
        SeriesLimits=serieslimits.SeriesLimits)


REF, PORT = _package("ref"), _package("port")

pytestmark = pytest.mark.skipif(
    not (REF.native.available() and PORT.native.available()),
    reason="native library unavailable")


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return REF if request.param == "ref" else PORT


T0 = 1_753_700_000_000


# -- parsers ----------------------------------------------------------------

class TestSnappy:
    def test_roundtrip(self, pkg):
        rng = random.Random(7)
        for payload in (b"", b"x", b"hello world" * 400,
                        bytes(rng.randrange(256) for _ in range(10_000)),
                        b"ab" * 50_000):
            assert pkg.native.snappy_uncompress(
                pkg.snappy.compress(payload)) == payload

    def test_malformed(self, pkg):
        assert pkg.native.snappy_uncompress(b"\xff\xff\xff\xff\xff") is None


def rw_roundtrip(pkg, series, default_ts=T0):
    raw = pkg.remote_write.build_write_request(series, compress="")
    cr = pkg.native.parse_rw_columnar(raw, default_ts)
    assert cr is not None
    return cr.to_rows()


class TestRemoteWriteParse:
    def test_matches_python(self, pkg):
        series = []
        for i in range(50):
            labels = [("__name__", "m"), ("idx", str(i)), ("job", "api")]
            samples = [(T0 + j, float(i + j)) for j in range(4)]
            series.append((labels, samples))
        rows = rw_roundtrip(pkg, series)
        raw = pkg.remote_write.build_write_request(series, compress="")
        py = [(dict(labels), ts, val)
              for labels, samples in pkg.remote_write.parse_write_request(
                  raw, "none")
              for ts, val in samples]
        assert len(rows) == len(py) == 200
        for (key, ts, val), (plabels, pts, pval) in zip(rows, py):
            assert dict(pkg.parsers.labels_from_series_key(key)) == plabels
            assert ts == pts and val == pval

    def test_zero_ts_defaults(self, pkg):
        rows = rw_roundtrip(pkg, [([("__name__", "m")], [(0, 1.0)])], 4242)
        assert rows == [(b"m", 4242, 1.0)]

    def test_value_escaping_roundtrips(self, pkg):
        labels = [("__name__", "m"), ("p", 'a\\b"c\nd,e=f')]
        rows = rw_roundtrip(pkg, [(labels, [(T0, 1.0)])])
        assert pkg.parsers.labels_from_series_key(rows[0][0]) == labels

    def test_weird_label_name_falls_back(self, pkg):
        raw = pkg.remote_write.build_write_request(
            [([("__name__", "m"), ("bad label", "v")], [(T0, 1.0)])],
            compress="")
        assert pkg.native.parse_rw_columnar(raw, T0) is None

    def test_missing_name_falls_back(self, pkg):
        raw = pkg.remote_write.build_write_request(
            [([("job", "api")], [(T0, 1.0)])], compress="")
        assert pkg.native.parse_rw_columnar(raw, T0) is None

    def test_nan_inf_values(self, pkg):
        rows = rw_roundtrip(pkg, [([("__name__", "m")],
                                   [(T0, float("inf")),
                                    (T0 + 1, float("nan"))])])
        assert rows[0][2] == float("inf") and np.isnan(rows[1][2])


INFLUX_CASES = [
    b"cpu,host=h1 usage=1.5 1753700000000000000",
    b"cpu value=7",
    b"cpu,host=h1,region=r usage=1,idle=99i,frac=2.5,flag=t,off=F",
    b"m field=1u\nm2 value=-3.25e2 1753700000123000000",
    b"m,t=a\\,b\\ c,u=q\\=r v=1",
    b"drop msg=\"a string\",ok=2",
    b"tagless value=0.5\n# comment\n\nweird,empty=,k=v f=1",
    b"neg v=1 -1753700000000000001",
]


class TestInfluxParse:
    @pytest.mark.parametrize("body", INFLUX_CASES)
    def test_matches_python(self, pkg, body):
        cr = pkg.native.parse_influx_columnar(body, "db0", T0)
        assert cr is not None
        rows = cr.to_rows()
        py = list(pkg.parsers.parse_influx(body.decode(), T0, db="db0"))
        assert len(rows) == len(py)
        for (key, ts, val), prow in zip(rows, py):
            assert dict(pkg.parsers.labels_from_series_key(key)) \
                == dict(prow.labels)
            assert ts == prow.timestamp
            assert val == prow.value

    def test_no_db(self, pkg):
        rows = pkg.native.parse_influx_columnar(b"cpu usage=1", "",
                                                T0).to_rows()
        assert rows == [(b"cpu_usage", T0, 1.0)]

    def test_metachar_measurement_falls_back(self, pkg):
        # a measurement with ',' cannot round-trip through a text series
        # key: the native parser must defer to the Python path
        assert pkg.native.parse_influx_columnar(
            b"esc\\,aped v=1", "", T0) is None

    def test_float_ts_falls_back(self, pkg):
        # Python int() raises on float timestamps; native must defer, not
        # silently diverge
        assert pkg.native.parse_influx_columnar(b"cpu v=1 1.5e18", "",
                                                T0) is None


class TestKeyMap:
    def test_ids_first_occurrence_order(self, pkg):
        km = pkg.native.KeyMap()
        base = b"aaabbbcccaaa"
        off = np.array([0, 3, 6, 9], np.int64)
        ln = np.array([3, 3, 3, 3], np.int64)
        ids, new = km.resolve(base, off, ln)
        assert list(ids) == [0, 1, 2, 0] and new == 3
        ids2, new2 = km.resolve(base, off, ln)
        assert list(ids2) == [0, 1, 2, 0] and new2 == 0 and len(km) == 3
        km.close()

    def test_growth(self, pkg):
        km = pkg.native.KeyMap()
        keys = b"".join(b"key%07d" % i for i in range(50_000))
        off = np.arange(50_000, dtype=np.int64) * 10
        ln = np.full(50_000, 10, np.int64)
        ids, new = km.resolve(keys, off, ln)
        assert new == 50_000 and list(ids[:3]) == [0, 1, 2]
        ids2, new2 = km.resolve(keys, off, ln)
        assert new2 == 0 and (ids2 == ids).all()
        km.close()


# -- storage columnar path --------------------------------------------------

def fetch_all(pkg, st, name, lo=T0 - 10 ** 9, hi=T0 + 10 ** 9, tenant=(0, 0)):
    out = {}
    for sd in st.search_series(pkg.filters_from_dict({"__name__": name}), lo,
                               hi, tenant=tenant):
        key = tuple(sorted([(b"__name__", sd.metric_name.metric_group)]
                           + list(sd.metric_name.labels)))
        out[key] = (list(sd.timestamps), [round(v, 10) for v in sd.values])
    return out


def prom_body(n=200, it=0):
    return ("\n".join(
        f'cm{{idx="{i}",job="j{i % 5}"}} {i + it}.5 {T0 + it * 1000}'
        for i in range(n))).encode()


class TestAddRowsColumnar:
    def test_matches_add_rows(self, pkg, tmp_path):
        st_a = pkg.Storage(str(tmp_path / "a"))
        st_b = pkg.Storage(str(tmp_path / "b"))
        try:
            for it in range(3):
                body = prom_body(it=it)
                cr = pkg.native.parse_prom_columnar(body, T0)
                assert cr is not None
                n_a = st_a.add_rows_columnar(cr)
                rows = [(dict(pkg.parsers.labels_from_series_key(k)), ts, v)
                        for k, ts, v in cr.to_rows()]
                n_b = st_b.add_rows(rows)
                assert n_a == n_b == 200
            res_a = fetch_all(pkg, st_a, "cm")
            assert len(res_a) == 200
            assert res_a == fetch_all(pkg, st_b, "cm")
        finally:
            st_a.close()
            st_b.close()

    def test_mixed_tuple_and_columnar(self, pkg, tmp_path):
        # both paths interleaved into ONE storage: flush must merge
        # PendingChunks and tuple rows into correctly sorted parts
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            cr = pkg.native.parse_prom_columnar(prom_body(50, 0), T0)
            st.add_rows_columnar(cr)
            rows = [({"__name__": "cm", "idx": str(i), "job": f"j{i % 5}"},
                     T0 + 1000, float(i)) for i in range(50)]
            st.add_rows(rows)
            st.add_rows_columnar(pkg.native.parse_prom_columnar(
                prom_body(50, 2), T0))
            st.table.flush_to_disk()
            res = fetch_all(pkg, st, "cm")
            assert len(res) == 50
            key = tuple(sorted([(b"__name__", b"cm"), (b"idx", b"7"),
                                (b"job", b"j2")]))
            ts, vals = res[key]
            assert ts == [T0, T0 + 1000, T0 + 2000]
            assert vals == [7.5, 7.0, 9.5]
        finally:
            st.close()

    def test_transform_relabel_caches_per_series(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        calls = []

        def transform(labels):
            calls.append(1)
            d = dict(labels)
            if d.get("idx") == "1":
                return None  # dropped
            d["extra"] = "yes"
            return list(d.items())

        try:
            body = prom_body(4)
            stats = {}
            n = st.add_rows_columnar(pkg.native.parse_prom_columnar(body, T0),
                                     transform=transform, drop_stats=stats)
            assert n == 3 and stats == {"transform": 1}
            n_calls = len(calls)
            assert n_calls == 4  # once per new series
            # repeat batch: verdicts cached, transform never re-runs
            stats2 = {}
            n2 = st.add_rows_columnar(
                pkg.native.parse_prom_columnar(prom_body(4, 1), T0),
                transform=transform, drop_stats=stats2)
            assert n2 == 3 and len(calls) == n_calls
            assert stats2 == {"transform": 1}
            res = fetch_all(pkg, st, "cm")
            assert len(res) == 3
            assert all(dict(k)[b"extra"] == b"yes" for k in res)
            # reset invalidates the cached verdicts
            st.reset_columnar_spaces()
            st.add_rows_columnar(
                pkg.native.parse_prom_columnar(prom_body(4, 2), T0),
                transform=transform)
            assert len(calls) == n_calls + 4
        finally:
            st.close()

    def test_malformed_key_skips_row_keeps_batch(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            body = b'good{a="1"} 1 ' + str(T0).encode() + \
                b'\nbad{a="unterminated 2\ngood2 3 ' + str(T0).encode()
            cr = pkg.native.parse_prom_columnar(body, T0)
            # native text parser already drops the unterminated line
            n = st.add_rows_columnar(cr)
            assert n == 2
        finally:
            st.close()

    def test_day_rollover_creates_per_day_indexes(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            day0 = (T0 // 86_400_000) * 86_400_000
            body = (f'dm{{i="0"}} 1 {day0}\n'
                    f'dm{{i="0"}} 2 {day0 + 86_400_000}\n').encode()
            st.add_rows_columnar(pkg.native.parse_prom_columnar(body, T0))
            st.table.flush_pending()
            # per-day postings: search restricted to each day finds it
            for d in (day0, day0 + 86_400_000):
                res = st.search_series(
                    pkg.filters_from_dict({"__name__": "dm"}), d,
                    d + 3_600_000)
                assert len(res) == 1
        finally:
            st.close()

    def test_month_straddle_routes_partitions(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            jul = 1_753_900_000_000   # 2025-07-30
            aug = 1_754_100_000_000   # 2025-08-02
            body = (f'mm{{i="0"}} 1 {jul}\nmm{{i="0"}} 2 {aug}\n').encode()
            st.add_rows_columnar(pkg.native.parse_prom_columnar(body, jul))
            st.table.flush_to_disk()
            assert len(st.table.partitions_for_range(jul, aug)) == 2
            res = fetch_all(pkg, st, "mm", jul - 1, aug + 1)
            assert list(res.values())[0][0] == [jul, aug]
        finally:
            st.close()

    def test_cardinality_limiter_applies(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"), max_hourly_series=3)
        try:
            stats = {}
            st.add_rows_columnar(
                pkg.native.parse_prom_columnar(prom_body(10), T0),
                drop_stats=stats)
            st.table.flush_pending()
            res = fetch_all(pkg, st, "cm")
            assert len(res) <= 3
        finally:
            st.close()

    def test_cardinality_rejection_is_retried(self, pkg, tmp_path):
        # a series rejected under limiter pressure must be re-judged per
        # batch (limiter windows rotate) — the drop verdict is not sticky
        st = pkg.Storage(str(tmp_path / "s"), max_hourly_series=3)
        try:
            st.add_rows_columnar(pkg.native.parse_prom_columnar(
                prom_body(10), T0))
            st.table.flush_pending()
            admitted0 = len(fetch_all(pkg, st, "cm"))
            assert admitted0 <= 3
            # rotate the hourly window, then resend: previously rejected
            # series must be admitted now
            st.hourly_limiter._bucket = -1  # force window rotation
            st.add_rows_columnar(pkg.native.parse_prom_columnar(
                prom_body(10, 1), T0))
            st.table.flush_pending()
            assert len(fetch_all(pkg, st, "cm")) > admitted0
        finally:
            st.close()

    def test_space_reset_bounds_memory(self, pkg, tmp_path, monkeypatch):
        st = pkg.Storage(str(tmp_path / "s"))
        monkeypatch.setattr(pkg.ColumnarSpace, "MAX_KEYS", 8)
        try:
            for it in range(4):
                st.add_rows_columnar(pkg.native.parse_prom_columnar(
                    prom_body(6, it), T0))
            sp = st._cspaces[(0, 0)]
            assert len(sp.keymap) <= 8 + 6  # reset happened at least once
            st.table.flush_pending()
            # data survived the resets
            assert len(fetch_all(pkg, st, "cm")) == 6
        finally:
            st.close()

    def test_tenant_isolation(self, pkg, tmp_path):
        st = pkg.Storage(str(tmp_path / "s"))
        try:
            st.add_rows_columnar(pkg.native.parse_prom_columnar(
                b"tm 1 " + str(T0).encode(), T0), tenant=(1, 2))
            st.add_rows_columnar(pkg.native.parse_prom_columnar(
                b"tm 9 " + str(T0).encode(), T0), tenant=(3, 4))
            st.table.flush_pending()
            a = fetch_all(pkg, st, "tm", tenant=(1, 2))
            b = fetch_all(pkg, st, "tm", tenant=(3, 4))
            assert list(a.values()) == [([T0], [1.0])]
            assert list(b.values()) == [([T0], [9.0])]
        finally:
            st.close()


# -- HTTP layer -------------------------------------------------------------

@pytest.fixture()
def api(pkg, tmp_path):
    st = pkg.Storage(str(tmp_path / "data"))
    a = pkg.PrometheusAPI(st)
    a.pkg = pkg
    yield a
    st.close()


class FakeReq:
    def __init__(self, body, args=None):
        self.body = body
        self.args = args or {}

    def arg(self, name, default=""):
        return self.args.get(name, default)


class TestHTTPColumnar:
    def test_remote_write_snappy_fast_path(self, api):
        series = [([("__name__", "hm"), ("i", str(i))], [(T0, float(i))])
                  for i in range(8)]
        body = api.pkg.remote_write.build_write_request(series,
                                                        compress="snappy")
        resp = api.h_remote_write(FakeReq(body))
        assert resp.status == 204
        assert api.rows_inserted == 8
        api.storage.table.flush_pending()
        assert len(fetch_all(api.pkg, api.storage, "hm")) == 8

    def test_influx_fast_path_matches_slow(self, api):
        body = (f"cpu,host=a usage=1.25,idle=2 {T0 * 1_000_000}\n"
                f"cpu,host=b usage=7 {T0 * 1_000_000}").encode()
        resp = api.h_influx_write(FakeReq(body, {"db": "telegraf"}))
        assert resp.status == 204 and api.rows_inserted == 3
        api.storage.table.flush_pending()
        res = fetch_all(api.pkg, api.storage, "cpu_usage")
        assert len(res) == 2
        assert dict(list(res)[0])[b"db"] == b"telegraf"

    def test_fast_path_composes_with_relabel(self, api, tmp_path):
        api.relabel = api.pkg.parse_relabel_configs(
            "- action: drop\n"
            "  source_labels: [idx]\n"
            "  regex: '1'\n"
            "- action: replace\n"
            "  target_label: dc\n"
            "  replacement: eu\n")
        req = FakeReq(prom_body(4))
        assert api.h_import_prometheus(req).status == 204
        assert api.rows_inserted == 3
        assert api.rows_relabel_dropped == 1
        # repeat: cached verdicts, counters still advance per row
        assert api.h_import_prometheus(FakeReq(prom_body(4, 1))).status == 204
        assert api.rows_inserted == 6
        assert api.rows_relabel_dropped == 2
        api.storage.table.flush_pending()
        res = fetch_all(api.pkg, api.storage, "cm")
        assert len(res) == 3
        assert all(dict(k)[b"dc"] == b"eu" for k in res)

    def test_relabel_reload_resets_cache(self, api):
        assert api.h_import_prometheus(FakeReq(prom_body(4))).status == 204
        assert api.rows_inserted == 4
        api.relabel = api.pkg.parse_relabel_configs(
            "- action: drop\n  source_labels: [idx]\n  regex: '.*'\n")
        assert api.h_import_prometheus(
            FakeReq(prom_body(4, 1))).status == 204
        assert api.rows_inserted == 4  # everything dropped post-reload

    def test_series_limits_compose(self, api):
        api.series_limits = api.pkg.SeriesLimits(max_labels_per_series=1)
        assert api.h_import_prometheus(FakeReq(prom_body(3))).status == 204
        assert api.rows_inserted == 0  # cm has 2 labels + name
        assert api.h_import_prometheus(
            FakeReq(b"solo 1 " + str(T0).encode())).status == 204
        assert api.rows_inserted == 1


# -- the port against the reference on the same bytes -----------------------

def same_batch(what, got, want):
    """Two ColumnarRows (or two fallbacks): keybuf, offsets, lengths,
    timestamps and values bit for bit."""
    if want is None:
        assert got is None, what
        return
    assert got is not None, what
    assert bytes(got.keybuf) == bytes(want.keybuf), what
    for f in ("key_off", "key_len", "tss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{what} {f}")
    assert got.key_off.dtype == want.key_off.dtype == np.int64, what
    np.testing.assert_array_equal(got.values.view(np.int64),
                                  want.values.view(np.int64),
                                  err_msg=f"{what} values")


def same_rows(what, got, want):
    """Two lists of (key, timestamp, value) rows: keys and timestamps
    equal, values bit for bit (NaN included)."""
    assert [r[:2] for r in got] == [r[:2] for r in want], what
    np.testing.assert_array_equal(
        np.array([r[2] for r in got], np.float64).view(np.int64),
        np.array([r[2] for r in want], np.float64).view(np.int64),
        err_msg=what)


def _seeded_series(seed, n_series=40, n=12):
    """Label sets with escapes and odd values, timestamps and values made
    from a numpy seed (NaN, infinities and zero timestamps among them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        labels = [("__name__", f"m{i % 3}"), ("inst", f"h{i % 7}"),
                  ("p", ["plain", 'q"uote', "back\\slash", "new\nline",
                         "c,o=m ma", ""][i % 6]), ("i", str(i))]
        labels = [(k, v) for k, v in labels if v]
        ts = (1_753_700_000_000 + np.cumsum(rng.integers(1, 30_000, n))
              ).tolist()
        if i % 11 == 0:
            ts[0] = 0
        vals = rng.normal(0, 1e6, n)
        vals[rng.integers(0, n)] = [np.nan, np.inf, -np.inf, -0.0][i % 4]
        out.append((labels, list(zip(ts, vals.tolist()))))
    return out


RW_CASES = {
    "seeded": _seeded_series(3),
    "one_sample": [([("__name__", "m")], [(0, 1.0)])],
    "bad_label_name": [([("__name__", "m"), ("bad label", "v")],
                        [(T0, 1.0)])],
    "no_name": [([("job", "api")], [(T0, 1.0)])],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(RW_CASES))
def test_remote_write_batches_equal(case):
    series = RW_CASES[case]
    raw = REF.remote_write.build_write_request(series, compress="")
    assert raw == PORT.remote_write.build_write_request(series, compress="")
    same_batch(case, PORT.native.parse_rw_columnar(raw, 4242),
               REF.native.parse_rw_columnar(raw, 4242))
    packed = REF.remote_write.build_write_request(series, compress="snappy")
    assert PORT.native.snappy_uncompress(packed) == \
        REF.native.snappy_uncompress(packed) == raw
    same_batch(f"{case} garbage", PORT.native.parse_rw_columnar(
        raw[:len(raw) // 2] + b"\xff\xff", 1),
        REF.native.parse_rw_columnar(raw[:len(raw) // 2] + b"\xff\xff", 1))


def _prom_text(seed):
    rng = np.random.default_rng(seed)
    lines = ["# HELP m a counter", "# TYPE m counter"]
    for i in range(60):
        v = float(rng.normal(0, 1e3))
        ts = f" {1_753_700_000_000 + int(rng.integers(0, 10**7))}" \
            if i % 4 else ""
        lab = f'{{inst="h{i % 5}",p="a\\"b\\\\c",i="{i}"}}' if i % 3 else ""
        val = ["NaN", "+Inf", "-Inf", repr(v)][i % 4] if i % 5 == 0 \
            else repr(v)
        lines.append(f"m{i % 4}{lab} {val}{ts}")
    return "\n".join(lines).encode()


PROM_CASES = {
    "seeded": _prom_text(5),
    "reference_body": prom_body(30, 2),
    "malformed": b'good{a="1"} 1 ' + str(T0).encode() +
    b'\nbad{a="unterminated 2\ngood2 3 ' + str(T0).encode(),
    "zero_ts": b'z{a="1"} 4 0\nz 5\n',
    "blank": b"\n\n# only comments\n",
}


@pytest.mark.parametrize("case", sorted(PROM_CASES))
def test_prometheus_batches_equal(case):
    body = PROM_CASES[case]
    same_batch(case, PORT.native.parse_prom_columnar(body, 777),
               REF.native.parse_prom_columnar(body, 777))
    same_rows(case, PORT.native.parse_prom_raw(body, 777),
              REF.native.parse_prom_raw(body, 777))
    same_rows(case, PORT.parsers.parse_prometheus_fast(body, 777),
              REF.parsers.parse_prometheus_fast(body, 777))


def _influx_lines(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(50):
        tags = f",host=h{i % 6},dc=e\\ u\\,1" if i % 2 else f",host=h{i % 6}"
        fields = (f"used={float(rng.normal(0, 1e5))!r},"
                  f"free={int(rng.integers(0, 9))}i")
        if i % 7 == 0:
            fields += ",up=t,note=\"skip me\""
        ts = f" {1_753_700_000_000_000_000 + int(rng.integers(0, 10**12))}" \
            if i % 3 else ""
        out.append(f"mem{tags} {fields}{ts}")
    return "\n".join(out).encode()


INFLUX_BODIES = {f"case{i}": b for i, b in enumerate(INFLUX_CASES)}
INFLUX_BODIES.update({
    "seeded": _influx_lines(9),
    "metachar_measurement": b"esc\\,aped v=1",
    "float_ts": b"cpu v=1 1.5e18",
})


@pytest.mark.parametrize("case", sorted(INFLUX_BODIES))
@pytest.mark.parametrize("db", ["", "telegraf"])
def test_influx_batches_equal(case, db):
    body = INFLUX_BODIES[case]
    same_batch(case, PORT.native.parse_influx_columnar(body, db, T0),
               REF.native.parse_influx_columnar(body, db, T0))


def test_keymaps_assign_the_same_ids():
    rng = np.random.default_rng(1)
    keys = [b"k%d" % int(x) for x in rng.integers(0, 500, 3000)]
    base = b"".join(keys)
    ln = np.array([len(k) for k in keys], np.int64)
    off = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int64)
    got, want = PORT.native.KeyMap(), REF.native.KeyMap()
    for lo in range(0, 3000, 700):
        g = got.resolve(base, off[lo:lo + 700], ln[lo:lo + 700])
        w = want.resolve(base, off[lo:lo + 700], ln[lo:lo + 700])
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
    assert len(got) == len(want)
    got.close()
    want.close()


DAY = 86_400_000


def _scrape_batches(seed, n_series=64, scrapes=30, per_call=10):
    """Prometheus text bodies of `per_call` whole scrapes each, anchored a
    day before the wall clock (inside the stores' retention)."""
    rng = np.random.default_rng(seed)
    t0 = (int(time.time() * 1000) - DAY) // 60_000 * 60_000
    ts = t0 + np.arange(scrapes)[None, :] * 15_000 + \
        rng.integers(-2000, 2001, (n_series, scrapes))
    vals = np.cumsum(rng.integers(0, 50, (n_series, scrapes)), axis=1) * 1.5
    vals[3, 5] = np.nan
    bodies = []
    for j0 in range(0, scrapes, per_call):
        bodies.append("".join(
            f'sc_m{{instance="h{i % 8}",id="{i}"}} {float(vals[i, j])!r} '
            f'{ts[i, j]}\n'
            for j in range(j0, j0 + per_call)
            for i in range(n_series)).encode())
    return bodies, t0


def _columns(pkg, st, t0):
    return st.search_columns(pkg.filters_from_dict({"__name__": "sc_m"}),
                             t0 - DAY, t0 + DAY)


def test_stores_written_columnar_and_by_rows_are_equal(tmp_path):
    bodies, t0 = _scrape_batches(11)
    port_c = PORT.Storage(str(tmp_path / "port_columnar"))
    ref_c = REF.Storage(str(tmp_path / "ref_columnar"))
    port_r = PORT.Storage(str(tmp_path / "port_rows"))
    try:
        for body in bodies:
            cr = PORT.native.parse_prom_columnar(body, 1)
            same_batch("scrape", cr, REF.native.parse_prom_columnar(body, 1))
            assert port_c.add_rows_columnar(cr) == len(cr)
            assert ref_c.add_rows_columnar(
                REF.native.parse_prom_columnar(body, 1)) == len(cr)
            rows = [(dict(PORT.parsers.labels_from_series_key(k)), t, v)
                    for k, t, v in cr.to_rows()]
            assert port_r.add_rows(rows) == len(rows)
        assert len(port_c._cspaces[(0, 0)].keymap) == 64
        # across a flush to disk as well as from the in-memory parts
        for flush in (False, True):
            if flush:
                for st in (port_c, ref_c, port_r):
                    st.table.flush_to_disk()
            got = _columns(PORT, port_c, t0)
            assert len(got.raw_names) == 64
            for other in (_columns(REF, ref_c, t0),
                          _columns(PORT, port_r, t0)):
                assert got.raw_names == other.raw_names
                np.testing.assert_array_equal(got.counts, other.counts)
                np.testing.assert_array_equal(got.ts, other.ts)
                np.testing.assert_array_equal(got.vals.view(np.int64),
                                              other.vals.view(np.int64))
    finally:
        for st in (port_c, ref_c, port_r):
            st.close()
