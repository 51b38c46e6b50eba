"""The port's storage (victoriametrics_tpu_torch/storage) against the JAX
package's (victoriametrics_tpu/storage) on the CPU: the same seeded rows,
anchored to the wall clock inside the default retention, go through both
``Storage`` classes in two directories, and every read must agree -- rows
in the same order (by marshaled metric name), names, timestamps and value
bits, counts.  Metric ids are seeded from the clock, so they are never
compared.  Each store reads a directory the other wrote.  Every store a
test opens is closed by the ``stores`` fixture, also when the test fails.
"""

import os
import shutil
import time

import numpy as np
import pytest

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.storage import storage as ref_storage
from victoriametrics_tpu.storage import tag_filters as ref_tf
from victoriametrics_tpu_torch.storage import storage as port_storage
from victoriametrics_tpu_torch.storage import tag_filters as port_tf

DAY, HOUR = 86_400_000, 3_600_000
NOW = int(time.time() * 1000)
# a fixed hour two days back: inside the default retention, and every
# sample of the tests lies in the past
T0 = (NOW - 2 * DAY) // HOUR * HOUR
SCRAPE = 15_000
IMPLS = {"ref": (ref_storage, ref_tf), "port": (port_storage, port_tf)}


class Stores:
    """Opens stores of either implementation under one tmp dir and closes
    every one still open at teardown."""

    def __init__(self, root):
        self.root = root
        self.opened = []

    def path(self, name):
        return os.path.join(self.root, name)

    def open(self, impl, name, **kw):
        st = IMPLS[impl][0].Storage(self.path(name), **kw)
        self.opened.append(st)
        return st

    def close(self, st):
        self.opened.remove(st)
        st.close()

    def close_all(self):
        while self.opened:
            self.close(self.opened[-1])


@pytest.fixture
def stores(tmp_path):
    s = Stores(str(tmp_path))
    try:
        yield s
    finally:
        s.close_all()


def filters(impl, spec):
    """filters_from_dict of the implementation's own TagFilter."""
    return IMPLS[impl][1].filters_from_dict(spec)


def seeded_rows(seed=0, S=48, N=60, t0=T0):
    """S series of N jittered 15 s samples: counters of `m_total`, gauges
    of 3-decimal values under `g`, a few full-precision floats, one stale
    marker; labels instance, job and id (ids not zero-padded, so name order
    is not insertion order)."""
    rng = np.random.default_rng(seed)
    ts = t0 + np.arange(N)[None, :] * SCRAPE + \
        rng.integers(-2000, 2001, (S, N))
    cnt = np.cumsum(rng.integers(0, 50, (S, N)), axis=1).astype(np.float64)
    gauge = np.round(rng.uniform(0, 100, (S, N)), 3)
    rows = []
    for j in range(N):
        for i in range(S):
            kind = i % 3
            name = ("m_total", "g", "f")[kind]
            v = (cnt[i, j], gauge[i, j], rng.standard_normal() * 1e3)[kind]
            if kind == 1 and i == 4 and j == N // 2:
                v = ref_dec.STALE_NAN
            labels = {"__name__": name, "instance": f"host-{i % 8}",
                      "job": ("api", "db")[i % 2], "id": str(i)}
            rows.append((labels, int(ts[i, j]), float(v)))
    return rows


def feed(st, rows, per_call=None):
    """Rows through add_rows, whole scrapes per call."""
    per_call = per_call or len(rows)
    for a in range(0, len(rows), per_call):
        st.add_rows(rows[a:a + per_call])


def assert_same_columns(a, b):
    assert a.raw_names == b.raw_names
    assert [m.marshal() for m in a.metric_names] == \
        [m.marshal() for m in b.metric_names]
    assert np.array_equal(a.counts, b.counts)
    assert np.array_equal(a.ts, b.ts)
    assert np.array_equal(a.vals.view(np.int64), b.vals.view(np.int64))
    assert (a.stale_rows is None) == (b.stale_rows is None)
    if a.stale_rows is not None:
        assert np.array_equal(a.stale_rows, b.stale_rows)


def assert_same_series(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.raw_name == y.raw_name
        assert x.metric_name.marshal() == y.metric_name.marshal()
        assert np.array_equal(x.timestamps, y.timestamps)
        assert np.array_equal(x.values.view(np.int64),
                              y.values.view(np.int64))
        assert x.maybe_stale == y.maybe_stale


QUERIES = [
    ({"__name__": "m_total"}, T0, T0 + 60 * SCRAPE),
    ({"__name__": ("=~", "m_total|g")}, T0 + 10 * SCRAPE, T0 + 30 * SCRAPE),
    ({"__name__": "g", "instance": ("!=", "host-1")}, T0, T0 + 60 * SCRAPE),
    ({"job": "db"}, T0 - HOUR, T0 + 5 * SCRAPE),
    ({"__name__": "f", "id": ("=~", "1.*")}, T0, T0 + 60 * SCRAPE),
]


def both_searches(ref, port, queries=QUERIES):
    for spec, lo, hi in queries:
        assert_same_columns(
            ref.search_columns(filters("ref", spec), lo, hi),
            port.search_columns(filters("port", spec), lo, hi))
        assert_same_series(
            ref.search_series(filters("ref", spec), lo, hi),
            port.search_series(filters("port", spec), lo, hi))


@pytest.mark.parametrize("state", ["pending", "flushed", "merged"])
def test_search_matches_reference(stores, state):
    """search_series and search_columns over pending rows, flushed parts
    and merged parts, two batches of rows in each store."""
    rows = seeded_rows()
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    half = len(rows) // 2
    for st in (ref, port):
        feed(st, rows[:half], per_call=48 * 5)
        if state != "pending":
            st.force_flush()
        feed(st, rows[half:], per_call=48 * 5)
        if state == "merged":
            st.force_flush()
            st.force_merge()
    assert port.data_version == ref.data_version == 12
    both_searches(ref, port)
    cols = port.search_columns(filters("port", {"__name__": "m_total"}),
                               T0 - HOUR, T0 + HOUR)
    assert cols.n_series == 16 and int(cols.counts.min()) == 60


@pytest.mark.parametrize("spec", [
    {"__name__": "m_total"},
    {"__name__": ("!=", "g")},
    {"__name__": ("=~", "m_.*")},
    {"__name__": ("!~", "m_.*|f")},
    {"instance": ("=~", "host-[0-3]"), "job": "api"},
    {"id": ("=~", "4.|5")},
])
def test_names_and_labels_match_reference(stores, spec):
    rows = seeded_rows(seed=1)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    for st in (ref, port):
        feed(st, rows)
    lo, hi = T0, T0 + HOUR
    a = ref.search_metric_names(filters("ref", spec), lo, hi)
    b = port.search_metric_names(filters("port", spec), lo, hi)
    assert a and sorted(m.marshal() for m in a) == \
        sorted(m.marshal() for m in b)
    assert ref.label_names() == port.label_names() == \
        ["__name__", "id", "instance", "job"]
    for key in ("__name__", "instance", "job", "id"):
        assert ref.label_values(key) == port.label_values(key)
    assert ref.series_count() == port.series_count() == 48
    assert ref.estimate_series(filters("ref", spec), lo, hi) == \
        port.estimate_series(filters("port", spec), lo, hi)


@pytest.mark.parametrize("flush_first", [False, True])
def test_delete_series_matches_reference(stores, flush_first):
    rows = seeded_rows(seed=2)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    for st in (ref, port):
        feed(st, rows)
        if flush_first:
            st.force_flush()
    spec = {"__name__": "g", "instance": ("=~", "host-[02]")}
    assert ref.delete_series(filters("ref", spec)) == \
        port.delete_series(filters("port", spec)) > 0
    assert port.structural_version == ref.structural_version == 1
    both_searches(ref, port)
    assert port.search_series(filters("port", spec), T0, T0 + HOUR) == []
    for st in (ref, port):
        st.force_merge()
        stores.close(st)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    both_searches(ref, port)
    assert port.search_series(filters("port", spec), T0, T0 + HOUR) == []


def test_retention_matches_reference(stores):
    """Rows older than the retention go at enforce_retention in both, on
    the reference's min_valid_ts."""
    keep = 40 * DAY
    ref = stores.open("ref", "r", retention_ms=keep)
    port = stores.open("port", "p", retention_ms=keep)
    old = [({"__name__": "m", "k": str(i)}, NOW - 100 * DAY + i * SCRAPE,
            float(i)) for i in range(20)]
    new = [({"__name__": "m", "k": str(i)}, T0 + i * SCRAPE, float(i))
           for i in range(20)]
    for st in (ref, port):
        st.add_rows(old)
        st.add_rows(new)
        st.force_flush()
    assert abs(port.min_valid_ts - ref.min_valid_ts) < 60_000
    assert len(port.table.partition_names) == \
        len(ref.table.partition_names) >= 2
    assert port.enforce_retention() == ref.enforce_retention() >= 1
    assert port.structural_version == ref.structural_version
    q = [({"__name__": "m"}, NOW - 200 * DAY, NOW)]
    both_searches(ref, port, q)
    got = port.search_series(filters("port", {"__name__": "m"}),
                             NOW - 200 * DAY, NOW)
    assert sorted(int(s.timestamps[0]) for s in got) == \
        [T0 + i * SCRAPE for i in range(20)]
    assert all(s.timestamps.size == 1 for s in got)
    assert all(s.timestamps.min() >= port.min_valid_ts for s in got)


@pytest.mark.parametrize("interval", [0, 30_000, 60_000])
def test_dedup_interval_matches_reference(stores, interval):
    rows = seeded_rows(seed=3, S=12, N=80)
    ref = stores.open("ref", "r", dedup_interval_ms=interval)
    port = stores.open("port", "p", dedup_interval_ms=interval)
    for st in (ref, port):
        feed(st, rows, per_call=12 * 7)
        st.force_flush()
        feed(st, rows[: 12 * 10])  # exact duplicates of the first scrapes
    both_searches(ref, port)
    if interval:
        a = port.search_columns(filters("port", {"__name__": "m_total"}),
                                T0, T0 + HOUR)
        assert int(a.counts.max()) <= 80 * SCRAPE // interval + 1


def test_reopen_matches_reference(stores):
    rows = seeded_rows(seed=4)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    for st in (ref, port):
        feed(st, rows[: len(rows) // 3])
        st.force_flush()
        feed(st, rows[len(rows) // 3:])
        stores.close(st)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    both_searches(ref, port)
    # the TSID cache survived the restart: repeat rows resolve without
    # the index
    before = port.slow_row_inserts
    port.add_rows(rows[-48:])
    assert port.slow_row_inserts == before and port.new_series_created == 0


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_cross_reading(stores, writer, reader):
    """Each implementation opens a directory the other wrote (parts,
    indexdb, caches, format marker) and reads the same columns; a row
    appended by the reader lands beside the writer's."""
    rows = seeded_rows(seed=5)
    w = stores.open(writer, "w")
    feed(w, rows[: len(rows) // 2], per_call=48 * 3)
    w.force_flush()
    feed(w, rows[len(rows) // 2:], per_call=48 * 3)
    stores.close(w)
    shutil.copytree(stores.path("w"), stores.path("copy"))
    w, r = stores.open(writer, "w"), stores.open(reader, "copy")
    both = {writer: w, reader: r}
    both_searches(both["ref"], both["port"])
    extra = [({"__name__": "m_total", "instance": "host-0", "job": "api",
               "id": "0"}, T0 + 61 * SCRAPE, 1e6)]
    for st in (w, r):
        st.add_rows(extra)
        st.force_flush()
        st.force_merge()
    both_searches(both["ref"], both["port"],
                  [({"__name__": "m_total"}, T0, T0 + HOUR)])
    assert r.new_series_created == 0


def test_append_log_matches_reference(stores):
    """data_version, min_appended_since and the versions the rolling
    path reads move alike in both stores."""
    rows = seeded_rows(seed=6, S=6, N=20)
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    seen = []
    for st in (ref, port):
        feed(st, rows, per_call=6 * 5)
        late = [({"__name__": "m_total", "instance": "host-0", "job": "api",
                  "id": "0"}, T0 + 3 * SCRAPE + 1, 7.0)]
        st.add_rows(late)
        seen.append((st.data_version, st.structural_version,
                     [st.min_appended_since(v) for v in range(6)]))
    assert seen[0] == seen[1]
    assert seen[1][2][4] == T0 + 3 * SCRAPE + 1 and seen[1][2][5] is None
    assert port.last_partial is False and port.dedup_interval_ms == 0


def test_raw_keys_are_left_to_the_ingestion_layer(stores):
    """The ingestion layer has landed: the port's add_rows takes raw
    ``name{labels}`` byte keys (the native text parser's rows) as the
    reference's does, skipping a malformed key and keeping the batch, and
    both have add_rows_columnar."""
    from victoriametrics_tpu_torch.ingest.parsers import \
        series_key_from_labels
    rows = [(series_key_from_labels(sorted(lb.items())), t, v)
            for lb, t, v in seeded_rows(3, S=12, N=8)]
    rows.insert(5, (b'bad{a="unterminated', T0, 1.0))
    ref, port = stores.open("ref", "r"), stores.open("port", "p")
    for st in (ref, port):
        assert st.supports_raw_keys is True
        assert st.supports_columnar is True
        assert callable(st.add_rows_columnar)
    assert port.add_rows(rows) == ref.add_rows(rows) == len(rows) - 1
    for name in ("m_total", "g", "f"):
        assert_same_columns(
            port.search_columns(filters("port", {"__name__": name}),
                                T0 - DAY, T0 + DAY),
            ref.search_columns(filters("ref", {"__name__": name}),
                               T0 - DAY, T0 + DAY))
