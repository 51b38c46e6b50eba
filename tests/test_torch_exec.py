"""The port's executor on the host path (victoriametrics_tpu_torch/query/
exec.py and eval.py, ``EvalConfig(tpu=None)``) against the JAX package's.

Every case of the reference's ``tests/test_query_engine.py`` runs through
the port's ``exec_query`` / ``exec_instant`` on a port ``Storage`` and
through the reference's on a reference ``Storage``, both fed the same
rows: the same series in the same order (compared by marshalled metric
name, never by metric id: ids are clock-seeded) and the same values.  The
host path is the same numpy code on both sides, so the values are held
bit for bit (NaN equal to NaN).  The data is the reference test's, moved
to two days before the wall clock (the reference's July-2025 anchor lies
outside the default 13-month retention by now), at the reference's phase
against the minute.

The error and limit cases raise the same exception class with the same
message on both sides; the rollup result cache hits on a repeated
evaluation on both sides.

The helpers ``Pair``, ``same_rows`` and ``close_rows`` are shared with the
other evaluator tests (``tests/test_torch_eval_device.py``,
``tests/test_torch_golden_corpus.py``, ``tests/test_torch_fleet.py``)."""

import time

import numpy as np
import pytest

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.query import exec as ref_exec
from victoriametrics_tpu.query import limits as ref_limits
from victoriametrics_tpu.query import rollup_result_cache as ref_rrc
from victoriametrics_tpu.query import types as ref_types
from victoriametrics_tpu.query.eval import QueryError as RefQueryError
from victoriametrics_tpu.storage import storage as ref_storage
from victoriametrics_tpu_torch.query import exec as port_exec
from victoriametrics_tpu_torch.query import limits as port_limits
from victoriametrics_tpu_torch.query import rollup_result_cache as port_rrc
from victoriametrics_tpu_torch.query import types as port_types
from victoriametrics_tpu_torch.query.eval import QueryError
from victoriametrics_tpu_torch.storage import storage as port_storage

DAY = 86_400_000
STEP = 60_000
# two days back, at the reference test's phase against the minute
# (its T0 = 1_753_700_000_000 is 20 s past a minute)
T0 = (int(time.time() * 1000) - 2 * DAY) // STEP * STEP + \
    1_753_700_000_000 % STEP
END = T0 + 20 * STEP


class Pair:
    """The same rows in a port and a reference Storage, with EvalConfigs
    for each side."""

    def __init__(self, path, rows=(), flush=True):
        self.ref = ref_storage.Storage(str(path / "ref"))
        try:
            self.port = port_storage.Storage(str(path / "port"))
        except BaseException:
            self.ref.close()
            raise
        if rows:
            self.add(rows, flush)

    def add(self, rows, flush=True):
        rows = list(rows)
        for st in (self.ref, self.port):
            for a in range(0, len(rows), 4096):
                st.add_rows(rows[a:a + 4096])
            if flush:
                st.force_flush()

    def close(self):
        self.ref.close()
        self.port.close()

    def ecs(self, **kw):
        """(port EvalConfig, reference EvalConfig) over the two stores;
        `port_tpu` / `ref_tpu` set each side's engine."""
        port_tpu = kw.pop("port_tpu", None)
        ref_tpu = kw.pop("ref_tpu", None)
        kw.setdefault("step", STEP)
        return (port_types.EvalConfig(storage=self.port, tpu=port_tpu, **kw),
                ref_types.EvalConfig(storage=self.ref, tpu=ref_tpu, **kw))


def named(rows):
    """[(marshalled metric name, values)] in the result's order."""
    return [(bytes(ts.metric_name.marshal()), np.asarray(ts.values))
            for ts in rows]


def same_rows(got, want, ctx=""):
    """The same series in the same order and the same values, bit for bit
    (NaN equal to NaN)."""
    g, w = named(got), named(want)
    assert [k for k, _ in g] == [k for k, _ in w], ctx
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (ctx, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {k!r}")


def close_rows(got, want, ctx="", rtol=1e-12, atol=0.0):
    """The same series in the same order, values at rtol (NaN where the
    other side has NaN)."""
    g, w = named(got), named(want)
    assert [k for k, _ in g] == [k for k, _ in w], ctx
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (ctx, k)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f"{ctx} {k!r}")


def _engine_rows():
    """The reference test's store: three counters, two gauges, histogram
    buckets, 121 scrapes at 15 s from ten minutes before T0."""
    rows = []
    for j in range(121):
        ts = T0 - 600_000 + j * 15_000
        rows.append(({"__name__": "http_requests_total", "job": "api",
                      "instance": "h1"}, ts, 150.0 * j))
        rows.append(({"__name__": "http_requests_total", "job": "api",
                      "instance": "h2"}, ts, 300.0 * j))
        rows.append(({"__name__": "http_requests_total", "job": "web",
                      "instance": "h3"}, ts, 600.0 * j))
    for j in range(121):
        ts = T0 - 600_000 + j * 15_000
        rows.append(({"__name__": "mem_bytes", "instance": "h1"}, ts,
                     float(100 + (j % 10))))
        rows.append(({"__name__": "mem_bytes", "instance": "h2"}, ts,
                     float(200 + (j % 5))))
    for j in range(121):
        ts = T0 - 600_000 + j * 15_000
        for le, frac in (("0.1", 0.6), ("1", 0.9), ("+Inf", 1.0)):
            rows.append(({"__name__": "latency_bucket", "le": le},
                         ts, 100.0 * j * frac))
    return rows


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("torch_exec"), _engine_rows())
    yield p
    p.close()


# every range query of tests/test_query_engine.py, in its order
RANGE_CASES = [
    "mem_bytes",
    'http_requests_total{job="api"}',
    '{__name__=~"http_.*", instance=~"h1|h3"}',
    "nope_metric",
    "rate(http_requests_total[5m])",
    "increase(http_requests_total[5m])",
    "avg_over_time(mem_bytes[5m])",
    "count_over_time(mem_bytes[1m])",
    "http_requests_total offset 5m",
    "http_requests_total",
    "quantile_over_time(1, mem_bytes[5m])",
    "max_over_time(rate(http_requests_total[5m])[10m:1m])",
    "mem_bytes @ AT",
    'predict_linear(http_requests_total{instance="h1"}[5m], 60)',
    "sum by (job) (rate(http_requests_total[5m]))",
    "sum without (instance) (rate(http_requests_total[5m]))",
    "sum(rate(http_requests_total[5m]))",
    "avg(mem_bytes)",
    "count(mem_bytes)",
    "min(mem_bytes)",
    "max(mem_bytes)",
    "topk(1, rate(http_requests_total[5m]))",
    "topk_avg(2, rate(http_requests_total[5m]))",
    "quantile(0.5, rate(http_requests_total[5m]))",
    "sum(rate(http_requests_total[5m])) by (instance) limit 2",
    "mem_bytes * 2",
    "mem_bytes > 150",
    "mem_bytes > bool 150",
    "rate(http_requests_total[5m]) / on(instance) mem_bytes",
    'rate(http_requests_total{instance=~"h1|h2"}[5m]) / on(instance) '
    'mem_bytes',
    'mem_bytes and on(instance) http_requests_total{instance="h1"}',
    'mem_bytes unless on(instance) http_requests_total{instance="h1"}',
    'mem_bytes{instance="h1"} or mem_bytes{instance="h2"}',
    "nope_metric default 7",
    "(mem_bytes > 150) default 0",
    "2 + 3 * 4",
    "5m / 60",
    "rate(http_requests_total[5m]) * on(instance) group_left() "
    "(mem_bytes / mem_bytes)",
    "abs(-1 * mem_bytes)",
    "histogram_quantile(0.5, rate(latency_bucket[5m]))",
    "histogram_quantile(0.99, rate(latency_bucket[5m]))",
    'label_set(mem_bytes, "dc", "eu")',
    'label_del(mem_bytes, "instance")',
    'label_replace(mem_bytes, "host", "$1", "instance", "(h\\\\d+)")',
    'label_join(mem_bytes, "ij", "-", "instance", "instance")',
    "absent(nope_metric)",
    "absent(mem_bytes)",
    "clamp(mem_bytes, 150, 202)",
    "time()",
    "timestamp(mem_bytes)",
    "vector(scalar(sum(mem_bytes)))",
    "sort_desc(mem_bytes)",
    "running_max(mem_bytes)",
    "interpolate(mem_bytes)",
    "round(mem_bytes, 100)",
    "union(mem_bytes, rate(http_requests_total[5m]))",
    "hour()",
    'mem_bytes{instance="h1"} / ignoring(instance) mem_bytes{instance="h1"}',
    "mem_bytes / on(instance) mem_bytes",
]


@pytest.mark.parametrize("q", RANGE_CASES)
def test_range_query_matches_reference(pair, q):
    q = q.replace("AT", str((T0 + 5 * STEP) // 1000))
    ec_p, ec_r = pair.ecs(start=T0, end=END)
    got = port_exec.exec_query(ec_p, q)
    want = ref_exec.exec_query(ec_r, q)
    same_rows(got, want, q)
    # the port's own answer to a second evaluation (a rollup result cache
    # hit for the cacheable shapes) is the same
    same_rows(port_exec.exec_query(pair.ecs(start=T0, end=END)[0], q), got,
              q + " (repeat)")


@pytest.mark.parametrize("q, offset", [
    ('count_values("v", floor(mem_bytes/100))', 10 * STEP),
    ("sum(mem_bytes)", 5 * STEP),
])
def test_instant_query_matches_reference(pair, q, offset):
    # the instant as an offset from T0: a parameter taken from the wall
    # clock would name the case differently in each test worker
    at = T0 + offset
    ec_p, ec_r = pair.ecs(start=T0, end=END)
    got = port_exec.exec_instant(ec_p, q, at)
    want = ref_exec.exec_instant(ec_r, q, at)
    assert got and all(ts.values.size == 1 for ts in got)
    same_rows(got, want, q)


@pytest.mark.parametrize("q", ["frobnicate(mem_bytes)", "supersum(mem_bytes)"])
def test_unknown_names_raise_as_the_reference(pair, q):
    ec_p, ec_r = pair.ecs(start=T0, end=END)
    with pytest.raises(RefQueryError) as want:
        ref_exec.exec_query(ec_r, q)
    with pytest.raises(QueryError) as got:
        port_exec.exec_query(ec_p, q)
    assert str(got.value) == str(want.value)


@pytest.fixture()
def stale_pair(tmp_path):
    rows = [({"__name__": "ctr"}, T0 - 600_000 + j * 15_000, 10.0 * j)
            for j in range(121)]
    # a staleness marker mid-stream (a target restart)
    rows.append(({"__name__": "ctr"}, T0 + 5 * STEP + 1000,
                 ref_dec.STALE_NAN))
    p = Pair(tmp_path, rows)
    yield p
    p.close()


@pytest.mark.parametrize("q", ["rate(ctr[5m])", "sum_over_time(ctr[5m])",
                               "avg_over_time(ctr[5m])",
                               "stale_samples_over_time(ctr[5m])"])
def test_stale_markers_as_the_reference(stale_pair, q):
    ec_p, ec_r = stale_pair.ecs(start=T0, end=END)
    got = port_exec.exec_query(ec_p, q)
    assert got
    same_rows(got, ref_exec.exec_query(ec_r, q), q)


@pytest.fixture()
def lim_pair(tmp_path):
    rows = [({"__name__": "lm", "i": str(i)}, T0 - 600_000 + j * 15_000,
             float(j)) for i in range(50) for j in range(30)]
    p = Pair(tmp_path, rows, flush=False)
    yield p
    p.close()


@pytest.mark.parametrize("kw, q", [
    ({"max_samples_per_query": 100}, "rate(lm[5m])"),
    ({"max_series": 10}, "rate(lm[5m])"),
    ({"max_memory_per_query": 1000}, "rate(lm[5m])"),
    ({"deadline": -1.0}, "rate(lm[5m])"),
    ({"max_samples_per_query": 2000},
     "rate(lm[5m]) + avg_over_time(lm[5m])"),
    ({"max_samples_per_query": 2500},
     "max_over_time(rate(lm[1m])[5m:30s]) + rate(lm[5m])"),
], ids=["samples", "series", "memory", "deadline", "samples_summed",
        "subquery_shares"])
def test_limits_raise_as_the_reference(lim_pair, kw, q):
    if "deadline" in kw:
        kw = {"deadline": time.monotonic() + kw["deadline"]}
    ec_p, ec_r = lim_pair.ecs(start=T0, end=END, **kw)
    with pytest.raises(ref_limits.QueryLimitError) as want:
        ref_exec.exec_query(ec_r, q)
    with pytest.raises(port_limits.QueryLimitError) as got:
        port_exec.exec_query(ec_p, q)
    assert str(got.value) == str(want.value)


def test_memory_admission_releases(lim_pair):
    lim = port_limits.rollup_memory_limiter()
    before = lim.usage
    ec_p, ec_r = lim_pair.ecs(start=T0, end=END)
    got = port_exec.exec_query(ec_p, "rate(lm[5m])")
    assert lim.usage == before
    same_rows(got, ref_exec.exec_query(ec_r, "rate(lm[5m])"))


def test_fused_decline_does_not_double_count(lim_pair):
    """The device path fetches, declines (min_series) and the host path
    re-fetches: the samples are counted once, so a cap between one and
    two fetches does not trip."""
    from victoriametrics_tpu.query.tpu_engine import TPUEngine
    from victoriametrics_tpu_torch.query.cuda_engine import CUDAEngine
    ec_p, ec_r = lim_pair.ecs(start=T0, end=END, max_samples_per_query=2000,
                              port_tpu=CUDAEngine(device="cpu",
                                                  min_series=1000),
                              ref_tpu=TPUEngine(min_series=1000))
    got = port_exec.exec_query(ec_p, "sum(rate(lm[5m]))")
    assert len(got) == 1
    same_rows(got, ref_exec.exec_query(ec_r, "sum(rate(lm[5m]))"))
    assert ec_p.cost.samples == ec_r.cost.samples


def test_repeated_eval_hits_cache(tmp_path):
    now = int(time.time() * 1000)
    rows = [({"__name__": "erc", "i": str(i)}, now - 3600_000 + j * 60_000,
             float(j)) for i in range(20) for j in range(50)]
    p = Pair(tmp_path / "a", rows, flush=False)
    empty = Pair(tmp_path / "b")
    try:
        start = now - 3000_000
        start -= start % 60_000
        kw = dict(start=start, end=start + 1800_000)
        h0, rh0 = port_rrc.GLOBAL.hits, ref_rrc.GLOBAL.hits
        r1 = port_exec.exec_query(p.ecs(**kw)[0], "avg_over_time(erc[5m])")
        r2 = port_exec.exec_query(p.ecs(**kw)[0], "avg_over_time(erc[5m])")
        assert port_rrc.GLOBAL.hits > h0
        assert len(r1) == 20
        same_rows(r2, r1)
        want = ref_exec.exec_query(p.ecs(**kw)[1], "avg_over_time(erc[5m])")
        ref_exec.exec_query(p.ecs(**kw)[1], "avg_over_time(erc[5m])")
        assert ref_rrc.GLOBAL.hits > rh0
        same_rows(r1, want)
        # sub-expression reuse across different enclosing queries
        r3 = port_exec.exec_query(p.ecs(**kw)[0],
                                  "sum(avg_over_time(erc[5m]))")
        same_rows(r3, ref_exec.exec_query(p.ecs(**kw)[1],
                                          "sum(avg_over_time(erc[5m]))"))
        # stores do not share cache entries
        assert port_exec.exec_query(empty.ecs(**kw)[0],
                                    "avg_over_time(erc[5m])") == []
    finally:
        p.close()
        empty.close()


def test_exec_query_laps_eval_other_and_drops_all_nan(pair):
    """exec_query installs the query's cost tracker for the evaluation
    (the fetch and rollup laps land in it, the rest in eval:other),
    drops series that are NaN at every step, and sorts rows by name
    unless the top-level function orders them."""
    from victoriametrics_tpu_torch.utils import costacc
    assert costacc.current() is None
    ec_p, ec_r = pair.ecs(start=T0, end=END)
    got = port_exec.exec_query(ec_p, "mem_bytes > 205")
    assert costacc.current() is None
    assert got == [] and ref_exec.exec_query(ec_r, "mem_bytes > 205") == []
    split = ec_p.cost.summary()["wallMsByPhase"]
    assert "eval:other" in split and split["eval:other"] >= 0
    desc = port_exec.exec_query(pair.ecs(start=T0, end=END)[0],
                                "sort_desc(mem_bytes)")
    assert [ts.metric_name.get_label(b"instance") for ts in desc] == \
        [b"h2", b"h1"]
