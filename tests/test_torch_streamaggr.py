"""Stream aggregation (``ingest/streamaggr.py``): the reference's
``TestStreamAggr`` cases (``tests/test_relabel_streamaggr.py``) and its
three stream-aggregation clock cases (``tests/test_deterministic_time.py``
``TestStreamAggrClock``), each written once as a function of the module
and run on both packages with the reference's own assertions; then every
case's flushed rows from the port equal the reference's (labels,
timestamps, values bit for bit)."""

import numpy as np
import pytest

from victoriametrics_tpu.ingest import streamaggr as ref_sa
from victoriametrics_tpu_torch.ingest import streamaggr as port_sa

T0 = 1_753_700_000_000
BASE = (T0 // 60_000) * 60_000


@pytest.fixture(params=["ref", "port"])
def sa(request):
    return ref_sa if request.param == "ref" else port_sa


def collect():
    rows = []
    return rows, lambda batch: rows.extend(batch)


def sum_and_count_by(sa):
    rows, push = collect()
    a = sa.Aggregator({"interval": "60s", "outputs": ["sum_samples",
                                                      "count_samples"],
                       "by": ["job"]}, push)
    for i in range(10):
        a.push({"__name__": "m", "job": "api", "pod": f"p{i}"},
               T0 + i, float(i))
    a.flush(T0 + 60_000)
    byname = {r[0]["__name__"]: r for r in rows}
    assert byname["m:1m_sum_samples"][2] == 45.0
    assert byname["m:1m_count_samples"][2] == 10.0
    assert byname["m:1m_sum_samples"][0]["job"] == "api"
    assert "pod" not in byname["m:1m_sum_samples"][0]
    return rows


def total_handles_counter_resets(sa):
    rows, push = collect()
    a = sa.Aggregator({"interval": "1m", "outputs": ["total"]}, push)
    for ts, v in [(0, 10), (1, 20), (2, 5), (3, 8)]:  # reset at 5
        a.push({"__name__": "c"}, T0 + ts * 1000, float(v))
    a.flush(T0 + 60_000)
    # initial 10 + 10 + (reset->5) + 3
    assert rows[0][2] == 28.0
    return rows


def quantiles_and_unique(sa):
    rows, push = collect()
    a = sa.Aggregator({"interval": "1m",
                       "outputs": ["quantiles(0.5)", "unique_samples"]},
                      push)
    for v in [1, 2, 2, 3, 100]:
        a.push({"__name__": "m"}, T0, float(v))
    a.flush(T0 + 60_000)
    byname = {(r[0]["__name__"], r[0].get("quantile")): r[2] for r in rows}
    assert byname[("m:1m_quantiles", "0.5")] == 2.0
    assert byname[("m:1m_unique_samples", None)] == 4.0
    return rows


def histogram_bucket(sa):
    rows, push = collect()
    a = sa.Aggregator({"interval": "1m", "outputs": ["histogram_bucket"]},
                      push)
    for v in [0.0005, 0.05, 0.5, 900]:
        a.push({"__name__": "lat"}, T0, v)
    a.flush(T0 + 60_000)
    cum = {r[0]["le"]: r[2] for r in rows}
    assert cum["0.001"] == 1.0 and cum["+Inf"] == 4.0
    return rows


def match_selector(sa):
    rows, push = collect()
    s = sa.StreamAggregators([{"interval": "1m", "outputs": ["last"],
                               "match": '{__name__=~"http_.*"}'}], push)
    assert s.push({"__name__": "http_reqs"}, T0, 1.0)
    assert not s.push({"__name__": "mem"}, T0, 1.0)
    s.stop()
    assert rows[0][0]["__name__"] == "http_reqs:1m_last"
    # the flush stamps the wall clock: keep labels and values
    return [(r[0], 0, r[2]) for r in rows]


def deduplicator(sa):
    rows, push = collect()
    d = sa.Deduplicator(30_000, push)
    d.push({"__name__": "m"}, T0, 1.0)
    d.push({"__name__": "m"}, T0 + 1000, 2.0)
    d.push({"__name__": "m2"}, T0, 5.0)
    d.flush()
    assert sorted((r[0]["__name__"], r[2]) for r in rows) == \
        [("m", 2.0), ("m2", 5.0)]
    return sorted(rows, key=lambda r: r[0]["__name__"])


def bad_config(sa):
    with pytest.raises(ValueError):
        sa.Aggregator({"interval": "1m", "outputs": ["bogus"]}, lambda b: 0)
    with pytest.raises(ValueError):
        sa.Aggregator({"interval": "0s", "outputs": ["last"]}, lambda b: 0)
    return []


def interval_flush_alignment(sa):
    """State resets exactly at each flush: samples land in their own
    interval's output rows, stamped with the flush-time now_ms."""
    out = []
    a = sa.Aggregator({"interval": "60s", "outputs": ["sum_samples"],
                       "by": ["job"]}, out.extend)
    sfx = sa._interval_str(60_000)
    for k in range(3):
        a.push({"__name__": "m", "job": "j"}, BASE + k * 1000, 10.0)
    a.flush(now_ms=BASE + 60_000)
    a.push({"__name__": "m", "job": "j"}, BASE + 61_000, 5.0)
    a.flush(now_ms=BASE + 120_000)
    a.flush(now_ms=BASE + 180_000)  # empty interval: no output
    assert [(r[0]["__name__"], r[1], r[2]) for r in out] == [
        (f"m:{sfx}_sum_samples", BASE + 60_000, 30.0),
        (f"m:{sfx}_sum_samples", BASE + 120_000, 5.0)]
    return out


def total_state_survives_flushes(sa):
    """total is cumulative across intervals (only the delta within each
    interval is new)."""
    out = []
    a = sa.Aggregator({"interval": "60s", "outputs": ["total"]}, out.extend)
    a.push({"__name__": "c", "job": "j"}, BASE + 1000, 5.0)
    a.push({"__name__": "c", "job": "j"}, BASE + 2000, 8.0)
    a.flush(now_ms=BASE + 60_000)
    a.push({"__name__": "c", "job": "j"}, BASE + 61_000, 11.0)
    a.flush(now_ms=BASE + 120_000)
    assert [r[2] for r in out] == [8.0, 11.0]
    return out


def dedup_keeps_last_per_interval(sa):
    rows = []
    d = sa.Deduplicator(30_000, lambda rs: rows.extend(rs))
    d.push({"__name__": "m"}, 1000, 1.0)
    d.push({"__name__": "m"}, 2000, 2.0)
    d.push({"__name__": "m"}, 3000, 3.0)
    d.flush(now_ms=30_000)
    assert [(r[1], r[2]) for r in rows] == [(3000, 3.0)]
    return rows


def seeded_outputs(sa):
    """Every output kind over seeded samples, by and without grouping."""
    rng = np.random.default_rng(4)
    rows, push = collect()
    aggs = [sa.Aggregator({"interval": "1m", "outputs": list(kinds),
                           **grouping}, push)
            for kinds in (("avg", "count_samples", "count_series", "increase",
                           "last", "max", "min", "rate_avg", "rate_sum"),
                          ("stddev", "stdvar", "sum_samples", "total",
                           "total_prometheus", "increase_prometheus",
                           "unique_samples", "quantiles(0.1, 0.5, 0.99)",
                           "histogram_bucket"))
            for grouping in ({"by": ["job"]}, {"without": ["pod"]})]
    vals = np.cumsum(rng.integers(0, 20, (6, 40)), axis=1).astype(float)
    for flush in range(3):
        for j in range(40):
            for i in range(6):
                labels = {"__name__": "req", "job": f"j{i % 2}",
                          "pod": f"p{i}"}
                t = BASE + flush * 60_000 + j * 1000 + i
                for a in aggs:
                    a.push(labels, t, float(vals[i, j] + flush * 1000))
        for a in aggs:
            a.flush(BASE + (flush + 1) * 60_000)
    assert rows
    return rows


CASES = [sum_and_count_by, total_handles_counter_resets,
         quantiles_and_unique, histogram_bucket, match_selector,
         deduplicator, bad_config, interval_flush_alignment,
         total_state_survives_flushes, dedup_keeps_last_per_interval,
         seeded_outputs]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_case(sa, case):
    case(sa)


def _key(labels):
    return tuple(sorted(labels.items()))


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_port_flushes_what_the_reference_flushes(case):
    got, want = case(port_sa), case(ref_sa)
    assert [(_key(lb), t) for lb, t, _ in got] == \
        [(_key(lb), t) for lb, t, _ in want]
    np.testing.assert_array_equal(
        np.array([v for _, _, v in got], np.float64).view(np.int64),
        np.array([v for _, _, v in want], np.float64).view(np.int64))


def test_load_from_text_and_flusher(tmp_path):
    """The YAML entry point both packages' vmsingle call, and the flusher
    thread's final flush at stop."""
    text = ("- match: '{__name__=~\"x_.*\"}'\n  interval: 1m\n"
            "  outputs: [sum_samples, count_series]\n  by: [dc]\n")
    out = {}
    for name, m in (("ref", ref_sa), ("port", port_sa)):
        rows, push = collect()
        s = m.load_from_text(text, push)
        s.start()
        for i in range(5):
            assert s.push({"__name__": "x_m", "dc": "e", "i": str(i)},
                          T0 + i, float(i))
        assert not s.push({"__name__": "y"}, T0, 1.0)
        s.stop(final_flush=True)
        out[name] = sorted((_key(lb), v) for lb, _, v in rows)
        with pytest.raises(ValueError):
            m.load_from_text("interval: 1m\n", push)
    assert out["port"] == out["ref"]
    names = {dict(k)["__name__"]: v for k, v in out["port"]}
    assert names["x_m:1m_sum_samples"] == 10.0 and len(names) == 2
