"""The port's query stats (``query/querystats``: ``ActiveQueries``,
``QueryStats``, ``SlowQueryLog``) against the reference's: the same calls
on a pinned clock give the same snapshots, top-N orderings and slow-query
records (with the per-phase split that the flight recorder reassembles
for a query's context), and through both vmsingles the status endpoints
``/api/v1/status/{active_queries,top_queries,slow_queries}`` answer
alike, timings removed."""

import json
import types

import numpy as np
import pytest

from test_torch_httpapi import HttpPair, scrub
from victoriametrics_tpu.query import querystats as ref_qs
from victoriametrics_tpu.utils import flightrec as ref_flightrec
from victoriametrics_tpu_torch.query import querystats as port_qs
from victoriametrics_tpu_torch.utils import flightrec as port_flightrec

CLOCK0 = 1_800_000_000.0


@pytest.fixture()
def clock(monkeypatch):
    """Both modules read one pinned clock (seconds)."""
    now = [CLOCK0]
    fake = types.SimpleNamespace(unix_seconds=lambda: now[0])
    for mod in (ref_qs, port_qs):
        monkeypatch.setattr(mod, "fasttime", fake)
    return now


def both(fn):
    """fn(querystats module) for the reference and the port."""
    return fn(ref_qs), fn(port_qs)


def test_active_queries(clock):
    def run(qs):
        a = qs.ActiveQueries()
        ids = [a.register(f"q{i}", 1000 * i, 1000 * i + 60_000, 15_000)
               for i in range(5)]
        clock[0] += 1.5
        a.unregister(ids[1])
        a.unregister(ids[3])
        a.unregister(12345)
        snap = a.snapshot()
        clock[0] -= 1.5
        return ids, len(a), snap
    want, got = both(run)
    assert got == want and got[1] == 3


def test_query_stats_tops(clock):
    rng = np.random.default_rng(3)
    seq = [(f"sum(rate(m{int(rng.integers(0, 6))}[5m]))",
            float(rng.choice([300, 3600, 86400])),
            float(rng.random()), {"samplesScanned": int(rng.integers(0, 1e6)),
                                  "bytesRead": int(rng.integers(0, 1e7)),
                                  "cpuMs": float(rng.random() * 100),
                                  "deviceBytes": int(rng.integers(0, 1e5)),
                                  "rpcBytes": 0} if rng.random() < 0.7
            else None, float(rng.random() * 400)) for _ in range(300)]

    def run(qs):
        st = qs.QueryStats(max_records=250, max_lifetime_s=300)
        for q, tr, d, cost, dt in seq:
            clock[0] = CLOCK0 + dt
            st.record(q, tr, d, cost=cost)
        clock[0] = CLOCK0 + 420
        out = (st.tops(5), {k: st.top(3, k) for k in
                            ("count", "sumDuration", "avgDuration",
                             "sumCpuMs", "sumSamplesScanned", "nosuch")})
        clock[0] = CLOCK0
        return out
    want, got = both(run)
    assert got == want and got[0]["count"]


@pytest.mark.parametrize("threshold", [None, 0.0, 50.0])
def test_slow_query_log(clock, monkeypatch, threshold):
    monkeypatch.setenv("VM_SLOW_QUERY_MS", "20")

    def run(qs, flightrec):
        log = qs.SlowQueryLog(max_records=4, threshold_ms=threshold)
        ctx = flightrec.new_ctx()
        prev = flightrec.set_ctx(ctx)
        try:
            for name, dur in (("fetch:decode", 0.010), ("serve:refresh",
                                                       0.040),
                              ("pool:task", 0.005), ("eval:rollup", 0.020),
                              ("fetch:decode", 0.003)):
                flightrec.rec(name, 0.0, dur)
        finally:
            flightrec.set_ctx(prev)
        recs = []
        for i, d in enumerate((0.001, 0.030, 0.100, 0.060, 0.2, 0.025)):
            clock[0] = CLOCK0 + i
            recs.append(log.maybe_record(
                f"q{i}", 0, 60_000, 15_000, (i, 1) if i % 2 else None, d,
                ctx=ctx if i in (2, 4) else 0,
                capture_id=7 if i == 4 else None,
                cost={"samplesScanned": i} if i % 3 == 0 else None))
        log.record_rejected("shed", 0, 1, 1, (3, 0), "gate full")
        clock[0] = CLOCK0
        return recs, log.threshold_ms(), log.snapshot()
    want = run(ref_qs, ref_flightrec)
    got = run(port_qs, port_flightrec)
    assert got == want


def test_status_endpoints(tmp_path, monkeypatch):
    """Queries through both vmsingles, then their status endpoints: the
    same active, top and slow-query records (timings removed)."""
    monkeypatch.setenv("VM_SLOW_QUERY_MS", "0.0001")
    from test_torch_httpapi import T0, ingest_everywhere
    p = HttpPair(tmp_path)
    try:
        ingest_everywhere(p)
        t = T0 / 1e3
        for q in ("rw_m", "sum(rate(rw_m[5m]))", "imp_m", "rw_m"):
            p.get("/api/v1/query_range", query=q, start=t, end=t + 600,
                  step="60")
            p.get("/api/v1/query", query=q, time=t + 300)
        p.get("/api/v1/status/active_queries")
        tops = []
        for side in (p.port, p.ref):
            code, body = side.client.get("/api/v1/status/top_queries",
                                         topN="3")
            assert code == 200
            tops.append(json.loads(body))
        g, w = tops
        assert [r["query"] for r in g["topByCount"]][:1] == ["rw_m"]

        def counted(rows):
            return [{k: v for k, v in r.items()
                     if k in ("query", "count", "sumSamplesScanned",
                              "sumBytesRead", "sumRpcBytes")}
                    for r in rows]
        # the orderings by count and by samples are the same; those by
        # time and CPU follow this run's timings, so only their members
        for key in ("topByCount", "topBySumSamplesScanned"):
            assert counted(g[key]) == counted(w[key]), key
        for key in ("topBySumDuration", "topByAvgDuration", "topBySumCpuMs"):
            assert len(g[key]) == len(w[key]) == 3, key
        code, got = p.port.client.get("/api/v1/status/slow_queries")
        _, want = p.ref.client.get("/api/v1/status/slow_queries")
        assert code == 200
        g, w = json.loads(got), json.loads(want)
        assert len(g["data"]) == len(w["data"]) == 8

        def rec(r):
            r = scrub(r)
            for k in ("durationSeconds", "time", "phaseSplitMs",
                      "containerSpansMs", "flightCaptureId"):
                r.pop(k, None)
            r["cost"] = {k: v for k, v in r.get("cost", {}).items()
                         if k in ("samplesScanned", "rowsReturned")}
            return r
        assert [rec(r) for r in g["data"]] == [rec(r) for r in w["data"]]
        assert g["thresholdMs"] == w["thresholdMs"]
    finally:
        p.close()
