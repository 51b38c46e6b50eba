"""Materialized streams (``query/matstream``): the reference's
``tests/test_matstream.py``, every case written once and run against
both packages (``pkg`` = the reference or the port), then the port's
counterpart of ``tests/test_device_fleet.py::
test_fleet_single_launch_per_interval`` on its CPU engine, held against
the reference's same sequence.

- ORACLE: frames reassembled by StreamClient are bit-equal to the
  polled ``query_range`` serialization of the same window (and to the
  cold ``disable_cache`` evaluation), per refresh, with live ingest.
- FLEET GUARD: storage reads per interval are O(distinct expressions) —
  ``samples_scanned`` per advance stays FLAT as subscribers go 1 -> 10,
  and one search per interval whatever the subscriber count (through a
  2-node cluster of each package).
- BACKPRESSURE: a slow subscriber's queue is bounded; overflow drops
  the backlog and resyncs from one snapshot.
- DECLINES: partial intervals and evaluation errors are never
  committed; subscribers see them loudly and the next clean advance
  resyncs.
- Shared instants: rules evaluated through the registry's
  ``instant_vector`` (what the reference's vmalert ``EngineDatasource``
  calls) give the rows of the HTTP poll, shared expressions evaluated
  once.  Server-side rules (``-rule``) are hosted by both packages'
  vmsingle, their results written into its store.
"""

import collections
import json
import math
import threading
import time
import types
import urllib.parse
import urllib.request

import numpy as np
import pytest


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu.apps import vmsingle
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.httpapi.server import HTTPServer
        from victoriametrics_tpu.query import matstream
        from victoriametrics_tpu.query import rollup_result_cache as rrc
        from victoriametrics_tpu.query.exec import exec_query
        from victoriametrics_tpu.query.format_value import fmt_value
        from victoriametrics_tpu.query.types import EvalConfig
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import TagFilter
    else:
        from victoriametrics_tpu_torch.apps import vmsingle
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.httpapi.server import HTTPServer
        from victoriametrics_tpu_torch.query import matstream
        from victoriametrics_tpu_torch.query import \
            rollup_result_cache as rrc
        from victoriametrics_tpu_torch.query.exec import exec_query
        from victoriametrics_tpu_torch.query.format_value import fmt_value
        from victoriametrics_tpu_torch.query.types import EvalConfig
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import TagFilter
    return types.SimpleNamespace(
        name=name, vmsingle=vmsingle, PrometheusAPI=PrometheusAPI,
        HTTPServer=HTTPServer, matstream=matstream, rrc=rrc,
        exec_query=exec_query, fmt_value=fmt_value, EvalConfig=EvalConfig,
        Storage=Storage, TagFilter=TagFilter,
        StreamClient=matstream.StreamClient)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _package(request.param)


STEP = 60_000
SCRAPE = 15_000
NS = 8
NN = 240
Q = "sum by (g)(rate(ms_m[2m]))"
DUR = 20 * STEP


def _seed(s, t0: int, n: int = NN):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(NS):
        vals = np.cumsum(rng.integers(0, 30, n)).astype(np.float64)
        rows.extend((({"__name__": "ms_m", "i": str(i), "g": f"g{i % 2}"},
                      t0 + j * SCRAPE, float(vals[j])) for j in range(n)))
    s.add_rows(rows)
    s.force_flush()


def _fresh(s, end: int, r: int):
    s.add_rows([({"__name__": "ms_m", "i": str(i), "g": f"g{i % 2}"},
                 end - STEP + (k + 1) * SCRAPE, float(9_000 + r * 7 + k))
                for i in range(NS) for k in range(4)])


@pytest.fixture()
def store(tmp_path, pkg):
    pkg.rrc.GLOBAL.reset()
    s = pkg.Storage(str(tmp_path / "s"))
    now = int(time.time() * 1000)
    t0 = (now - (NN - 1) * SCRAPE) // STEP * STEP
    _seed(s, t0)
    end0 = t0 + ((NN - 1) * SCRAPE // STEP + 1) * STEP
    yield s, end0
    s.close()


def polled(pkg, storage, q: str, start: int, end: int, step: int) -> list:
    """The oracle: a cold (nocache) evaluation serialized exactly the
    way h_query_range serializes a polled response."""
    ec = pkg.EvalConfig(start=start, end=end, step=step, storage=storage,
                        disable_cache=True)
    rows = pkg.exec_query(ec, q)
    grid = ec.timestamps() / 1e3
    out = []
    for r in rows:
        vals = [[float(t), pkg.fmt_value(v)]
                for t, v in zip(grid, r.values) if not math.isnan(v)]
        if vals:
            out.append({"metric": r.metric_name.to_dict(), "values": vals})
    out.sort(key=lambda e: json.dumps(e["metric"], sort_keys=True))
    return out


class FakeReq:
    def __init__(self, **kw):
        self._kw = {k: str(v) for k, v in kw.items()}

    def arg(self, name, default=""):
        return self._kw.get(name, default)

    def args(self, name):
        v = self._kw.get(name)
        return [v] if v is not None else []


class TestPushPollOracle:
    def test_frames_reassemble_bit_equal_to_poll(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        f = sub.next_frame(timeout_s=1.0, now_ms=end)
        assert f["type"] == "snapshot"
        cli.apply(f)
        assert cli.result() == polled(pkg, s, Q, end - DUR, end, STEP)
        for r in range(4):
            end += STEP
            _fresh(s, end, r)
            f = sub.next_frame(timeout_s=1.0, now_ms=end)
            assert f["type"] == "delta", f
            cli.apply(f)
            assert cli.result() == polled(pkg, s, Q, end - DUR, end, STEP), (
                f"refresh {r}: pushed state diverged from poll")
        sub.close()
        assert api.matstreams.subscriber_count() == 0

    def test_delta_frames_are_suffix_sized(self, pkg, store):
        """A steady rolling refresh's delta must carry O(new columns),
        not the window — the push analog of the suffix guard."""
        s, end = store
        api = pkg.PrometheusAPI(s)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        sub.next_frame(timeout_s=1.0, now_ms=end)
        for r in range(3):
            end += STEP
            _fresh(s, end, r)
            f = sub.next_frame(timeout_s=1.0, now_ms=end)
            assert f["type"] == "delta"
            suffix_cols = (f["endMs"] - f["newStartMs"]) // STEP + 1
            n_cols = (f["endMs"] - f["startMs"]) // STEP + 1
            assert suffix_cols <= max(2, n_cols // 4), (
                f"delta carries {suffix_cols}/{n_cols} columns: "
                "suffix push has regressed to full-window frames")
        sub.close()

    def test_canonical_text_unifies_spellings(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        s1 = api.matstreams.subscribe(Q, STEP, DUR)
        s2 = api.matstreams.subscribe(
            "sum  by  (g) (rate( ms_m[2m] ))", STEP, DUR)
        assert api.matstreams.stream_count() == 1
        assert s1.stream is s2.stream
        s1.close()
        s2.close()


class TestFleetGuard:
    def test_samples_scanned_flat_1_to_10_subscribers(self, pkg, store):
        """THE fleet guard: storage reads per interval must not grow
        with subscriber count."""
        s, end = store
        api = pkg.PrometheusAPI(s)
        subs = [api.matstreams.subscribe(Q, STEP, DUR)]
        subs[0].next_frame(timeout_s=1.0, now_ms=end)
        stream = subs[0].stream
        end += STEP
        _fresh(s, end, 0)
        subs[0].next_frame(timeout_s=1.0, now_ms=end)
        samples_1sub = stream.last_samples_scanned
        evals_1sub = stream.evals
        assert samples_1sub > 0
        # fan out to 10 subscribers; each replays the window cold (no
        # eval), then the next interval costs ONE evaluation
        subs += [api.matstreams.subscribe(Q, STEP, DUR) for _ in range(9)]
        for sb in subs[1:]:
            f = sb.next_frame(timeout_s=1.0, now_ms=end)
            assert f["type"] == "snapshot"
        assert stream.evals == evals_1sub, "cold subscribes re-evaluated"
        end += STEP
        _fresh(s, end, 1)
        frames = []
        for sb in subs:  # first pump advances; the rest drain the fan-out
            frames.append(sb.next_frame(timeout_s=1.0, now_ms=end))
        assert all(f is not None for f in frames)
        assert stream.evals == evals_1sub + 1, (
            "one interval with 10 subscribers must cost exactly one eval")
        assert stream.last_samples_scanned == pytest.approx(
            samples_1sub, rel=0.5), (
            f"samples per interval grew with subscribers: "
            f"{samples_1sub} -> {stream.last_samples_scanned}")
        # every subscriber got the SAME delta
        assert len({json.dumps(f, sort_keys=True) for f in frames}) == 1
        for sb in subs:
            sb.close()

    def test_usage_rows_attribute_shared_fetch_once(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        subs = [api.matstreams.subscribe(Q, STEP, DUR) for _ in range(5)]
        for sb in subs:
            sb.next_frame(timeout_s=1.0, now_ms=end)
        resp = api.h_usage(FakeReq())
        data = json.loads(resp.body)["data"]
        rows = data["matstreams"]
        assert len(rows) == 1
        row = rows[0]
        assert row["subscribers"] == 5
        assert row["evals"] == 1, "shared fetch attributed per subscriber"
        assert row["samplesScanned"] == subs[0].stream.last_samples_scanned
        for sb in subs:
            sb.close()


class TestBackpressure:
    def test_slow_subscriber_bounded_drop_and_resync(self, pkg, store,
                                                     monkeypatch):
        monkeypatch.setenv("VM_MATSTREAM_QUEUE", "2")
        s, end = store
        api = pkg.PrometheusAPI(s)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        stream = sub.stream
        # never read: advance many intervals straight into the queue
        for r in range(7):
            end += STEP
            _fresh(s, end, r)
            assert stream.maybe_advance(end)
        assert sub.q.qsize() <= 2, "subscriber queue grew past the bound"
        assert sub.dropped > 0
        # drain: the resync snapshot catches the client up; state then
        # matches the poll exactly
        cli = pkg.StreamClient()
        saw_resync = False
        while True:
            f = sub.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            saw_resync = saw_resync or bool(f.get("resync"))
            cli.apply(f)
        assert saw_resync, "overflow must deliver a resync snapshot"
        assert cli.result() == polled(pkg, s, Q, end - DUR, end, STEP)
        sub.close()


class _PartialOnce:
    """Storage proxy: reports one partial interval, then clean."""

    def __init__(self, inner):
        self._inner = inner
        self._arm = False
        self._partial = False

    def arm(self):
        self._arm = True

    def reset_partial(self):
        self._partial = self._arm
        self._arm = False
        self._inner.reset_partial()

    @property
    def last_partial(self):
        return self._partial or self._inner.last_partial

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TestDeclines:
    def test_partial_interval_declines_loudly_then_resyncs(self, pkg, store):
        s, end = store
        proxy = _PartialOnce(s)
        api = pkg.PrometheusAPI(proxy)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        cli.apply(sub.next_frame(timeout_s=1.0, now_ms=end))
        committed_end = sub.stream._state.end
        declines0 = sub.stream.declines
        end += STEP
        _fresh(s, end, 0)
        proxy.arm()
        f = sub.next_frame(timeout_s=1.0, now_ms=end)
        assert f["type"] == "snapshot" and f.get("partial") is True
        assert sub.stream.declines == declines0 + 1
        assert sub.stream._state.end == committed_end, (
            "a partial interval must never commit")
        cli.apply(f)  # loudly-served partial view
        assert cli.partial
        # next clean interval resyncs from a snapshot and matches poll
        end += STEP
        _fresh(s, end, 1)
        f = sub.next_frame(timeout_s=1.0, now_ms=end)
        assert f["type"] == "snapshot", "post-decline frame must resync"
        cli.apply(f)
        assert not cli.partial
        assert cli.result() == polled(pkg, s, Q, end - DUR, end, STEP)
        sub.close()

    def test_eval_error_reaches_subscriber_then_recovers(self, pkg, store,
                                                         monkeypatch):
        s, end = store
        api = pkg.PrometheusAPI(s)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        sub.next_frame(timeout_s=1.0, now_ms=end)
        real = api._exec_range_cached

        def boom(ec, q, now_ms):
            raise RuntimeError("storage exploded")
        monkeypatch.setattr(api, "_exec_range_cached", boom)
        end += STEP
        f = sub.next_frame(timeout_s=1.0, now_ms=end)
        assert f["type"] == "error" and "exploded" in f["error"]
        monkeypatch.setattr(api, "_exec_range_cached", real)
        end += STEP
        _fresh(s, end, 0)
        f = sub.next_frame(timeout_s=1.0, now_ms=end)
        assert f["type"] == "snapshot"
        cli = pkg.StreamClient()
        cli.apply(f)
        assert cli.result() == polled(pkg, s, Q, end - DUR, end, STEP)
        sub.close()


class TestDisabled:
    def test_subscribe_raises_and_watch_503(self, pkg, store, monkeypatch):
        monkeypatch.setenv("VM_MATSTREAM", "0")
        s, end = store
        api = pkg.PrometheusAPI(s)
        with pytest.raises(pkg.matstream.MatStreamDisabled):
            api.matstreams.subscribe(Q, STEP, DUR)
        resp = api.h_watch(FakeReq(query=Q, step="1m", range="20m"))
        assert resp.status == 503

    def test_watch_bad_query_422(self, pkg, store):
        s, _ = store
        api = pkg.PrometheusAPI(s)
        resp = api.h_watch(FakeReq(query="sum by ((", step="1m"))
        assert resp.status == 422
        resp = api.h_watch(FakeReq())
        assert resp.status == 422


class TestHTTPWatch:
    def test_sse_stream_bit_equals_polled_query_range(self, pkg, store):
        """End to end over real HTTP: SSE frames -> StreamClient ==
        /api/v1/query_range?nocache=1 on the same window."""
        s, _ = store
        # a 1s step so wall-clock intervals elapse during the test; 1s
        # scrapes so rate[10s] windows hold samples
        now = int(time.time() * 1000)
        t0s = (now - 120_000) // 1000 * 1000
        s.add_rows([({"__name__": "ms_sse", "i": str(i), "g": f"g{i % 2}"},
                     t0s + j * 1000, float(j + 10 * i))
                    for i in range(4) for j in range(121)])
        s.force_flush()
        api = pkg.PrometheusAPI(s)
        srv = pkg.HTTPServer("127.0.0.1", 0)
        api.register(srv)
        srv.start()
        try:
            q = "sum by (g)(rate(ms_sse[10s]))"
            url = (f"http://127.0.0.1:{srv.port}/api/v1/watch?"
                   + urllib.parse.urlencode(
                       {"query": q, "step": "1s", "range": "30s",
                        "max_frames": "3", "heartbeat": "0.5"}))
            cli = pkg.StreamClient()
            frames = []
            with urllib.request.urlopen(url, timeout=30) as r:
                assert r.headers["Content-Type"] == "text/event-stream"
                for raw in r:
                    line = raw.decode().strip()
                    if line.startswith("data: "):
                        f = json.loads(line[len("data: "):])
                        frames.append(f)
                        cli.apply(f)
            assert len(frames) == 3
            assert frames[0]["type"] == "snapshot"
            start_ms, end_ms, _ = cli.window
            poll_url = (f"http://127.0.0.1:{srv.port}/api/v1/query_range?"
                        + urllib.parse.urlencode(
                            {"query": q, "start": start_ms / 1e3,
                             "end": end_ms / 1e3, "step": "1s",
                             "nocache": "1"}))
            with urllib.request.urlopen(poll_url, timeout=30) as r:
                assert r.status == 200
                body = r.read()
            want = json.loads(body)["data"]["result"]
            want.sort(key=lambda e: json.dumps(e["metric"],
                                               sort_keys=True))
            got = cli.result()
            # the polled values went through json float formatting;
            # compare through one json round trip on both sides
            assert json.loads(json.dumps(got)) == \
                json.loads(json.dumps(want))
        finally:
            srv.stop()

    def test_disconnect_before_first_chunk_does_not_leak(self, pkg, store):
        """A client that drops before the SSE generator starts must not
        leak its subscription: a never-started generator's finally
        blocks don't run on close(), so StreamingResponse.on_close is
        the cleanup path the server invokes either way."""
        s, _ = store
        api = pkg.PrometheusAPI(s)
        resp = api.h_watch(FakeReq(query=Q, step="1m", range="20m"))
        assert api.matstreams.subscriber_count() == 1
        assert resp.on_close is not None
        # the server's _send_stream finally: close the (never-started)
        # generator, then on_close
        resp.chunks.close()
        resp.on_close()
        assert api.matstreams.subscriber_count() == 0
        resp.on_close()  # idempotent

    def test_heartbeat_zero_does_not_busy_spin(self, pkg, store):
        """heartbeat=0 must clamp to a real wait, not a hot keepalive
        loop (one-request CPU DoS)."""
        s, _ = store
        api = pkg.PrometheusAPI(s)
        resp = api.h_watch(FakeReq(query=Q, step="1m", range="20m",
                                   heartbeat="0"))
        chunks = resp.chunks
        try:
            first = next(chunks)            # the cold snapshot frame
            assert b"event: frame" in first
            t0 = time.monotonic()
            got = 0
            while got < 2:                  # then idle keepalives
                c = next(chunks)
                if c.startswith(b"event: frame"):
                    # a real 1m interval boundary can cross mid-test and
                    # legitimately emit a frame; only keepalives count
                    continue
                assert c == b": keepalive\n\n"
                got += 1
            assert time.monotonic() - t0 >= 0.3, (
                "keepalives arrived back-to-back: heartbeat=0 spins")
        finally:
            chunks.close()

    def test_eviction_never_takes_a_subscribed_stream(self, pkg, store,
                                                      monkeypatch):
        monkeypatch.setenv("VM_MATSTREAM_MAX", "1")
        s, _ = store
        api = pkg.PrometheusAPI(s)
        q2 = "max by (g)(rate(ms_m[2m]))"
        sub1 = api.matstreams.subscribe(Q, STEP, DUR)
        with pytest.raises(pkg.matstream.MatStreamLimitError):
            api.matstreams.subscribe(q2, STEP, DUR)
        sub1.close()
        sub2 = api.matstreams.subscribe(q2, STEP, DUR)  # evicts idle Q
        assert api.matstreams.stream_count() == 1
        assert sub2.stream.q == api.matstreams.canonical(q2)
        sub2.close()

    def test_frame_encoding_shared_across_subscribers(self, pkg):
        f = {"type": "delta", "seq": 3, "result": []}
        a = pkg.matstream.encode_frame(f)
        b = pkg.matstream.encode_frame(f)
        assert a is b, "shared frame re-serialized per subscriber"
        assert json.loads(a) == f

    def test_watch_registered_on_select_mode(self, pkg, store):
        s, _ = store
        api = pkg.PrometheusAPI(s)
        srv = pkg.HTTPServer("127.0.0.1", 0)
        api.register(srv, mode="select")
        assert srv._route_for("/api/v1/watch") is not None


class TestRuleEngine:
    """The reference's TestVmalertEngine: rule expressions through the
    registry's shared instant evaluation, as vmalert's EngineDatasource
    sends them (``api.matstreams.instant_vector``), against the HTTP
    poll of ``/api/v1/query`` (vmalert's Datasource)."""

    RULES = ["sum by (g)(rate(ms_m[2m]))", "sum by (g)(rate(ms_m[2m]))",
             "max by (g)(rate(ms_m[2m]))", "sum by (g)(rate(ms_m[2m])) > 0"]

    @staticmethod
    def _poll(port, expr, ts):
        url = f"http://127.0.0.1:{port}/api/v1/query?" + \
            urllib.parse.urlencode({"query": expr, "time": ts})
        with urllib.request.urlopen(url, timeout=30) as r:
            data = json.loads(r.read())
        assert data.get("status") == "success", data
        return [{"metric": item["metric"],
                 "value": float(item["value"][1]), "ts": item["value"][0]}
                for item in data["data"]["result"]]

    def test_engine_rows_identical_to_legacy_poll(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        srv = pkg.HTTPServer("127.0.0.1", 0)
        api.register(srv)
        srv.start()
        try:
            ts = end / 1e3
            reuse0 = api.matstreams.instant_reuse
            evals0 = api.matstreams.instant_evals
            legacy = [self._poll(srv.port, e, ts) for e in self.RULES]
            engine = [api.matstreams.instant_vector(e, int(ts * 1000))
                      for e in self.RULES]

            def norm(rows):
                return sorted(json.dumps(r, sort_keys=True) for r in rows)
            assert [norm(r) for r in engine] == [norm(r) for r in legacy], (
                "engine-evaluated rules diverged from the HTTP poll path")
            assert all(legacy), "harness produced no rows"
            # 4 rules -> 3 distinct expressions (the two identical
            # recording rules share one evaluation)
            assert api.matstreams.instant_evals - evals0 == 3
            assert api.matstreams.instant_reuse - reuse0 == 1
        finally:
            srv.stop()

    def test_engine_disabled_degrades_to_per_rule_eval(self, pkg, store,
                                                       monkeypatch):
        monkeypatch.setenv("VM_MATSTREAM", "0")
        s, end = store
        api = pkg.PrometheusAPI(s)
        evals0 = api.matstreams.instant_evals
        r1 = api.matstreams.instant_vector("sum by (g)(rate(ms_m[2m]))", end)
        r2 = api.matstreams.instant_vector("sum by (g)(rate(ms_m[2m]))", end)
        assert r1 == r2 and r1
        # no memo: both calls evaluated (the legacy oracle semantics)
        assert api.matstreams.instant_evals - evals0 == 2

    def test_vmsingle_hosts_server_side_rules(self, pkg, tmp_path):
        """vmsingle -rule: recording rules evaluate in-process through
        the engine and land in the local storage, on both packages (the
        port on the host evaluator here: no card on the CPU)."""
        rule = tmp_path / "rules.yml"
        rule.write_text(json.dumps({
            "groups": [{"name": "g", "interval": "30s", "rules": [
                {"record": "r:ms_sum", "expr": "sum(ms_rule_m)"}]}]}))
        host = ["-search.tpuBackend=false"] if pkg.name == "port" else []
        args = pkg.vmsingle.parse_flags([f"-storageDataPath={tmp_path}/data",
                                         "-httpListenAddr=127.0.0.1:0",
                                         f"-rule={rule}", *host])
        storage, srv, api = pkg.vmsingle.build(args)
        try:
            assert len(api.rule_groups) == 1
            now = int(time.time() * 1000)
            storage.add_rows([({"__name__": "ms_rule_m", "i": str(i)},
                               now - 30_000, float(i)) for i in range(4)])
            storage.force_flush()
            api.rule_groups[0].eval_once(now / 1e3, notify=False)
            storage.force_flush()
            rows = list(storage.search_series(
                [pkg.TagFilter(b"", b"r:ms_sum")],
                now - 600_000, now + 600_000))
            assert rows, "recording rule result did not land in storage"
            assert rows[0].metric_name.metric_group == b"r:ms_sum"
            assert srv._route_for("/api/v1/rules") is not None
        finally:
            for g in api.rule_groups:
                g.stop()
            srv.stop()
            storage.close()
            if pkg.name == "port":
                from victoriametrics_tpu_torch.utils import profiler
            else:
                from victoriametrics_tpu.utils import profiler
            profiler.PROFILER.stop()  # build() started it


def _cluster(pkg, tmp_path):
    """(storage to serve, its backing stores, closers): a real 2-node
    cluster over RPC of the package."""
    import importlib
    ca = importlib.import_module(pkg.Storage.__module__.replace(
        "storage.storage", "parallel.cluster_api"))
    rpc = importlib.import_module(pkg.Storage.__module__.replace(
        "storage.storage", "parallel.rpc"))
    stores, servers, nodes = [], [], []
    for k in range(2):
        st = pkg.Storage(str(tmp_path / f"n{k}"))
        stores.append(st)
        h = ca.make_storage_handlers(st)
        isrv = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_INSERT, h)
        ssrv = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_SELECT, h)
        isrv.start()
        ssrv.start()
        servers += [isrv, ssrv]
        nodes.append(ca.StorageNodeClient("127.0.0.1", isrv.port,
                                          ssrv.port, name=f"n{k}"))
    cluster = ca.ClusterStorage(nodes)
    closers = [srv.stop for srv in servers] + [cluster.close] + \
        [st.close for st in stores]
    return cluster, stores, closers


class TestClusterFanOnce:
    def test_vmselect_fans_storage_once_per_interval(self, pkg, tmp_path):
        """N subscribers of one expression cost ONE search per interval —
        the vmselect half of the O(distinct expressions) contract, on a
        real 2-node cluster of each package."""
        cluster, stores, closers = _cluster(pkg, tmp_path)
        try:
            now = int(time.time() * 1000)
            t0 = (now - (NN - 1) * SCRAPE) // STEP * STEP
            rng = np.random.default_rng(5)
            rows = []
            for i in range(NS):
                vals = np.cumsum(rng.integers(0, 30, NN)).astype(float)
                rows.extend((({"__name__": "ms_m", "i": str(i),
                               "g": f"g{i % 2}"}, t0 + j * SCRAPE,
                              float(vals[j])) for j in range(NN)))
            cluster.add_rows(rows)
            for st in stores:
                st.force_flush()
            end = t0 + ((NN - 1) * SCRAPE // STEP + 1) * STEP
            api = pkg.PrometheusAPI(cluster)
            subs = [api.matstreams.subscribe(Q, STEP, DUR)
                    for _ in range(3)]
            fan0 = cluster.search_fanouts
            first = [sb.next_frame(timeout_s=2.0, now_ms=end)
                     for sb in subs]
            assert all(f and f["type"] == "snapshot" for f in first)
            cold_fans = cluster.search_fanouts - fan0
            assert cold_fans >= 1
            for r in range(2):
                end += STEP
                fan_r = cluster.search_fanouts
                frames = [sb.next_frame(timeout_s=2.0, now_ms=end)
                          for sb in subs]
                assert all(f is not None for f in frames)
                assert len({json.dumps(f, sort_keys=True)
                            for f in frames}) == 1
                delta_fans = cluster.search_fanouts - fan_r
                assert delta_fans <= cold_fans, (
                    f"interval {r}: {delta_fans} fan-outs for 3 "
                    f"subscribers (cold eval cost {cold_fans}) — the "
                    "shared evaluator is gone")
            for sb in subs:
                sb.close()
        finally:
            for close in closers:
                close()


@pytest.mark.race
class TestMatStreamRace:
    def test_concurrent_subscribe_ingest_advance_unsubscribe(self, pkg, store):
        """Race stress (tools/race.sh): subscriber churn + live ingest +
        concurrent pumps over one stream; the steady subscriber's final
        reassembled state must equal the poll, queues stay bounded, no
        exceptions escape."""
        s, end0 = store
        api = pkg.PrometheusAPI(s)
        steady = api.matstreams.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        cli.apply(steady.next_frame(timeout_s=2.0, now_ms=end0))
        stop = threading.Event()
        errors: list = []
        now_box = [end0]

        def ingester():
            # IDEMPOTENT values (a pure function of the timestamp):
            # rewrites racing an advance then stay invisible to the
            # final poll-vs-push comparison
            while not stop.is_set():
                end = now_box[0] + STEP
                s.add_rows([
                    ({"__name__": "ms_m", "i": str(i), "g": f"g{i % 2}"},
                     end - STEP + (k + 1) * SCRAPE,
                     float((end // SCRAPE + k) % 1000))
                    for i in range(NS) for k in range(4)])
                time.sleep(0.002)

        def churner():
            try:
                while not stop.is_set():
                    sub = api.matstreams.subscribe(Q, STEP, DUR)
                    sub.next_frame(timeout_s=0.05, now_ms=now_box[0])
                    sub.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def pumper():
            try:
                while not stop.is_set():
                    api.matstreams.advance_due(now_box[0])
                    time.sleep(0.001)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (ingester, churner, pumper, pumper)]
        for t in threads:
            t.start()
        end = end0
        try:
            for _ in range(6):
                end += STEP
                now_box[0] = end
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    f = steady.next_frame(timeout_s=0.2, now_ms=end)
                    if f is not None:
                        cli.apply(f)
                    if cli.window and cli.window[1] >= end:
                        break
                assert cli.window and cli.window[1] >= end, (
                    "stream stopped advancing under concurrency")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
        assert not errors, errors
        assert steady.q.qsize() <= pkg.matstream.queue_limit()
        # quiesced: one final advance over a fresh interval sees the
        # final data, then the oracle must hold exactly
        end += STEP
        api.matstreams.advance_due(end)
        while True:
            f = steady.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            cli.apply(f)
        assert cli.window[1] == end
        assert cli.result() == polled(pkg, s, Q, cli.window[0], cli.window[1],
                                      STEP)
        steady.close()


class TestResumeToken:
    """/api/v1/watch reconnect/resume: a dropped
    subscriber re-attaches with its last ``<epoch>:<seq>`` token and
    receives only the missed suffix frames; too-old or foreign tokens
    degrade LOUDLY to one resync snapshot."""

    def _drain(self, sub, cli, now):
        frames = []
        while True:
            f = sub.next_frame(timeout_s=0.0, now_ms=now)
            if f is None:
                return frames
            frames.append(f)
            cli.apply(f)

    def test_resume_replays_only_missed_suffix(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        frames = self._drain(sub, cli, end)
        assert frames and frames[0]["type"] == "snapshot"
        stream = sub.stream
        token = stream.resume_token(frames[-1])
        sub.close()                      # the dashboard drops
        # the stream advances twice while the client is gone
        for r in range(2):
            end += STEP
            _fresh(s, end, r)
            reg.advance_due(end)
        _RESUMES = pkg.matstream._RESUMES
        _RESUME_MISSES = pkg.matstream._RESUME_MISSES
        r0, m0 = _RESUMES.get(), _RESUME_MISSES.get()
        sub2 = reg.subscribe(Q, STEP, DUR, resume=token)
        missed = self._drain(sub2, cli, end)
        assert _RESUMES.get() == r0 + 1
        assert _RESUME_MISSES.get() == m0
        # ONLY the two missed deltas — no snapshot replay
        assert [f["type"] for f in missed] == ["delta", "delta"]
        # and the reassembled state matches the cold poll bit for bit
        assert json.loads(json.dumps(cli.result())) == \
            json.loads(json.dumps(polled(pkg, s, Q, end - DUR, end, STEP)))
        sub2.close()

    def test_resume_current_seq_sends_nothing(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        sub = api.matstreams.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        frames = self._drain(sub, cli, end)
        token = sub.stream.resume_token(frames[-1])
        sub.close()
        sub2 = api.matstreams.subscribe(Q, STEP, DUR, resume=token)
        assert self._drain(sub2, cli, end) == []   # nothing missed
        # the next advance delivers a plain delta (client state valid)
        end += STEP
        _fresh(s, end, 9)
        api.matstreams.advance_due(end)
        nxt = self._drain(sub2, cli, end)
        assert [f["type"] for f in nxt] == ["delta"]
        sub2.close()

    def test_too_old_token_degrades_to_resync_snapshot(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        frames = self._drain(sub, cli, end)
        token = sub.stream.resume_token(frames[-1])
        sub.close()
        # advance PAST the retained ring (VM_MATSTREAM_QUEUE frames)
        for r in range(pkg.matstream.queue_limit() + 2):
            end += STEP
            _fresh(s, end, r)
            reg.advance_due(end)
        _RESUME_MISSES = pkg.matstream._RESUME_MISSES
        m0 = _RESUME_MISSES.get()
        sub2 = reg.subscribe(Q, STEP, DUR, resume=token)
        got = self._drain(sub2, cli, end)
        assert _RESUME_MISSES.get() == m0 + 1
        assert got[0]["type"] == "snapshot" and got[0].get("resync")
        assert json.loads(json.dumps(cli.result())) == \
            json.loads(json.dumps(polled(pkg, s, Q, end - DUR, end, STEP)))
        sub2.close()

    def test_foreign_epoch_token_is_a_miss(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        api.matstreams.subscribe(Q, STEP, DUR).close()
        _RESUME_MISSES = pkg.matstream._RESUME_MISSES
        m0 = _RESUME_MISSES.get()
        sub = api.matstreams.subscribe(Q, STEP, DUR,
                                       resume="deadbeef.1:3")
        cli = pkg.StreamClient()
        got = self._drain(sub, cli, end)
        assert _RESUME_MISSES.get() == m0 + 1
        assert got and got[0]["type"] == "snapshot"
        sub.close()

    def test_sse_frames_carry_resume_id(self, pkg, store):
        """The HTTP surface: every SSE event ships an ``id:`` line the
        browser echoes back as Last-Event-ID, and h_watch accepts both
        that header and the resume= arg."""
        s, _ = store
        api = pkg.PrometheusAPI(s)
        resp = api.h_watch(FakeReq(query=Q, step="1m", range="20m",
                                   max_frames="1"))
        chunks = list(resp.chunks)
        assert any(b"\nid: " in c for c in chunks)
        # the id round-trips through the resume path (arg form)
        idline = next(c for c in chunks if b"\nid: " in c)
        token = idline.split(b"\nid: ")[1].split(b"\n")[0].decode()
        _RESUMES = pkg.matstream._RESUMES
        r0 = _RESUMES.get()
        resp2 = api.h_watch(FakeReq(query=Q, step="1m", range="20m",
                                    max_frames="1", resume=token,
                                    heartbeat="0.2"))
        resp2.on_close()
        assert _RESUMES.get() == r0 + 1


class TestInstantShareWithRangeStreams:
    """Rule groups and RANGE streams over one
    expression share one evaluation per distinct (expr, ts) — the
    stream's committed tail column serves the instant after a one-time
    validate-then-trust equality check."""

    def test_stream_tail_serves_instant_after_validation(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        cli = pkg.StreamClient()
        while True:
            f = sub.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            cli.apply(f)
        st = sub.stream
        assert st.instant_share is None
        # first instant at the committed end: validates (one legacy
        # eval, which was owed anyway) and records the verdict
        e0 = reg.instant_evals
        rows1 = reg.instant_vector(Q, end)
        assert reg.instant_evals == e0 + 1
        assert st.instant_share is True, \
            "window-explicit expression must validate as shareable"
        # advance the stream; the instant at the NEW end is served from
        # the committed tail column: zero evaluations
        end += STEP
        _fresh(s, end, 3)
        reg.advance_due(end)
        e1, reuse1 = reg.instant_evals, reg.instant_reuse
        rows2 = reg.instant_vector(Q, end)
        assert reg.instant_evals == e1, "shared instant re-evaluated"
        assert reg.instant_reuse == reuse1 + 1
        # ...and is bit-equal to what the legacy path would compute
        _xq = pkg.exec_query
        ec = api._ec(end, end, 300_000, (0, 0))
        want = []
        for r in _xq(ec, reg.canonical(Q)):
            v = r.values[-1]
            if not math.isnan(v):
                want.append({"metric": r.metric_name.to_dict(),
                             "value": float(pkg.fmt_value(v)),
                             "ts": end / 1e3})
        key = lambda r: json.dumps(r, sort_keys=True)  # noqa: E731
        assert sorted(rows2, key=key) == sorted(want, key=key)
        assert rows1  # the validated call returned real rows too
        # every Nth share REVALIDATES against a fresh legacy eval
        # (bounding divergence from late-arriving samples): drive the
        # hit counter to the revalidation boundary and observe exactly
        # one extra eval that restores the True verdict
        n = reg._SHARE_REVALIDATE_N
        e2 = reg.instant_evals
        extra = 0
        for j in range(n):
            end += STEP
            _fresh(s, end, 10 + j)
            reg.advance_due(end)
            before = reg.instant_evals
            reg.instant_vector(Q, end)
            extra += reg.instant_evals - before
        assert extra == 1, f"expected exactly one revalidation, {extra}"
        assert st.instant_share is True
        assert reg.instant_evals == e2 + 1
        sub.close()

    def test_unaligned_ts_does_not_share(self, pkg, store):
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        while sub.next_frame(timeout_s=0.0, now_ms=end) is not None:
            pass
        e0 = reg.instant_evals
        reg.instant_vector(Q, end + 7_000)   # off the committed end
        assert reg.instant_evals == e0 + 1
        assert sub.stream.instant_share is None  # never consulted
        sub.close()

    def test_divergent_expression_pins_share_off(self, pkg, store):
        """An expression whose instant value differs from the range
        tail must validate to False ONCE and never share after."""
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        while sub.next_frame(timeout_s=0.0, now_ms=end) is not None:
            pass
        st = sub.stream
        # sabotage the committed tail so validation MUST fail
        with st._lock:
            st._state.vals[:, -1] += 1.0
        e0 = reg.instant_evals
        reg.instant_vector(Q, end)
        assert reg.instant_evals == e0 + 1
        assert st.instant_share is False
        # subsequent instants keep evaluating (no silent wrong shares)
        reg.instant_vector(Q, end + STEP)
        assert reg.instant_evals == e0 + 2
        sub.close()

    def test_resume_across_decline_degrades_to_snapshot(self, pkg, store):
        """A missed suffix that crosses a decline (error frame) must
        NOT replay — the retained delta after it was diffed against
        the committed state, not the state a declined client holds —
        it degrades to the loud snapshot+resync path instead."""
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        client = pkg.StreamClient()
        frames = []
        while True:
            f = sub.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            frames.append(f)
            client.apply(f)
        token = sub.stream.resume_token(frames[-1])
        sub.close()
        # one ERROR advance (evaluation raises), then a clean delta
        orig = api._exec_range_cached
        api._exec_range_cached = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected decline"))
        end += STEP
        reg.advance_due(end)
        api._exec_range_cached = orig
        end += STEP
        _fresh(s, end, 5)
        reg.advance_due(end)
        _RESUME_MISSES = pkg.matstream._RESUME_MISSES
        m0 = _RESUME_MISSES.get()
        sub2 = reg.subscribe(Q, STEP, DUR, resume=token)
        got = []
        while True:
            f = sub2.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            got.append(f)
            client.apply(f)
        assert _RESUME_MISSES.get() == m0 + 1
        assert got and got[0]["type"] == "snapshot" and \
            got[0].get("resync")
        assert json.loads(json.dumps(client.result())) == \
            json.loads(json.dumps(polled(pkg, s, Q, end - DUR, end, STEP)))
        sub2.close()

    def test_resume_token_at_partial_frame_is_a_miss(self, pkg, store):
        """A token naming a PARTIAL snapshot frame must not resume:
        the client's window holds the uncommitted partial values, so
        replayed deltas (diffed against the committed state) would
        leave a silently divergent prefix — resync instead."""
        s, end = store
        api = pkg.PrometheusAPI(s)
        reg = api.matstreams
        sub = reg.subscribe(Q, STEP, DUR)
        client = pkg.StreamClient()
        while True:
            f = sub.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            client.apply(f)
        st = sub.stream
        sub.close()
        # manufacture a fanned partial-decline frame in the retained
        # ring (the real path needs a mid-fan-out storage failure)
        with st._lock:
            st.seq += 1
            st._recent.append((st.seq, st._snapshot_frame(partial=True)))
        token = f"{st.epoch}:{st.seq}"
        _RESUME_MISSES = pkg.matstream._RESUME_MISSES
        m0 = _RESUME_MISSES.get()
        sub2 = reg.subscribe(Q, STEP, DUR, resume=token)
        got = []
        while True:
            f = sub2.next_frame(timeout_s=0.0, now_ms=end)
            if f is None:
                break
            got.append(f)
        assert _RESUME_MISSES.get() == m0 + 1
        assert got and got[0]["type"] == "snapshot" and \
            got[0].get("resync")
        sub2.close()


# -- the fleet through the real registry ---------------------------------------

FL_NS, FL_NN = 16, 240
FL_PANELS = [
    "sum by (g)(rate(fl_m[5m]))",    # bucket A
    "sum by (i)(rate(fl_m[5m]))",    # bucket B
    "max by (g)(rate(fl_m[5m]))",    # bucket A
    "count by (g)(rate(fl_m[5m]))",  # bucket A
]


def _fl_seed(s, t0: int):
    rng = np.random.default_rng(7)
    rows = []
    last = np.empty(FL_NS)
    for i in range(FL_NS):
        vals = np.cumsum(rng.integers(0, 30, FL_NN)).astype(np.float64)
        last[i] = vals[-1]
        rows.extend((({"__name__": "fl_m", "i": str(i), "g": f"g{i % 4}"},
                      t0 + j * SCRAPE, float(vals[j])) for j in range(FL_NN)))
    s.add_rows(rows)
    s.force_flush()
    return last, rng


def _fl_ingest(s, rng, last, end: int, k: int = 4):
    rows = []
    for i in range(FL_NS):
        incr = np.cumsum(rng.integers(0, 30, k))
        rows.extend((({"__name__": "fl_m", "i": str(i), "g": f"g{i % 4}"},
                      end - STEP + (j + 1) * SCRAPE, float(last[i] + incr[j]))
                     for j in range(k)))
        last[i] += incr[-1]
    s.add_rows(rows)


def _fleet_sequence(pkg, path, engine, t0, intervals=4, launched=None):
    """One rolling sequence of the four panels through api.matstreams
    (subscribe, next_frame pinned to the data's clock, StreamClient): per
    interval each panel's reassembled rows, the plane's stats around the
    pumps and the B9 launches they made (``launched()``, a count)."""
    pkg.rrc.GLOBAL.reset()
    s = pkg.Storage(str(path))
    try:
        last, rng = _fl_seed(s, t0)
        end = t0 + ((FL_NN - 1) * SCRAPE // STEP + 1) * STEP
        api = pkg.PrometheusAPI(s, engine)
        subs = [api.matstreams.subscribe(q, STEP, DUR) for q in FL_PANELS]
        clis = [pkg.StreamClient() for _ in FL_PANELS]
        for sub, cli in zip(subs, clis):
            f = sub.next_frame(timeout_s=10.0, now_ms=end)
            assert f["type"] == "snapshot"
            cli.apply(f)
        plane = engine.fleet()
        out = []
        for _ in range(intervals):
            end += STEP
            _fl_ingest(s, rng, last, end)
            st0 = plane.stats()
            b9 = launched() if launched else 0
            for sub, cli in zip(subs, clis):
                f = sub.next_frame(timeout_s=10.0, now_ms=end)
                assert f is not None, "stream did not advance"
                cli.apply(f)
            out.append(({q: cli.result() for q, cli in zip(FL_PANELS, clis)},
                        st0, plane.stats(),
                        (launched() if launched else 0) - b9))
        for sub in subs:
            sub.close()
        return out
    finally:
        s.close()


def test_fleet_single_launch_per_interval(tmp_path, monkeypatch):
    """The port's counterpart of tests/test_device_fleet.py::
    test_fleet_single_launch_per_interval on its CPU engine: four panels
    subscribed through the real registry cost exactly one B9 launch per
    bucket per warm interval, every stream served by the fleet, and the
    reassembled rows equal the reference's same sequence (its
    TPUEngine(min_series=4)) at rtol 1e-12."""
    from victoriametrics_tpu.query.tpu_engine import TPUEngine
    from victoriametrics_tpu_torch.query import cuda_engine as ce
    from victoriametrics_tpu_torch.query import fleet
    launches = collections.Counter()
    real = fleet.timed_kernel_call

    def counting(kernel, fn, *a, **kw):
        launches[kernel] += 1
        return real(kernel, fn, *a, **kw)

    monkeypatch.setattr(fleet, "timed_kernel_call", counting)
    now = int(time.time() * 1000)
    t0 = (now - (FL_NN - 1) * SCRAPE) // STEP * STEP
    ref = _fleet_sequence(_package("ref"), tmp_path / "ref",
                          TPUEngine(min_series=4), t0)
    port = []
    for r, (rows, st0, st1, b9) in enumerate(_fleet_sequence(
            _package("port"), tmp_path / "port",
            ce.CUDAEngine(device="cpu", min_series=4), t0,
            launched=lambda: launches["fleet_rollup_aggregate_tile"]),
            start=1):
        port.append(rows)
        if r >= 2:
            nb = st1["buckets"]
            assert nb == 2 and st1["members"] == len(FL_PANELS), st1
            assert st1["launches"] - st0["launches"] == nb, (
                f"interval {r}: {st1['launches'] - st0['launches']} "
                f"launches for {nb} buckets")
            assert b9 == nb, (r, b9)
            assert st1["served"] - st0["served"] == len(FL_PANELS), st1
    for r, (got, (want, *_)) in enumerate(zip(port, ref), start=1):
        for q in FL_PANELS:
            g, w = got[q], want[q]
            assert [e["metric"] for e in g] == [e["metric"] for e in w], q
            assert g, q
            for a, b in zip(g, w):
                assert [t for t, _ in a["values"]] == \
                    [t for t, _ in b["values"]], (r, q)
                np.testing.assert_allclose(
                    [float(v) for _, v in a["values"]],
                    [float(v) for _, v in b["values"]], rtol=1e-12, atol=0,
                    err_msg=f"interval {r} {q} {a['metric']}")
