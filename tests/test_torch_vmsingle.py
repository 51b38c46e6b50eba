"""The port's server entry point, ``victoriametrics_tpu_torch.apps.
vmsingle``:

- as a process (``python -m ...``) in an interpreter where importing
  ``jax``, ``jaxlib``, ``xxhash`` or the JAX package fails: it ingests and
  answers over HTTP, shuts down cleanly on SIGTERM (exit 0), and none of
  those modules was loaded;
- ``-rule`` arms server-side rule groups (``api.rule_groups``, their rows
  written into the store, ``/api/v1/rules``) and the Graphite query API
  answers beside the Prometheus one; ``-selfScrapeInterval`` and
  ``-pushmetrics.url`` start theirs;
- the flags of the ingestion layer (``-streamAggr.config``, and the
  Graphite, Influx and OpenTSDB listeners) start the server and serve what
  they ingest; the reference's ``TestIngestServersAndGate`` cases
  (``tests/test_vmsingle_http.py``) run on the port's vmsingle;
- ``-search.tpuBackend`` is on by default: on a machine without a CUDA
  device the probe fails, the failure is logged at error level and
  startup ends non-zero naming it (in process: ``build`` raises
  SystemExit, nothing is served); ``-search.tpuBackend=false`` serves on
  the host.  Every other case here passes ``=false``: there is no card
  on the CPU."""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.apptest_helpers import Client, free_ports
from victoriametrics_tpu_torch.apps import vmsingle
from victoriametrics_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the flag every case but the attach's passes: no card on the CPU
HOST = "-search.tpuBackend=false"
BLOCKED = ("jax", "jaxlib", "xxhash", "victoriametrics_tpu")

#: a sitecustomize that blocks the modules before anything imports and
#: reports, at exit, which of them ended up loaded
SITECUSTOMIZE = f"""
import atexit, json, sys
BLOCKED = {BLOCKED!r}
for _m in BLOCKED:
    sys.modules[_m] = None


def _report():
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED
                    and sys.modules[m] is not None)
    print("LEAKED " + json.dumps(leaked), flush=True)


atexit.register(_report)
"""


def _wait_ready(proc, port, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=1):
                return
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(proc.stdout.read().decode())
            time.sleep(0.1)
    raise TimeoutError("vmsingle did not become ready")


def test_process_serves_and_stops_without_jax(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    port = free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmsingle",
         f"-storageDataPath={tmp_path / 'data'}",
         f"-httpListenAddr=127.0.0.1:{port}", HOST],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        _wait_ready(proc, port)
        c = Client(port)
        now = int(time.time() * 1000)
        body = "".join(f'proc_m{{i="{i}"}} {i * 1.5} {now - 60_000}\n'
                       for i in range(8))
        assert c.post("/api/v1/import/prometheus", body.encode())[0] == 204
        c.force_flush()
        res = c.query("sum(proc_m)", now / 1e3)
        assert res["data"]["result"][0]["value"][1] == "42"
        assert c.get("/metrics")[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = out.decode()
    assert proc.returncode == 0, text[-3000:]
    assert "shutdown complete" in text
    assert "LEAKED []" in text, text[-3000:]


@pytest.mark.parametrize("flag", [
    "-selfScrapeInterval=15s",
    "-pushmetrics.url=http://127.0.0.1:1/api/v1/import/prometheus",
])
def test_self_monitoring_flags_start(tmp_path, flag):
    """-selfScrapeInterval and -pushmetrics.url start their parts (the
    self-scraper into the server's own store, the pusher's ticker), which
    stop before the store closes."""
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={tmp_path}/d", "-httpListenAddr=127.0.0.1:0", HOST,
        flag]))
    try:
        if flag.startswith("-selfScrapeInterval"):
            assert api.selfscraper is not None and api.pusher is None
            assert api.selfscraper.interval_s == 15.0
        else:
            assert api.selfscraper is None
            assert api.pusher is not None and api.pusher.urls == [
                flag.split("=", 1)[1]]
    finally:
        if api.selfscraper is not None:
            api.selfscraper.stop()
        if api.pusher is not None:
            api.pusher.stop()
        storage.close()
        profiler.PROFILER.stop()


AGG_YML = """- match: '{__name__="agg_in"}'
  interval: 1m
  outputs: [sum_samples, count_samples]
  by: [dc]
"""


def _send_tcp(port: int, text: str) -> None:
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(text.encode())
    s.close()


def _poll(c, query, t_s, timeout=10.0):
    """The instant query's first value once the series is queryable."""
    deadline = time.time() + timeout
    while True:
        res = c.query(query, t_s)["data"]["result"]
        if res or time.time() > deadline:
            return res[0]["value"][1] if res else None
        time.sleep(0.1)


@pytest.mark.parametrize("flag", ["-streamAggr.config",
                                  "-graphiteListenAddr",
                                  "-influxListenAddr",
                                  "-opentsdbListenAddr"])
def test_ported_ingest_flags_start_and_serve(tmp_path, flag):
    """Each flag this slice ports starts the server, and what comes in
    through it is served: the aggregator's flushed outputs (its final
    flush before the store closes), or each listener's lines."""
    value = "127.0.0.1:0"
    if flag == "-streamAggr.config":
        (tmp_path / "agg.yml").write_text(AGG_YML)
        value = str(tmp_path / "agg.yml")
    args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                 "-httpListenAddr=127.0.0.1:0", HOST,
                                 f"{flag}={value}"])
    storage, srv, api = vmsingle.build(args)
    srv.start()
    now = int(time.time() * 1000)
    try:
        c = Client(srv.port)
        if flag == "-streamAggr.config":
            rows = "".join(f'agg_in{{dc="e",i="{i}"}} {i} {now - 5000}\n'
                           for i in range(6)) + f"other 7 {now - 5000}\n"
            assert c.post("/api/v1/import/prometheus", rows.encode())[0] \
                == 204
            assert api.stream_aggr is not None
            assert api.rows_inserted == 1  # only the unmatched row
            api.stream_aggr.stop(final_flush=True)
            t = time.time() + 1
            assert _poll(c, "agg_in:1m_sum_samples", t) == "15"
            assert _poll(c, "agg_in:1m_count_samples", t) == "6"
            assert _poll(c, "other", t) == "7"
            assert c.query("agg_in", t)["data"]["result"] == []
        else:
            (isrv,) = api.ingest_servers
            assert isrv.port > 0
            line, name, want = {
                "-graphiteListenAddr": (f"g.m;k=v 5.5 {now // 1000}", "g.m",
                                        "5.5"),
                "-influxListenAddr": (f"inf,k=v f=6.5 {now * 10**6}",
                                      "inf_f", "6.5"),
                "-opentsdbListenAddr": (f"put ot.m {now // 1000} 7.5 k=v",
                                        "ot.m", "7.5")}[flag]
            _send_tcp(isrv.port, line + "\n")
            assert _poll(c, f'{{__name__="{name}",k="v"}}',
                         time.time()) == want
    finally:
        srv.stop()
        for isrv in api.ingest_servers:
            isrv.stop()
        storage.close()
        profiler.PROFILER.stop()


T0 = 1_753_700_000_000


class TestIngestServersAndGate:
    """The reference's cases (tests/test_vmsingle_http.py), on the port's
    vmsingle."""

    def test_tcp_udp_line_protocols(self, tmp_path):
        args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                     "-httpListenAddr=127.0.0.1:0", HOST,
                                     "-graphiteListenAddr=127.0.0.1:0",
                                     "-opentsdbListenAddr=127.0.0.1:0"])
        storage, srv, api = vmsingle.build(args)
        srv.start()
        try:
            c = Client(srv.port)
            gport = api.ingest_servers[0].port
            oport = api.ingest_servers[1].port
            # graphite over TCP
            _send_tcp(gport, f"tcp.metric;src=tcp 5.5 {T0 // 1000}\n")
            # graphite over UDP
            u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            u.sendto(f"udp.metric 6.5 {T0 // 1000}\n".encode(),
                     ("127.0.0.1", gport))
            u.close()
            # opentsdb telnet over TCP
            _send_tcp(oport, f"put ot.tcp {T0 // 1000} 7.5 k=v\n")
            deadline = time.time() + 10
            got = {}
            while time.time() < deadline and len(got) < 3:
                for name in ("tcp.metric", "udp.metric", "ot.tcp"):
                    res = c.query(f'{{__name__="{name}"}}', T0 / 1e3 + 10)
                    if res["data"]["result"]:
                        got[name] = res["data"]["result"][0]["value"][1]
                time.sleep(0.2)
            assert got == {"tcp.metric": "5.5", "udp.metric": "6.5",
                           "ot.tcp": "7.5"}
        finally:
            srv.stop()
            for isrv in api.ingest_servers:
                isrv.stop()
            storage.close()
            profiler.PROFILER.stop()

    def test_concurrency_gate_rejects_with_429(self, tmp_path):
        """A saturated 1-slot gate must reject HTTP queries with 429 +
        Retry-After through the real endpoint."""
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            ConcurrencyGate
        args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                     "-httpListenAddr=127.0.0.1:0", HOST])
        storage, srv, api = vmsingle.build(args)
        api.gate = ConcurrencyGate(max_concurrent=1, max_queue_duration_s=0.2)
        srv.start()
        try:
            c = Client(srv.port)
            with api.gate:  # hold the only slot
                code, body = c.get("/api/v1/query", query="up")
                assert code == 429, body
                assert json.loads(body)["errorType"] == "too_many_requests"
            code, _ = c.get("/api/v1/query", query="up")
            assert code == 200  # slot released
            assert api.gate.rejected == 1
        finally:
            srv.stop()
            storage.close()
            profiler.PROFILER.stop()

    def test_relative_time_param(self, tmp_path):
        args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                     "-httpListenAddr=127.0.0.1:0", HOST])
        storage, srv, api = vmsingle.build(args)
        srv.start()
        try:
            app = Client(srv.port)
            now = time.time()
            line = f"rel_metric 9.5 {int((now - 60) * 1000)}\n"
            app.post("/api/v1/import/prometheus", line.encode())
            code, body = app.get("/api/v1/query", query="rel_metric")
            assert code == 200
            code, body = app.get("/api/v1/query_range", query="rel_metric",
                                 start="-5m", end=str(now), step="15")
            assert code == 200
            assert json.loads(body)["data"]["result"]
        finally:
            srv.stop()
            storage.close()
            profiler.PROFILER.stop()


RULES = {"groups": [{"name": "g", "interval": "1h", "rules": [
    {"record": "job:rule_m:sum", "expr": "sum by (job)(rule_m)"},
    {"record": "job:rule_m:sum2", "expr": "sum by (job)(rule_m)"},
    {"alert": "RuleHigh", "expr": "sum by (job)(rule_m) > 5", "for": "1m",
     "labels": {"severity": "page"}}]}]}


def test_rule_flag_arms_groups_and_writes_rows(tmp_path):
    """-rule (a JSON rule file): the group is armed, its two recording
    rules share one evaluation an instant through the registry, the rows
    and ALERTS land in the store, the alert goes pending then firing after
    its `for`, and /api/v1/rules lists the group."""
    (tmp_path / "rules.json").write_text(json.dumps(RULES))
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={tmp_path}/d", "-httpListenAddr=127.0.0.1:0",
        HOST, f"-rule={tmp_path / 'rules.json'}"]))
    srv.start()
    try:
        (g,) = api.rule_groups
        g.stop()  # evaluated below on the data's clock
        assert [r.name for r in g.rules] == [
            "job:rule_m:sum", "job:rule_m:sum2", "RuleHigh"]
        now = int(time.time() * 1000) // 60_000 * 60_000
        storage.add_rows([({"__name__": "rule_m", "job": j, "i": str(i)},
                           now - 30_000 + k * 60_000, float(i + k))
                          for j in ("a", "b") for i in range(4)
                          for k in range(3)])
        ms = api.matstreams
        states = []
        for k in range(3):
            e0, r0 = ms.instant_evals, ms.instant_reuse
            g.eval_once(now / 1e3 + k * 60, notify=False)
            assert (ms.instant_evals - e0, ms.instant_reuse - r0) == (2, 1)
            states.append(sorted(s["state"]
                                 for s in g.rules[2]._active.values()))
        assert states == [["pending", "pending"], ["firing", "firing"],
                          ["firing", "firing"]]
        storage.force_flush()
        c = Client(srv.port)
        t = now / 1e3 + 120
        res = c.query("job:rule_m:sum", t)["data"]["result"]
        assert sorted((r["metric"]["job"], r["value"][1]) for r in res) == [
            ("a", "14"), ("b", "14")]
        assert c.query("job:rule_m:sum2", t)["data"]["result"]
        res = c.query('ALERTS{alertname="RuleHigh"}', t)["data"]["result"]
        # the pending series of the first instant is still in the lookback
        assert {r["metric"]["alertstate"] for r in res} == {"pending",
                                                            "firing"}
        assert c.query("ALERTS_FOR_STATE", t)["data"]["result"]
        code, body = c.get("/api/v1/rules")
        (grp,) = json.loads(body)["data"]["groups"]
        assert code == 200 and grp["name"] == "g"
        assert grp["rules"][2]["state"] == "firing"
    finally:
        vmsingle.shutdown(srv, storage, api)
        profiler.PROFILER.stop()


def test_default_backend_without_a_card_exits_naming_the_probe(tmp_path):
    """Started as a user starts it (no backend flag) on a machine without
    a CUDA device, the process exits non-zero naming the probe's error
    and never answers on its port."""
    port = free_ports(1)[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmsingle",
         f"-storageDataPath={tmp_path / 'd'}",
         f"-httpListenAddr=127.0.0.1:{port}"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    answered = False
    try:
        while proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=1):
                    answered = True
            except OSError:
                time.sleep(0.05)
        out = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode != 0 and not answered, out[-3000:]
    assert "cuda backend requested but unavailable" in out, out[-3000:]
    assert "no CUDA device" in out
    assert "vmsingle started" not in out


def test_cuda_backend_without_a_card_logs_and_serves_host(tmp_path,
                                                          caplog):
    """The default backend on a machine without a card: the probe's
    failure is logged at error level, build raises SystemExit naming it
    and closes what it opened, and nothing listens on the port; with
    -search.tpuBackend=false the same store is served on the host."""
    from victoriametrics_tpu_torch.utils import logger
    errors0 = logger.message_counters().get("error", 0)
    port = free_ports(1)[0]
    args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                 f"-httpListenAddr=127.0.0.1:{port}"])
    assert args.tpu is True
    with caplog.at_level(logging.INFO, logger="vmtpu"):
        with pytest.raises(SystemExit) as ei:
            vmsingle.build(args)
    msg = str(ei.value.code)
    assert "cuda backend requested but unavailable" in msg, msg
    assert "no CUDA device" in msg
    errs = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert any("cuda backend requested but unavailable" in r.getMessage()
               for r in errs), [r.getMessage() for r in caplog.records]
    assert logger.message_counters().get("error", 0) > errors0
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={tmp_path}/d", f"-httpListenAddr=127.0.0.1:{port}",
        HOST]))
    srv.start()
    try:
        # the host backend asked for: no probe ran, no engine attached
        assert api.tpu is None and not hasattr(api, "probe_result")
        c = Client(srv.port)
        now = int(time.time() * 1000)
        rows = "".join(f'host_m{{i="{i}"}} {i} {now - 30_000}\n'
                       for i in range(5))
        assert c.post("/api/v1/import/prometheus", rows.encode())[0] == 204
        res = c.query("sum(host_m)", now / 1e3)
        assert res["data"]["result"][0]["value"][1] == "10"
        code, body = c.get("/flags")
        assert code == 200 and b"tpu=False" in body
    finally:
        srv.stop()
        storage.close()
        profiler.PROFILER.stop()


def _hang(*_a, **_k):
    import threading
    threading.Event().wait(30)


def _boom(*_a, **_k):
    raise RuntimeError("nvcc exited 1")


@pytest.mark.parametrize("patch, expect", [
    (("CUDAEngine", _hang), "cuda engine build hung past"),
    (("warmup", _hang), "cuda warm-up hung past"),
    (("CUDAEngine", _boom),
     "cuda engine build failed: RuntimeError: nvcc exited 1"),
    (("warmup", _boom), "cuda warm-up failed: RuntimeError: nvcc exited 1")],
    ids=["build-hangs", "warmup-hangs", "build-fails", "warmup-fails"])
def test_attach_stage_that_hangs_or_fails_ends_startup(
        tmp_path, monkeypatch, caplog, patch, expect):
    """After a probe that succeeds, an engine build or a warm-up that
    hangs past the probe's deadline (``VM_TPU_PROBE_TIMEOUT_S``) or
    raises ends startup: build raises SystemExit naming the stage, logs
    it at error level (a hang with the stage's stack), closes what it
    opened and serves nothing."""
    from victoriametrics_tpu_torch.query import cuda_engine
    from victoriametrics_tpu_torch.utils import device_probe
    monkeypatch.setattr(device_probe, "probe_backend",
                        lambda timeout: device_probe.ProbeResult(
                            "cuda", 1, None, name="stub"))
    monkeypatch.setattr(cuda_engine, "auto_mesh", lambda: None)
    monkeypatch.setattr(cuda_engine, "CUDAEngine",
                        lambda **k: object())
    monkeypatch.setattr(cuda_engine, "warmup", lambda engine: 0)
    monkeypatch.setattr(cuda_engine, *patch)
    monkeypatch.setenv("VM_TPU_PROBE_TIMEOUT_S", "0.5")
    port = free_ports(1)[0]
    with caplog.at_level(logging.INFO, logger="vmtpu"):
        t0 = time.time()
        with pytest.raises(SystemExit) as ei:
            vmsingle.build(vmsingle.parse_flags([
                f"-storageDataPath={tmp_path}/d",
                f"-httpListenAddr=127.0.0.1:{port}"]))
    assert time.time() - t0 < 20
    msg = str(ei.value.code)
    assert msg.startswith(expect), msg
    errs = "\n".join(r.getMessage() for r in caplog.records
                     if r.levelno == logging.ERROR)
    assert expect in errs, errs
    if "hung" in expect:
        assert f"in {patch[1].__name__}" in errs, errs
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    # nothing was left serving: the same directory builds on the host
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={tmp_path}/d", "-httpListenAddr=127.0.0.1:0",
        HOST]))
    vmsingle.shutdown(srv, storage, api)
    profiler.PROFILER.stop()


def test_probe_timeout_is_reported_with_the_stack(monkeypatch):
    """A probe that outlives its deadline is killed and reported as hung,
    as the reference's probe reports it."""
    from victoriametrics_tpu_torch.utils import device_probe
    monkeypatch.setattr(device_probe, "_DUMP_INTERVAL_S", 0.2)
    monkeypatch.setattr(device_probe, "_PROBE_CODE",
                        "import faulthandler, sys, time\n"
                        "faulthandler.dump_traceback_later({dump}, "
                        "repeat=True, file=sys.stderr)\ntime.sleep(30)\n")
    res = device_probe.probe_backend(1.5)
    assert res.platform is None and res.n == 0
    assert "timed out" in res.error
    assert res.stack and "Timeout (" in res.stack
    assert tuple(res) == (None, 0, res.error)
