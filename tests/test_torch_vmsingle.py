"""The port's server entry point, ``victoriametrics_tpu_torch.apps.
vmsingle``:

- as a process (``python -m ...``) in an interpreter where importing
  ``jax``, ``jaxlib``, ``xxhash`` or the JAX package fails: it ingests and
  answers over HTTP, shuts down cleanly on SIGTERM (exit 0), and none of
  those modules was loaded;
- every flag that asks for a part the port does not have yet (``-rule``)
  makes it exit non-zero with an error naming that part and ROADMAP.md §A
  item 11; ``-selfScrapeInterval`` and ``-pushmetrics.url`` start theirs;
- the flags of the ingestion layer (``-streamAggr.config``, and the
  Graphite, Influx and OpenTSDB listeners) start the server and serve what
  they ingest; the reference's ``TestIngestServersAndGate`` cases
  (``tests/test_vmsingle_http.py``) run on the port's vmsingle;
- ``-search.tpuBackend`` on a machine without a CUDA device: the attach
  thread's probe fails, the failure is logged at error level, ``api.tpu``
  stays None and the host path answers."""

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
         f"-httpListenAddr=127.0.0.1:{port}"],
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


@pytest.mark.parametrize("flag,part", [
    ("-rule=rules.yml", "server-side rules"),
])
def test_unported_flags_exit_naming_the_part(tmp_path, flag, part):
    args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                 "-httpListenAddr=127.0.0.1:0", flag])
    with pytest.raises(SystemExit) as ei:
        vmsingle.build(args)
    msg = str(ei.value.code)
    assert part in msg and "§A item 11" in msg, msg
    assert flag.split("=")[0] in msg
    assert not (tmp_path / "d").exists()  # nothing opened


@pytest.mark.parametrize("flag", [
    "-selfScrapeInterval=15s",
    "-pushmetrics.url=http://127.0.0.1:1/api/v1/import/prometheus",
])
def test_self_monitoring_flags_start(tmp_path, flag):
    """-selfScrapeInterval and -pushmetrics.url start their parts (the
    self-scraper into the server's own store, the pusher's ticker), which
    stop before the store closes."""
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={tmp_path}/d", "-httpListenAddr=127.0.0.1:0",
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
                                 "-httpListenAddr=127.0.0.1:0",
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
                                     "-httpListenAddr=127.0.0.1:0",
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
                                     "-httpListenAddr=127.0.0.1:0"])
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
                                     "-httpListenAddr=127.0.0.1:0"])
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


def test_unported_flag_exit_code_of_the_process(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmsingle",
         f"-storageDataPath={tmp_path / 'd'}", "-httpListenAddr=127.0.0.1:0",
         "-rule=rules.yml"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "§A item 11" in out.stderr, out.stderr[-2000:]


def test_cuda_backend_without_a_card_logs_and_serves_host(tmp_path,
                                                          caplog):
    from victoriametrics_tpu_torch.utils import logger
    errors0 = logger.message_counters().get("error", 0)
    args = vmsingle.parse_flags([f"-storageDataPath={tmp_path}/d",
                                 "-httpListenAddr=127.0.0.1:0",
                                 "-search.tpuBackend"])
    storage, srv, api = vmsingle.build(args)
    srv.start()
    try:
        with caplog.at_level(logging.INFO, logger="vmtpu"):
            api.attach_thread.join(timeout=120)
        assert not api.attach_thread.is_alive()
        assert api.tpu is None
        assert api.probe_result.error is not None
        assert "no CUDA device" in api.probe_result.error
        assert api.attach_timing["probe_s"] > 0
        errs = [r for r in caplog.records if r.levelno == logging.ERROR]
        assert any("cuda backend requested but unavailable" in r.getMessage()
                   for r in errs), [r.getMessage() for r in caplog.records]
        assert logger.message_counters().get("error", 0) > errors0
        c = Client(srv.port)
        now = int(time.time() * 1000)
        rows = "".join(f'host_m{{i="{i}"}} {i} {now - 30_000}\n'
                       for i in range(5))
        assert c.post("/api/v1/import/prometheus", rows.encode())[0] == 204
        res = c.query("sum(host_m)", now / 1e3)
        assert res["data"]["result"][0]["value"][1] == "10"
        code, body = c.get("/flags")
        assert code == 200 and b"tpu=True" in body
    finally:
        srv.stop()
        storage.close()
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
