"""The port's cluster apps, ``victoriametrics_tpu_torch.apps.vmstorage``,
``vminsert`` and ``vmselect``:

- as processes (``python -m ...``) in interpreters where importing
  ``jax``, ``jaxlib``, ``xxhash`` or the JAX package fails: three storage
  nodes, a vminsert at ``-replicationFactor=2`` and a vmselect at the
  same factor with ``-search.tpuBackend=false`` (the host path answers:
  no card on the CPU), while a second vmselect started with the default
  backend on this machine without a CUDA device exits non-zero naming
  the probe's error and never answers.  Rows written through vminsert
  come back from
  vmselect, each series on two nodes; the health routes answer; a killed
  node leaves the answer whole; SIGTERM ends every process with exit 0
  and "shutdown complete", and none of the blocked modules was loaded;
- their flags: the reference's names and defaults, the environment
  variables (``VM_<FLAG>`` on vmstorage, ``VM_STORAGENODE`` on the
  routers), and a router without ``-storageNode`` refusing to start;
- vmauth round-robining two vmselects over the three nodes, and
  vmbackup/vmrestore of one node through its ``/snapshot/create``.
"""

import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

import pytest

from tests.apptest_helpers import Client, free_ports
from tests.test_torch_vmsingle import SITECUSTOMIZE
from victoriametrics_tpu_torch.apps import vminsert, vmselect, vmstorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class App:
    """One port app in a subprocess whose interpreter blocks the JAX
    package and its dependencies; its output collected in a file."""

    def __init__(self, site, tmp_path, module, flags, http_port, name):
        self.name, self.port = name, http_port
        self.log_path = tmp_path / f"{name}.log"
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(site), REPO]))
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m",
                 f"victoriametrics_tpu_torch.apps.{module}", *flags],
                cwd=str(tmp_path), env=env, stdout=log,
                stderr=subprocess.STDOUT)

    def log(self) -> str:
        return self.log_path.read_text()

    def wait_ready(self, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/health", timeout=1):
                    return
            except OSError:
                if self.proc.poll() is not None:
                    raise RuntimeError(f"{self.name} died:\n{self.log()}")
                time.sleep(0.1)
        raise TimeoutError(f"{self.name} did not become ready")

    def terminate(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=60)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def test_cluster_processes_serve_and_stop_without_jax(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    ports = free_ports(12)
    apps, carded = [], None
    try:
        specs = []
        for i in range(3):
            h, ip, sp = ports[3 * i:3 * i + 3]
            apps.append(App(site, tmp_path, "vmstorage", [
                f"-storageDataPath={tmp_path / f'st{i}'}",
                f"-httpListenAddr=127.0.0.1:{h}",
                f"-vminsertAddr=127.0.0.1:{ip}",
                f"-vmselectAddr=127.0.0.1:{sp}"], h, f"vmstorage-{i}"))
            specs.append(f"-storageNode=127.0.0.1:{ip}:{sp}")
        ih, sh, dh = ports[9:]
        apps.append(App(site, tmp_path, "vminsert", specs + [
            "-replicationFactor=2", f"-httpListenAddr=127.0.0.1:{ih}"],
            ih, "vminsert"))
        apps.append(App(site, tmp_path, "vmselect", specs + [
            "-replicationFactor=2", "-search.tpuBackend=false",
            f"-httpListenAddr=127.0.0.1:{sh}"], sh, "vmselect"))
        # the default backend: no card here, so startup must fail
        carded = App(site, tmp_path, "vmselect", specs + [
            f"-httpListenAddr=127.0.0.1:{dh}"], dh, "vmselect-card")
        for a in apps:
            a.wait_ready()
        assert carded.proc.wait(timeout=120) != 0, carded.log()[-3000:]
        assert "ERROR" in carded.log()
        assert "cuda backend requested but unavailable" in carded.log()
        assert "no CUDA device" in carded.log()
        assert "vmselect started" not in carded.log()
        assert "LEAKED []" in carded.log(), carded.log()[-3000:]
        storages, vi, vs = apps[:3], Client(ih), Client(sh)
        now = int(time.time() * 1000)
        body = "".join(f'capp_m{{i="{i}"}} {i * 1.5} {now - 60_000}\n'
                       for i in range(24))
        assert vi.post("/api/v1/import/prometheus", body.encode())[0] == 204
        for a in storages:
            Client(a.port).force_flush()
        # RF 2: every series on two of the three nodes
        held = []
        for a in storages:
            code, text = Client(a.port).get("/metrics")
            assert code == 200
            held += [float(ln.split()[-1]) for ln in text.decode().split(
                "\n") if ln.startswith("vm_timeseries_total")]
        assert sum(held) == 48 and all(h > 0 for h in held), held
        res = vs.query("sum(capp_m)", now / 1e3)
        assert res["data"]["result"][0]["value"][1] == "414"
        assert res["isPartial"] is False
        code, body = Client(storages[0].port).get("/api/v1/status/health")
        assert code == 200 and json.loads(body)["role"] == "vmstorage"
        code, body = vs.get("/api/v1/status/health")
        h = json.loads(body)
        assert code == 200 and h["role"] == "vmselect"
        assert len(h["nodes"]) == 3
        # the host backend asked for: no probe, no attach
        assert "cuda backend requested" not in apps[4].log()
        storages[1].kill()
        res = vs.query("sum(capp_m)", now / 1e3)
        assert res["data"]["result"][0]["value"][1] == "414"
        assert res["isPartial"] is False
        for a in apps[4:] + apps[3:4] + [storages[0], storages[2]]:
            rc = a.terminate()
            text = a.log()
            assert rc == 0, text[-3000:]
            assert "shutdown complete" in text, text[-3000:]
            assert "LEAKED []" in text, text[-3000:]
    finally:
        for a in apps + [carded] * (carded is not None):
            a.kill()


def test_vmstorage_flags_and_environment(monkeypatch):
    a = vmstorage.parse_flags([])
    assert (a.storageDataPath, a.httpListenAddr, a.vminsertAddr,
            a.vmselectAddr, a.retentionPeriod, a.dedup_interval,
            a.self_scrape_interval) == (
        "vmstorage-data", ":8482", ":8400", ":8401", "13m", "0s", "")
    monkeypatch.setenv("VM_RETENTIONPERIOD", "2y")
    monkeypatch.setenv("VM_DEDUP.MINSCRAPEINTERVAL", "1m")
    monkeypatch.setenv("VM_DEDUP_INTERVAL", "30s")
    a = vmstorage.parse_flags(["-retentionPeriod=1y"])
    assert a.retentionPeriod == "2y" and a.dedup_interval == "30s"


@pytest.mark.parametrize("app", [vminsert, vmselect])
def test_router_flags_and_environment(app, monkeypatch):
    a = app.parse_flags(["-storageNode=h:1:2", "-storageNode=h:3:4"])
    assert a.storageNode == ["h:1:2", "h:3:4"]
    assert a.rpc_timeout == 10.0 and a.native_addr == ""
    assert a.self_scrape_interval == ""
    if app is vminsert:
        assert (a.httpListenAddr, a.replicationFactor,
                a.max_ingestion_rate) == (":8480", 1, 0)
    else:
        assert (a.httpListenAddr, a.replication_factor, a.tpu,
                a.deny_partial, a.max_series, a.max_query_duration) == (
            ":8481", 1, True, False, 300_000, "30s")
    monkeypatch.setenv("VM_STORAGENODE", "e:5:6,e:7:8")
    assert app.parse_flags(["-storageNode=h:1:2"]).storageNode == \
        ["e:5:6", "e:7:8"]
    monkeypatch.delenv("VM_STORAGENODE")
    with pytest.raises(SystemExit) as ei:
        app.build(app.parse_flags(["-httpListenAddr=127.0.0.1:0"]))
    assert "-storageNode is required" in str(ei.value.code)


def test_vmauth_balances_two_vmselects_and_vmbackup_backs_up_a_node(
        tmp_path):
    """The reference's documented cluster layout, in process on the CPU:
    three vmstorage nodes, two vmselects over them (-search.tpuBackend=
    false) and vmauth in front with a url_prefix list of both: requests
    alternate between the two (round robin), each answer equal to the
    other's and to a vmselect's own; then vmbackup backs up one node
    through its /snapshot/create and vmrestore brings its series back."""
    from victoriametrics_tpu_torch.apps import vmauth, vmbackup
    from victoriametrics_tpu_torch.parallel.cluster_api import (
        ClusterStorage, StorageNodeClient)
    from victoriametrics_tpu_torch.storage.storage import Storage
    from victoriametrics_tpu_torch.utils import profiler
    nodes, selects, srvs = [], [], []
    try:
        for i in range(3):
            node = vmstorage.build(vmstorage.parse_flags([
                f"-storageDataPath={tmp_path / f'st{i}'}",
                "-httpListenAddr=127.0.0.1:0", "-vminsertAddr=127.0.0.1:0",
                "-vmselectAddr=127.0.0.1:0"]))
            for s in node[1:4]:
                s.start()
            nodes.append(node)
        specs = [f"-storageNode=127.0.0.1:{n[1].port}:{n[2].port}"
                 for n in nodes]
        writer = ClusterStorage([StorageNodeClient("127.0.0.1", n[1].port,
                                                   n[2].port) for n in nodes])
        now = int(time.time() * 1000) - 600_000
        writer.add_rows([({"__name__": "lb_m", "i": str(i)},
                          now + j * 15_000, float(i * 10 + j))
                         for i in range(30) for j in range(20)])
        writer.close()
        for n in nodes:
            n[0].force_flush()
        for _ in range(2):
            cluster, srv, _api, _native = vmselect.build(vmselect.parse_flags(
                specs + ["-search.tpuBackend=false",
                         "-httpListenAddr=127.0.0.1:0"]))
            srv.start()
            selects.append((cluster, srv))
        cfg = tmp_path / "auth.json"
        cfg.write_text(json.dumps({"users": [{
            "username": "lb", "password": "pw",
            "url_prefix": [f"http://127.0.0.1:{s.port}"
                           for _, s in selects]}]}))
        auth, proxy = vmauth.build(vmauth.parse_flags(
            [f"-auth.config={cfg}", "-httpListenAddr=127.0.0.1:0"]))
        proxy.start()
        srvs.append(proxy)
        q = {"query": "sum by (i)(rate(lb_m[1m]))", "start": now / 1e3,
             "end": (now + 19 * 15_000) / 1e3, "step": 15}
        req_url = f"http://127.0.0.1:{proxy.port}/api/v1/query_range?" + \
            urllib.parse.urlencode(q)
        answers, served = [], []
        for _ in range(4):
            before = [s.request_count for _, s in selects]
            req = urllib.request.Request(req_url)
            req.add_header("Authorization", "Basic " +
                           base64.b64encode(b"lb:pw").decode())
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read())["data"])
            served.append([s.request_count - b
                           for (_, s), b in zip(selects, before)])
        assert served == [[1, 0], [0, 1], [1, 0], [0, 1]]
        direct = Client(selects[0][1].port).query_range(**q)["data"]
        assert all(a == direct for a in answers)
        assert len(direct["result"]) == 30
        # vmbackup of node 0 through its own /snapshot/create
        vmbackup.main_backup([f"-storageDataPath={tmp_path / 'st0'}",
                              "-snapshot.createURL=http://127.0.0.1:"
                              f"{nodes[0][3].port}",
                              f"-dst=fs://{tmp_path / 'bkp0'}"])
        assert len(nodes[0][0].list_snapshots()) == 1
        vmbackup.main_restore([f"-src=fs://{tmp_path / 'bkp0'}",
                               f"-storageDataPath={tmp_path / 'r0'}"])
        held = nodes[0][0].series_count()
        restored = Storage(str(tmp_path / "r0"))
        try:
            assert held > 0 and restored.series_count() == held
        finally:
            restored.close()
    finally:
        stops = [s.stop for s in srvs]
        for cluster, srv in selects:
            stops += [srv.stop, cluster.close]
        for n in nodes:
            stops += [n[1].stop, n[2].stop, n[3].stop]
        ths = [threading.Thread(target=fn) for fn in stops]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        for n in nodes:
            n[0].close()
        profiler.PROFILER.stop()
