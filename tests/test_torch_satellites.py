"""The port's satellite apps against the reference's: the persistent
queue, vmagent (scrape -> persistent queue -> remote write), every
service-discovery provider against fake API servers, vmalert (alerting
and recording rules, notifier, remote write, replay, state restore, the
alerting clock), vmalert_tool, vmauth with JWT (HS256/384/512 and RS256
on a seeded key), vmbackup/vmrestore (fs, and S3, GCS and Azure Blob
fakes) and vmctl (vm-native, remote read, file imports).

Every case of ``tests/test_satellites.py`` for these parts, and the
vmalert cases of ``tests/test_deterministic_time.py``, is written once and
run on both packages through the ``pkg`` fixture (``ref`` = the JAX
package, ``port`` = victoriametrics_tpu_torch); the port's run also runs
the reference's and holds the two results equal: rows, alert states,
queued blocks and targets.  Data sits inside the default retention (a
day-aligned anchor two days back, not the reference's fixed July 2025).

Then the port's vmsingle ``-rule``: the group armed from a JSON rule
file, its rows in the store, and the EngineDatasource == HTTP poll
contract with the port's ``CUDAEngine(device="cpu", min_series=4)``
attached (the kernels' plain versions, whose calls are counted), and the
apps as processes with jax, the JAX package, xxhash and PyYAML
blocked, configured with JSON files.
"""

import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.parse
import urllib.request

import numpy as np
import pytest

from tests.apptest_helpers import Client, free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAY = 86_400_000
#: a day-aligned anchor two days back: inside the default retention
T0 = (int(time.time() * 1000) - 2 * DAY) // DAY * DAY


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu.apps import (vmagent, vmalert,
                                              vmalert_tool, vmauth,
                                              vmbackup, vmctl, vmsingle)
        from victoriametrics_tpu.httpapi.server import HTTPServer, Response
        from victoriametrics_tpu.ingest import (discovery, persistentqueue,
                                                remote_write)
        from victoriametrics_tpu.ops import decimal as dec
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import filters_from_dict
        from victoriametrics_tpu.utils import jwt, profiler
        host = []
    else:
        from victoriametrics_tpu_torch.apps import (vmagent, vmalert,
                                                    vmalert_tool, vmauth,
                                                    vmbackup, vmctl,
                                                    vmsingle)
        from victoriametrics_tpu_torch.httpapi.server import (HTTPServer,
                                                              Response)
        from victoriametrics_tpu_torch.ingest import (discovery,
                                                      persistentqueue,
                                                      remote_write)
        from victoriametrics_tpu_torch.ops import decimal as dec
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import \
            filters_from_dict
        from victoriametrics_tpu_torch.utils import jwt, profiler
        host = ["-search.tpuBackend=false"]  # no card on the CPU
    return types.SimpleNamespace(
        name=name, vmagent=vmagent, vmalert=vmalert,
        vmalert_tool=vmalert_tool, vmsingle=vmsingle, HTTPServer=HTTPServer,
        Response=Response, discovery=discovery,
        PersistentQueue=persistentqueue.PersistentQueue,
        remote_write=remote_write, dec=dec, profiler=profiler, host=host,
        vmauth=vmauth, vmbackup=vmbackup, vmctl=vmctl, jwt=jwt,
        Storage=Storage, filters_from_dict=filters_from_dict)


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return REF if request.param == "ref" else PORT


class Single:
    """The package's vmsingle in process on a free port."""

    def __init__(self, P, path, flags=()):
        self.P = P
        self.storage, self.srv, self.api = P.vmsingle.build(
            P.vmsingle.parse_flags([f"-storageDataPath={path}",
                                    "-httpListenAddr=127.0.0.1:0",
                                    *P.host, *flags]))
        self.srv.start()
        self.client = Client(self.srv.port)
        self.base = self.client.base

    def close(self):
        for g in getattr(self.api, "rule_groups", []):
            g.stop()
        self.srv.stop()
        self.storage.close()
        self.P.profiler.PROFILER.stop()


def both(case, pkg, tmp_path, *args):
    """Run ``case`` on the package; on the port also on the reference,
    the two results equal."""
    got = case(pkg, tmp_path / pkg.name, *args)
    if pkg is PORT:
        assert got == case(REF, tmp_path / "ref", *args)
    return got


def _serve(P, routes):
    srv = P.HTTPServer("127.0.0.1", 0)
    for path, fn in routes.items():
        srv.route(path, fn)
    srv.start()
    return srv


# -- the persistent queue ----------------------------------------------------

def _queue_fifo(P, tmp):
    q = P.PersistentQueue(str(tmp / "q"))
    for i in range(100):
        q.put(f"block{i}".encode())
    got = [q.get(0.1) for _ in range(100)]
    assert got == [f"block{i}".encode() for i in range(100)]
    assert q.get(0.05) is None
    q.close()
    return got


def _queue_restart(P, tmp):
    q = P.PersistentQueue(str(tmp / "q"), max_inmemory_blocks=2)
    for i in range(10):
        q.put(f"b{i}".encode())
    assert q.get(0.1) == b"b0"
    q.close()  # spills the RAM front to disk
    q2 = P.PersistentQueue(str(tmp / "q"))
    rest = []
    while (b := q2.get(0.05)) is not None:
        rest.append(b)
    assert rest == [f"b{i}".encode() for i in range(1, 10)]
    q2.close()
    return rest


def _queue_truncated(P, tmp):
    q = P.PersistentQueue(str(tmp / "q"), max_inmemory_blocks=0)
    q.put(b"good")
    q.close()
    # a crash mid-write: a truncated record after the good one
    chunk = [f for f in os.listdir(tmp / "q") if f.startswith("chunk_")][0]
    with open(tmp / "q" / chunk, "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")
    q2 = P.PersistentQueue(str(tmp / "q"))
    got = [q2.get(0.1), q2.get(0.05)]
    assert got == [b"good", None]
    q2.close()
    return got


@pytest.mark.parametrize("case", [_queue_fifo, _queue_restart,
                                  _queue_truncated],
                         ids=["fifo", "restart", "truncated_tail"])
def test_persistent_queue(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- vmagent -----------------------------------------------------------------

def _agent_scrape(P, tmp):
    single = Single(P, tmp / "data")
    exporter = _serve(P, {"/metrics": lambda req: P.Response.text(
        'fake_metric{src="exp"} 42.5\n')})
    cfg = {"scrape_configs": [{
        "job_name": "testjob", "scrape_interval": "1s",
        "static_configs": [{"targets": [f"127.0.0.1:{exporter.port}"]}]}]}
    agent = P.vmagent.VMAgent(cfg, [single.base + "/api/v1/write"],
                              str(tmp / "agent"))
    agent.start()
    try:
        deadline = time.time() + 20
        res = None
        while time.time() < deadline:
            res = single.client.query("fake_metric")
            if res["data"]["result"]:
                break
            time.sleep(0.5)
        assert res["data"]["result"], "scraped metric never arrived"
        r = res["data"]["result"][0]
        up = single.client.query("up")["data"]["result"][0]["value"][1]
        status = agent.target_status()[0]
        out = (r["metric"], r["value"][1], up, status["health"],
               status["labels"])
        assert out[:4] == ({"__name__": "fake_metric", "job": "testjob",
                            "instance": f"127.0.0.1:{exporter.port}",
                            "src": "exp"}, "42.5", "1", "up")
    finally:
        agent.stop()
        exporter.stop()
        single.close()
    # the exporter's port differs between the two runs
    return (out[1], out[2], out[3], sorted(out[0]))


def _agent_queue(P, tmp):
    """A block pushed while the remote is down stays queued (its sender
    retries with backoff) and is delivered whole once the remote is up."""
    port = free_ports(1)[0]
    ctx = P.vmagent.RemoteWriteCtx(f"http://127.0.0.1:{port}/api/v1/write",
                                   str(tmp / "q"), flush_interval=0.1)
    ctx.start()
    rows = [({"__name__": "m", "i": str(i)}, T0 + i, float(i))
            for i in range(5)]
    ctx.push(rows)
    deadline = time.time() + 10
    while ctx.send_errors < 1 and time.time() < deadline:
        time.sleep(0.05)
    assert ctx.send_errors >= 1 and ctx.sent_rows == 0
    assert ctx.queue.pending >= 0  # parked, no crash
    bodies = []

    def h(req):
        bodies.append(req.body)
        return P.Response(204, b"")
    remote = P.HTTPServer("127.0.0.1", port)
    remote.route("/api/v1/write", h)
    remote.start()
    try:
        deadline = time.time() + 30
        while ctx.sent_rows < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert ctx.sent_rows == 1 and len(bodies) == 1
    finally:
        ctx.stop()
        remote.stop()
    # the server decompressed the snappy body on the way in
    got = [(sorted(labels), samples) for labels, samples in
           P.remote_write.parse_write_request(bodies[0], encoding="")]
    want = [(sorted(lb.items()), [(ts, v)]) for lb, ts, v in rows]
    assert sorted(got) == sorted(want)
    return sorted(got)


def _agent_staleness(P, tmp):
    state = {"n": 2}
    srv = _serve(P, {"/metrics": lambda req: P.Response.text(
        "".join(f'g{{i="{i}"}} 1\n' for i in range(state["n"])))})
    got = []
    t = P.vmagent.ScrapeTarget(f"http://127.0.0.1:{srv.port}/metrics",
                               {"job": "j"}, 1000, 5, None, got.extend)
    stale = lambda rows: [r for r in rows if P.dec.is_stale_nan(  # noqa
        np.array([r[2]])).any()]
    t._scrape_once()
    out = [sum(1 for r in got if r[0].get("__name__") == "g")]
    assert out == [2]
    got.clear()
    state["n"] = 1  # one series vanishes
    t._scrape_once()
    s = [r for r in stale(got) if r[0].get("__name__") == "g"]
    assert len(s) == 1 and s[0][0]["i"] == "1"
    out.append(sorted(s[0][0].items()))
    # a failed scrape: everything goes stale
    got.clear()
    srv.stop()
    t._scrape_once()
    assert len(stale(got)) == 1  # the remaining g series
    up = [r for r in got if r[0].get("__name__") == "up"]
    assert up and up[0][2] == 0.0
    # stop() stales the auto metrics even after a failed last scrape
    got.clear()
    t.stop(send_stale=True)
    names = sorted(r[0]["__name__"] for r in got)
    assert names == ["scrape_duration_seconds", "scrape_samples_scraped",
                     "up"]
    assert len(stale(got)) == len(got)
    return out + [names]


def _agent_large_body(P, tmp):
    body = "".join(f'big{{i="{i}"}} {i}\n' for i in range(60_000))
    assert len(body) > (1 << 20)  # beyond one read chunk
    srv = _serve(P, {"/metrics": lambda req: P.Response.text(body)})
    batches = []
    t = P.vmagent.ScrapeTarget(f"http://127.0.0.1:{srv.port}/metrics",
                               {"job": "big"}, 1000, 30, None,
                               batches.append)
    t._scrape_once()
    srv.stop()
    vals = [r[2] for b in batches for r in b if r[0].get("__name__") == "big"]
    assert len(vals) == 60_000 and len(batches) > 2  # streamed in chunks
    return (len(batches), sum(vals))


def _agent_target_sync(P, tmp):
    cfg = {"scrape_configs": [{
        "job_name": "k",
        "static_configs": [{"targets": ["1.2.3.4:9100"]}],
        "relabel_configs": [{"source_labels": ["__address__"],
                             "target_label": "box"}]}]}
    a = P.vmagent.VMAgent(cfg, [], str(tmp))
    assert len(a.targets) == 1
    t = list(a.targets.values())[0]
    assert t.labels == {"job": "k", "box": "1.2.3.4:9100",
                        "instance": "1.2.3.4:9100"}
    assert t.url == "http://1.2.3.4:9100/metrics"
    out = [(t.url, sorted(t.labels.items()))]
    a.reload({"scrape_configs": []})  # the reload removes the target
    assert a.targets == {}
    a.stop()
    return out


@pytest.mark.parametrize("case", [_agent_scrape, _agent_queue,
                                  _agent_staleness, _agent_large_body,
                                  _agent_target_sync],
                         ids=["scrape_to_remote_write",
                              "queue_buffers_while_remote_down",
                              "staleness", "stream_parse_large_body",
                              "target_sync_relabel_and_removal"])
def test_vmagent(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- service discovery ------------------------------------------------------

def _sd_kubernetes_consul(P, tmp):
    pods = {"items": [{
        "metadata": {"name": "p1", "namespace": "ns1",
                     "labels": {"app": "web"}},
        "spec": {"nodeName": "n1",
                 "containers": [{"ports": [{"containerPort": 9100,
                                            "name": "metrics"}]}]},
        "status": {"podIP": "10.0.0.5", "phase": "Running"}}]}
    srv = _serve(P, {
        "/api/v1/pods": lambda r: P.Response.json(pods),
        "/v1/catalog/services": lambda r: P.Response.json({"web": ["prod"]}),
        "/v1/health/service/web": lambda r: P.Response.json([
            {"Node": {"Node": "c1", "Address": "10.1.1.1",
                      "Datacenter": "dc1"},
             "Service": {"Service": "web", "Address": "10.1.1.2",
                         "Port": 8080, "Tags": ["prod"]}}])})
    try:
        k8s = P.discovery.kubernetes_sd({
            "api_server": f"http://127.0.0.1:{srv.port}", "role": "pod"})
        consul = P.discovery.consul_sd({"server": f"127.0.0.1:{srv.port}"})
    finally:
        srv.stop()
    assert k8s == [("10.0.0.5:9100", {
        "__meta_kubernetes_namespace": "ns1",
        "__meta_kubernetes_pod_name": "p1",
        "__meta_kubernetes_pod_ip": "10.0.0.5",
        "__meta_kubernetes_pod_node_name": "n1",
        "__meta_kubernetes_pod_phase": "Running",
        "__meta_kubernetes_pod_label_app": "web",
        "__meta_kubernetes_pod_container_port_number": "9100",
        "__meta_kubernetes_pod_container_port_name": "metrics"})]
    assert consul == [("10.1.1.2:8080", {
        "__meta_consul_service": "web", "__meta_consul_node": "c1",
        "__meta_consul_address": "10.1.1.1",
        "__meta_consul_service_address": "10.1.1.2",
        "__meta_consul_service_port": "8080",
        "__meta_consul_tags": ",prod,", "__meta_consul_dc": "dc1"})]
    return k8s, consul


def _sd_http(P, tmp):
    seen_auth = []

    def h(r):
        seen_auth.append(r.headers.get("authorization", ""))
        return P.Response.json([
            {"targets": ["10.0.0.1:9100", "10.0.0.2:9100"],
             "labels": {"env": "prod"}},
            {"targets": ["10.0.0.3:8080"]}])
    srv = _serve(P, {"/sd": h})
    url = f"http://127.0.0.1:{srv.port}/sd"
    try:
        out = P.discovery.http_sd({"url": url, "bearer_token": "tk"})
    finally:
        srv.stop()
    assert seen_auth == ["Bearer tk"]
    assert out == [
        ("10.0.0.1:9100", {"__meta_env": "prod", "__meta_url": url}),
        ("10.0.0.2:9100", {"__meta_env": "prod", "__meta_url": url}),
        ("10.0.0.3:8080", {"__meta_url": url})]
    return [(a, sorted(k for k in m if k != "__meta_url")) for a, m in out]


def _fake_dns(sock, answers: int):
    """A UDP DNS server answering SRV (with name compression) and A."""
    for _ in range(answers):
        try:
            data, addr = sock.recvfrom(4096)
        except OSError:
            return
        qtype = struct.unpack(">H", data[-4:-2])[0]
        hdr = data[:2] + struct.pack(">HHHHH", 0x8180, 1,
                                     2 if qtype == 33 else 1, 0, 0)
        if qtype == 33:  # two SRV records, target via pointer + label
            rr = b""
            for prt, tgt in ((9100, b"\x05node1"), (9200, b"\x05node2")):
                rdata = struct.pack(">HHH", 10, 5, prt) + tgt + b"\xc0\x0c"
                rr += b"\xc0\x0c" + struct.pack(
                    ">HHIH", 33, 1, 300, len(rdata)) + rdata
        elif qtype == 1:  # one A record
            rr = b"\xc0\x0c" + struct.pack(">HHIH", 1, 1, 300, 4) + \
                bytes([10, 1, 2, 3])
        else:
            continue
        sock.sendto(hdr + data[12:] + rr, addr)


def _sd_dns(P, tmp):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    threading.Thread(target=_fake_dns, args=(sock, 4), daemon=True).start()
    try:
        srv_out = P.discovery.dns_sd({
            "names": ["_metrics._tcp.example.org"],
            "resolver": f"127.0.0.1:{port}"})
        a_out = P.discovery.dns_sd({
            "names": ["web.example.org"], "type": "A", "port": 9090,
            "resolver": f"127.0.0.1:{port}"})
    finally:
        sock.close()
    name = "_metrics._tcp.example.org"
    assert srv_out == [
        (f"node{i}.{name}:{p}",
         {"__meta_dns_name": name,
          "__meta_dns_srv_record_target": f"node{i}.{name}",
          "__meta_dns_srv_record_port": str(p)})
        for i, p in ((1, 9100), (2, 9200))]
    assert a_out == [("10.1.2.3:9090", {"__meta_dns_name": "web.example.org"})]
    return srv_out, a_out


def _sd_dns_malformed(P, tmp):
    """Garbage datagrams surface as DiscoveryError (the last-known-good
    fallback), never as an IndexError killing the SD loop."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]

    def serve():
        try:
            data, addr = sock.recvfrom(4096)
            sock.sendto(data[:2] + b"\x81\x80\x00\x01\x00\x05", addr)
        except OSError:
            pass
    threading.Thread(target=serve, daemon=True).start()
    try:
        with pytest.raises(P.discovery.DiscoveryError) as ei:
            P.discovery.dns_sd({"names": ["x.example.org"], "type": "A",
                                "port": 1, "resolver": f"127.0.0.1:{port}"})
    finally:
        sock.close()
    return type(ei.value).__name__


def _sd_docker(P, tmp):
    containers = [{
        "Id": "abc123", "Names": ["/web-1"], "State": "running",
        "Labels": {"com.example.app": "web"},
        "Ports": [{"PrivatePort": 8080, "PublicPort": 32768,
                   "Type": "tcp"}],
        "NetworkSettings": {"Networks": {
            "bridge": {"IPAddress": "172.17.0.2"}}},
    }, {
        "Id": "def456", "Names": ["/db-1"], "State": "running",
        "Labels": {}, "Ports": [],
        "NetworkSettings": {"Networks": {
            "bridge": {"IPAddress": "172.17.0.3"}}},
    }]
    srv = _serve(P, {"/containers/json":
                     lambda r: P.Response.json(containers)})
    try:
        out = P.discovery.docker_sd(
            {"host": f"tcp://127.0.0.1:{srv.port}", "port": 9323})
    finally:
        srv.stop()
    assert out[0][0] == "172.17.0.2:8080"
    assert out[0][1]["__meta_docker_container_name"] == "/web-1"
    assert out[0][1]["__meta_docker_container_label_com_example_app"] == \
        "web"
    assert out[0][1]["__meta_docker_port_public"] == "32768"
    assert out[1][0] == "172.17.0.3:9323"  # no ports -> the config's port
    return out


def _sd_docker_unix(P, tmp):
    import http.server
    import socketserver
    tmp.mkdir(parents=True, exist_ok=True)
    spath = str(tmp / "docker.sock")

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = (b'[{"Id":"x","Names":["/u1"],"State":"running",'
                    b'"Ports":[{"PrivatePort":80}],"NetworkSettings":'
                    b'{"Networks":{"bridge":{"IPAddress":"10.9.9.9"}}}}]')
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    usrv = socketserver.UnixStreamServer(spath, H)
    threading.Thread(target=usrv.serve_forever, daemon=True).start()
    try:
        out = P.discovery.docker_sd({"host": f"unix://{spath}"})
    finally:
        usrv.shutdown()
        usrv.server_close()
    assert out == [("10.9.9.9:80", {
        "__meta_docker_container_id": "x",
        "__meta_docker_container_name": "/u1",
        "__meta_docker_container_state": "running",
        "__meta_docker_network_name": "bridge",
        "__meta_docker_network_ip": "10.9.9.9",
        "__meta_docker_port_private": "80"})]
    return out


def _sd_gce(P, tmp):
    page1 = {"items": [{
        "id": 111, "name": "vm-a", "status": "RUNNING",
        "machineType": ".../machineTypes/e2-small",
        "networkInterfaces": [{
            "networkIP": "10.128.0.2", "network": ".../networks/default",
            "accessConfigs": [{"natIP": "34.1.2.3"}]}],
        "metadata": {"items": [{"key": "team", "value": "infra"}]},
        "tags": {"items": ["metrics"]},
    }], "nextPageToken": "p2"}
    page2 = {"items": [{
        "id": 222, "name": "vm-b", "status": "RUNNING",
        "machineType": ".../machineTypes/e2-micro",
        "networkInterfaces": [{"networkIP": "10.128.0.3",
                               "network": ".../networks/default"}],
    }]}
    srv = _serve(P, {"/compute/v1/projects/pr1/zones/us-a/instances":
                     lambda r: P.Response.json(
                         page2 if r.arg("pageToken") else page1)})
    try:
        out = P.discovery.gce_sd({
            "project": "pr1", "zone": "us-a", "port": 9100,
            "api_server": f"http://127.0.0.1:{srv.port}"})
    finally:
        srv.stop()
    assert [a for a, _ in out] == ["10.128.0.2:9100", "10.128.0.3:9100"]
    m = out[0][1]
    assert m["__meta_gce_instance_name"] == "vm-a"
    assert m["__meta_gce_machine_type"] == "e2-small"
    assert m["__meta_gce_public_ip"] == "34.1.2.3"
    assert m["__meta_gce_metadata_team"] == "infra"
    assert m["__meta_gce_tags"] == ",metrics,"
    return out


def _sd_azure(P, tmp):
    seen = {}

    def token_h(r):
        seen["grant"] = r.arg("grant_type")
        seen["client"] = r.arg("client_id")
        return P.Response.json({"access_token": "azt"})

    vm_id = ("/subscriptions/s1/resourceGroups/rg1/providers/"
             "Microsoft.Compute/virtualMachines/vm1")
    nic_id = ("/subscriptions/s1/resourceGroups/rg1/providers/"
              "Microsoft.Network/networkInterfaces/nic1")
    vms = {"value": [{
        "id": vm_id, "name": "vm1", "location": "westeurope",
        "tags": {"env": "prod"},
        "properties": {
            "storageProfile": {"osDisk": {"osType": "Linux"}},
            "networkProfile": {"networkInterfaces": [{"id": nic_id}]}}}]}
    nic = {"properties": {"ipConfigurations": [
        {"properties": {"privateIPAddress": "10.2.3.4"}}]}}

    def vms_h(r):
        seen["auth"] = r.headers.get("authorization", "")
        return P.Response.json(vms)
    srv = _serve(P, {
        "/token": token_h,
        "/subscriptions/s1/providers/Microsoft.Compute/virtualMachines":
            vms_h,
        nic_id: lambda r: P.Response.json(nic)})
    base = f"http://127.0.0.1:{srv.port}"
    try:
        out = P.discovery.azure_sd({
            "subscription_id": "s1", "client_id": "cid",
            "client_secret": "cs", "tenant_id": "t1", "port": 9100,
            "api_server": base, "token_url": f"{base}/token"})
    finally:
        srv.stop()
    assert (seen["grant"], seen["auth"]) == ("client_credentials",
                                             "Bearer azt")
    assert out[0][0] == "10.2.3.4:9100"
    m = out[0][1]
    assert m["__meta_azure_machine_name"] == "vm1"
    assert m["__meta_azure_machine_resource_group"] == "rg1"
    assert m["__meta_azure_machine_os_type"] == "Linux"
    assert m["__meta_azure_machine_tag_env"] == "prod"
    assert m["__meta_azure_machine_private_ip"] == "10.2.3.4"
    return out, seen


def _sd_ec2(P, tmp):
    seen = {}
    xml = """<?xml version="1.0"?>
<DescribeInstancesResponse xmlns="http://ec2.amazonaws.com/doc/2013-10-15/">
 <reservationSet><item><instancesSet><item>
  <instanceId>i-123</instanceId><instanceType>t3.micro</instanceType>
  <privateIpAddress>172.1.2.3</privateIpAddress>
  <instanceState><name>running</name></instanceState>
  <placement><availabilityZone>us-east-1a</availabilityZone></placement>
  <tagSet><item><key>Name</key><value>api</value></item></tagSet>
 </item></instancesSet></item></reservationSet>
</DescribeInstancesResponse>"""

    def h(req):
        seen["auth"] = req.headers.get("Authorization", "")
        return P.Response(200, xml.encode(), "text/xml")
    srv = _serve(P, {"/": h})
    try:
        out = P.discovery.ec2_sd({
            "endpoint": f"http://127.0.0.1:{srv.port}/",
            "region": "us-east-1", "port": 9100,
            "access_key": "AKID", "secret_key": "SECRET"})
    finally:
        srv.stop()
    assert out == [("172.1.2.3:9100", {
        "__meta_ec2_instance_id": "i-123",
        "__meta_ec2_private_ip": "172.1.2.3",
        "__meta_ec2_instance_type": "t3.micro",
        "__meta_ec2_availability_zone": "us-east-1a",
        "__meta_ec2_instance_state": "running",
        "__meta_ec2_tag_Name": "api"})]
    assert seen["auth"].startswith("AWS4-HMAC-SHA256 Credential=AKID/")
    return out


def _sd_last_good(P, tmp):
    calls = {"n": 0}

    def flaky(cfg):
        calls["n"] += 1
        if calls["n"] == 2:
            raise P.discovery.DiscoveryError("api down")
        return [("1.1.1.1:80", {"__meta_x": "y"})]
    old = P.discovery.PROVIDERS.get("consul_sd_configs")
    P.discovery.PROVIDERS["consul_sd_configs"] = flaky
    try:
        lg = {}
        sc = {"consul_sd_configs": [{"server": "x"}]}
        t1 = P.discovery.discover_targets(sc, lg)
        t2 = P.discovery.discover_targets(sc, lg)  # the provider errors
    finally:
        P.discovery.PROVIDERS["consul_sd_configs"] = old
    assert t1 == t2 == [("1.1.1.1:80", {"__meta_x": "y"})]
    return t1, t2


SD_CASES = {"kubernetes_and_consul": _sd_kubernetes_consul,
            "http": _sd_http, "dns": _sd_dns,
            "dns_malformed_response_degrades": _sd_dns_malformed,
            "docker": _sd_docker, "docker_unix_socket": _sd_docker_unix,
            "gce_with_pagination": _sd_gce,
            "azure_with_token_and_nic": _sd_azure,
            "ec2_with_sigv4": _sd_ec2,
            "error_keeps_last_good_targets": _sd_last_good}


@pytest.mark.parametrize("name", SD_CASES)
def test_service_discovery(pkg, tmp_path, name):
    both(SD_CASES[name], pkg, tmp_path)


def test_every_discovery_provider_is_ported():
    assert sorted(PORT.discovery.PROVIDERS) == sorted(REF.discovery.PROVIDERS)


# -- vmalert -----------------------------------------------------------------

def _alertmanager(P):
    received = []

    def h(req):
        received.extend(json.loads(req.body))
        return P.Response.json({})
    return _serve(P, {"/api/v2/alerts": h}), received


def _alert_and_record(P, tmp):
    single = Single(P, tmp / "data")
    now = (int(time.time()) // 60) * 60.0
    single.storage.add_rows([({"__name__": "errs", "job": "api"},
                              int((now - 60 + i * 5) * 1000), 100.0 + i)
                             for i in range(13)])
    am, received = _alertmanager(P)
    (tmp / "rules.json").write_text(json.dumps({"groups": [{
        "name": "g", "interval": "1s", "rules": [
            {"alert": "ErrsHigh", "expr": "errs > 50", "for": "0s",
             "labels": {"severity": "crit"},
             "annotations": {"summary": "errs on {{ $labels.job }}"}},
            {"record": "job:errs:last", "expr": "sum by (job) (errs)"}]}]}))
    groups, srv = P.vmalert.build(P.vmalert.parse_flags([
        f"-rule={tmp / 'rules.json'}", f"-datasource.url={single.base}",
        f"-notifier.url=http://127.0.0.1:{am.port}",
        f"-remoteWrite.url={single.base}", "-httpListenAddr=127.0.0.1:0"]))
    srv.start()
    try:
        groups[0].eval_once(now)
        assert received, "no alert notification sent"
        a = received[0]
        assert a["labels"] == {"alertname": "ErrsHigh", "severity": "crit",
                               "job": "api"}
        assert "api" in a["annotations"]["summary"]
        rec = single.client.query("job:errs:last", now)["data"]["result"]
        assert rec[0]["metric"]["job"] == "api"
        alerts = single.client.query("ALERTS", now)["data"]["result"]
        assert alerts[0]["metric"]["alertstate"] == "firing"
        code, body = Client(srv.port).get("/api/v1/rules")
        data = json.loads(body)["data"]["groups"][0]
        assert data["rules"][0]["state"] == "firing"
        code, body = Client(srv.port).get("/api/v1/alerts")
        listed = json.loads(body)["data"]["alerts"]
    finally:
        srv.stop()
        am.stop()
        single.close()
    return (a["labels"], a["annotations"], rec, alerts, data,
            [(x["labels"], x["state"], x["value"]) for x in listed])


def _alert_pending(P, tmp):
    single = Single(P, tmp / "data")
    now = time.time()
    single.storage.add_rows([({"__name__": "g1m"},
                              int((now - 30 + i * 5) * 1000), 99.0)
                             for i in range(7)])
    (tmp / "r.json").write_text(json.dumps({"groups": [{
        "name": "g", "rules": [
            {"alert": "A", "expr": "g1m > 1", "for": "1h"}]}]}))
    groups, srv = P.vmalert.build(P.vmalert.parse_flags([
        f"-rule={tmp / 'r.json'}", f"-datasource.url={single.base}",
        "-httpListenAddr=127.0.0.1:0"]))
    try:
        groups[0].eval_once(time.time())
        states = [s["state"] for s in groups[0].rules[0]._active.values()]
        assert states == ["pending"]  # `for` not yet satisfied
    finally:
        srv.stop()
        single.close()
    return states


def _alert_replay(P, tmp):
    single = Single(P, tmp / "data")
    # a counter over a 30-minute historic window
    single.storage.add_rows([({"__name__": "rc", "i": "1"},
                              T0 + j * 15_000, 150.0 * j)
                             for j in range(121)])
    ds = P.vmalert.Datasource(single.base)
    rw = P.vmalert.RemoteWriter(single.base)
    g = P.vmalert.Group({"name": "g", "interval": "5m", "rules": [
        {"record": "rc:rate5m", "expr": "rate(rc[5m])"}]}, ds, [], rw)
    try:
        n = P.vmalert.replay([g], T0 + 600_000, T0 + 1_500_000)
        assert n == 4  # 15 minutes at 5 m, inclusive
        res = single.client.query_range(
            "rc:rate5m", (T0 + 600_000) / 1e3, (T0 + 1_500_000) / 1e3,
            300)["data"]["result"]
    finally:
        single.close()
    assert len(res) == 1
    assert {v for _, v in res[0]["values"]} == {"10"}  # 150 / 15 s
    return res


def _alert_restore(P, tmp):
    single = Single(P, tmp / "data")
    now = (int(time.time()) // 60) * 60.0
    active_at = now - 120  # pending for two minutes before the restart
    single.storage.add_rows([
        ({"__name__": "ALERTS_FOR_STATE", "alertname": "HighLoad",
          "sev": "warn"}, int((now - 30) * 1000), active_at),
        ({"__name__": "trigger_metric"}, int(now * 1000), 1.0)])
    ds = P.vmalert.Datasource(single.base)
    g = P.vmalert.Group({"name": "g", "rules": [
        {"alert": "HighLoad", "expr": "trigger_metric > 0",
         "for": "3m", "labels": {"sev": "warn"}}]}, ds, [], None)
    try:
        g.restore(ds)
        rule = g.rules[0]
        assert len(rule._active) == 1
        st = list(rule._active.values())[0]
        assert abs(st["activeAt"] - active_at) < 1.0
        g.eval_once(now)  # still pending: 3 m not reached
        st = list(rule._active.values())[0]
        states = [st["state"]]
        assert states == ["pending"] and \
            abs(st["activeAt"] - active_at) < 1.0
        g.eval_once(now + 70)  # the restored clock crosses `for`
        states.append(list(rule._active.values())[0]["state"])
        assert states == ["pending", "firing"]
    finally:
        single.close()
    return states, st["labels"], st["activeAt"] - now


@pytest.mark.parametrize("case", [_alert_and_record, _alert_pending,
                                  _alert_replay, _alert_restore],
                         ids=["alerting_and_recording",
                              "pending_state_honors_for",
                              "replay_writes_historic_recordings",
                              "state_restore"])
def test_vmalert(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


class FakeDS:
    def __init__(self):
        self.results = []

    def query(self, expr, now):
        return list(self.results)


def _clock_rule(P, for_s):
    class G:
        name = "g"
        interval = 30.0
    return P.vmalert.AlertingRule(
        {"alert": "HighLoad", "expr": "up == 0", "for": f"{for_s}s",
         "labels": {"sev": "page"}}, G())


def _clock_resolved(P, tmp):
    ds = FakeDS()
    ds.results = [{"metric": {"instance": "h1"}, "value": 1.0}]
    r = _clock_rule(P, 300)
    t = T0 / 1e3
    states = []
    for dt in (0, 299, 300):  # one second short of `for`, then on it
        states.append([s["state"] for s in r.eval(ds, t + dt)])
    ds.results = []  # the condition clears
    states.append(r.eval(ds, t + 330))
    assert states == [["pending"], ["pending"], ["firing"], []]
    return states


def _clock_flapping(P, tmp):
    ds = FakeDS()
    ds.results = [{"metric": {"instance": "h1"}, "value": 1.0}]
    r = _clock_rule(P, 300)
    t = T0 / 1e3
    r.eval(ds, t)
    ds.results = []
    r.eval(ds, t + 200)  # clears before firing
    ds.results = [{"metric": {"instance": "h1"}, "value": 1.0}]
    states = [[s["state"] for s in r.eval(ds, t + 290 + dt)]
              for dt in (0, 299, 300)]  # the timer restarts
    assert states == [["pending"], ["pending"], ["firing"]]
    return states


def _clock_restore(P, tmp):
    t = T0 / 1e3

    class RestoreDS:
        def query(self, expr, now):
            if "ALERTS_FOR_STATE" in expr:
                return [{"metric": {"alertname": "HighLoad",
                                    "instance": "h1", "sev": "page"},
                         "value": t}]
            return [{"metric": {"instance": "h1"}, "value": 1.0}]

    r = _clock_rule(P, 300)
    ds = RestoreDS()
    r.restore(ds, t + 200, lookback_s=3600)
    assert len(r._active) == 1
    # 300 s after the ORIGINAL activeAt it fires
    st = r.eval(ds, t + 300)
    assert [s["state"] for s in st] == ["firing"]
    return [(s["state"], s["activeAt"], s["labels"]) for s in st]


@pytest.mark.parametrize("case", [_clock_resolved, _clock_flapping,
                                  _clock_restore],
                         ids=["pending_to_firing_to_resolved",
                              "flapping_resets_pending_timer",
                              "restore_preserves_active_at"])
def test_alerting_clock(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- vmalert_tool ------------------------------------------------------------

def _tool_unittest(P, tmp):
    tmp.mkdir(parents=True, exist_ok=True)
    tool = P.vmalert_tool
    assert tool.parse_series_values("0+10x3") == [0, 10, 20, 30]
    assert tool.parse_series_values("5x2") == [5, 5, 5]
    (tmp / "rules.json").write_text(json.dumps({"groups": [{
        "name": "g", "rules": [{"alert": "High", "expr": "m > 15",
                                "for": "0s", "labels": {"sev": "crit"}}]}]}))
    (tmp / "t1.json").write_text(json.dumps({
        "rule_files": ["rules.json"],
        "tests": [{
            "interval": "1m",
            "input_series": [{"series": 'm{job="x"}', "values": "0+10x10"}],
            "alert_rule_test": [{
                "eval_time": "5m", "alertname": "High",
                "exp_alerts": [{"exp_labels": {"job": "x", "sev": "crit"}}]}],
            "metricsql_expr_test": [{
                "expr": "m", "eval_time": "3m",
                "exp_samples": [{"value": 30}]}]}]}))
    assert tool.run_test_file(str(tmp / "t1.json")) == []
    (tmp / "t2.json").write_text(json.dumps({
        "rule_files": ["rules.json"],
        "tests": [{
            "interval": "1m",
            "input_series": [{"series": "m", "values": "0x10"}],
            "alert_rule_test": [{
                "eval_time": "5m", "alertname": "High",
                "exp_alerts": [{"exp_labels": {"sev": "crit"}}]}]}]}))
    fails = tool.run_test_file(str(tmp / "t2.json"))
    assert fails and "High" in fails[0]
    return fails


def test_vmalert_tool_unittest_pass_and_fail(pkg, tmp_path):
    both(_tool_unittest, pkg, tmp_path)


# -- vmauth and JWT ----------------------------------------------------------

#: a fixed clock for the tokens' exp/nbf claims
JWT_NOW = 1_800_000_000.0


def _b64u(b: bytes) -> str:
    import base64
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _hs_token(secret, claims, alg="HS256"):
    import hashlib
    import hmac
    digest = {"HS256": hashlib.sha256, "HS384": hashlib.sha384,
              "HS512": hashlib.sha512}[alg]
    h = _b64u(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    p = _b64u(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{h}.{p}".encode(), digest).digest()
    return f"{h}.{p}.{_b64u(sig)}"


def _rsa_key(seed: int, bits: int = 1024):
    """A seeded RSA key (n, e, d): two probable primes (Fermat on twelve
    bases), e = 65537."""
    import math
    import random
    rnd = random.Random(seed)

    def prime():
        while True:
            c = rnd.getrandbits(bits // 2) | (3 << (bits // 2 - 2)) | 1
            if all(pow(a, c - 1, c) == 1
                   for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)):
                return c
    e = 65537
    while True:
        p, q = prime(), prime()
        phi = (p - 1) * (q - 1)
        if p != q and math.gcd(e, phi) == 1:
            return p * q, e, pow(e, -1, phi)


def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 128:
        return bytes([tag, n]) + body
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + body


def _rsa_pems(n: int, e: int) -> tuple[str, str]:
    """(SPKI "PUBLIC KEY", PKCS#1 "RSA PUBLIC KEY") PEMs of (n, e)."""
    import base64

    def der_int(x):
        return _der(0x02, x.to_bytes(x.bit_length() // 8 + 1, "big"))

    def pem(kind, der):
        body = base64.b64encode(der).decode()
        lines = [body[i:i + 64] for i in range(0, len(body), 64)]
        return "\n".join([f"-----BEGIN {kind}-----", *lines,
                          f"-----END {kind}-----"])
    pkcs1 = _der(0x30, der_int(n) + der_int(e))
    alg = _der(0x30, _der(0x06, bytes.fromhex("2a864886f70d010101")) +
               _der(0x05, b""))
    spki = _der(0x30, alg + _der(0x03, b"\x00" + pkcs1))
    return pem("PUBLIC KEY", spki), pem("RSA PUBLIC KEY", pkcs1)


def _rs_token(key, claims):
    """An RS256 token (RSASSA-PKCS1-v1_5 over SHA-256) signed with key's d."""
    import hashlib
    n, _, d = key
    k = (n.bit_length() + 7) // 8
    h = _b64u(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    p = _b64u(json.dumps(claims).encode())
    info = bytes.fromhex("3031300d060960864801650304020105000420") + \
        hashlib.sha256(f"{h}.{p}".encode()).digest()
    em = b"\x00\x01" + b"\xff" * (k - 3 - len(info)) + b"\x00" + info
    sig = pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")
    return f"{h}.{p}.{_b64u(sig)}"


def _outcome(fn):
    """fn()'s claims, or the JWTError's text."""
    try:
        return fn()
    except ValueError as e:
        return f"{type(e).__name__}: {e}"


def _jwt_hs(P, tmp):
    verify = P.jwt.verify
    tok = _hs_token("s3cret", {"sub": "u1", "exp": JWT_NOW + 60})
    out = [_outcome(lambda: verify(tok, secrets=["wrong", "s3cret"],
                                   now=JWT_NOW)),
           _outcome(lambda: verify(tok, secrets=["nope"], now=JWT_NOW)),
           _outcome(lambda: verify(tok, secrets=["s3cret"],
                                   now=JWT_NOW + 61))]
    assert out[0]["sub"] == "u1"
    assert "signature" in out[1] and "expired" in out[2]
    for alg in ("HS384", "HS512"):
        t = _hs_token("k", {"sub": alg}, alg)
        out.append(_outcome(lambda: verify(t, secrets=["k"])))
        assert out[-1] == {"sub": alg}
    early = _hs_token("k", {"nbf": JWT_NOW + 10})
    out.append(_outcome(lambda: verify(early, secrets=["k"], now=JWT_NOW)))
    assert "not yet valid" in out[-1]
    bad_exp = _hs_token("k", {"exp": "soon"})
    for t in (bad_exp, "a.b", tok[:-4] + "!!!!",
              _b64u(b'{"alg": "none"}') + "." + _b64u(b"{}") + ".",
              _b64u(b"[1]") + "." + _b64u(b"{}") + "."):
        out.append(_outcome(lambda: verify(t, secrets=["k"], now=JWT_NOW)))
        assert out[-1].startswith("JWTError"), out[-1]
    # the wall clock, as the reference's case checks it
    live = _hs_token("s3cret", {"exp": time.time() + 60})
    out.append(sorted(verify(live, secrets=["s3cret"])))
    return out


def _jwt_rs256(P, tmp):
    key = _rsa_key(5)
    spki, pkcs1 = _rsa_pems(*key[:2])
    other, _ = _rsa_pems(*_rsa_key(6)[:2])
    tok = _rs_token(key, {"sub": "rs", "team": "dev"})
    h, p, s = tok.split(".")
    forged = f"{h}.{_b64u(json.dumps({'sub': 'rs', 'team': 'ops'}).encode())}.{s}"
    verify = P.jwt.verify
    out = [_outcome(lambda: verify(tok, public_keys=[spki])),
           _outcome(lambda: verify(tok, public_keys=[pkcs1])),
           _outcome(lambda: verify(tok, public_keys=[other, spki])),
           _outcome(lambda: verify(tok, public_keys=[other])),
           _outcome(lambda: verify(forged, public_keys=[spki])),
           _outcome(lambda: verify(tok, secrets=["s"])),
           P.jwt._parse_rsa_public_pem(spki) ==
           P.jwt._parse_rsa_public_pem(pkcs1) == key[:2]]
    assert out[0] == out[1] == out[2] == {"sub": "rs", "team": "dev"}
    assert all("signature" in o for o in out[3:6]) and out[6] is True
    return out


def _jwt_vmauth_user(P, tmp):
    key = _rsa_key(5)
    spki, _ = _rsa_pems(*key[:2])
    auth = P.vmauth.AuthConfig({"users": [
        {"name": "jwty", "url_prefix": "http://b1",
         "jwt_secrets": ["topsecret"],
         "jwt_required_claims": {"team": "dev"}},
        {"name": "rsa", "url_prefix": "http://b2",
         "jwt_public_keys": [spki]}]})
    tokens = [_hs_token("topsecret", {"team": "dev"}),
              _hs_token("topsecret", {"team": "ops"}),
              _hs_token("other", {"team": "dev"}),
              _rs_token(key, {"team": "ops"}),
              "not.a.jwt"]
    got = []
    for t in tokens:
        u = auth.find_user({"Authorization": f"Bearer {t}"})
        got.append(None if u is None else u.name)
    assert got == ["jwty", None, None, "rsa", None]
    return got


def _vmauth_find_user(P, tmp):
    """AuthConfig alone: basic auth, bearer tokens, the unauthorized_user
    fallback, src_paths/src_hosts routing and each url_prefix list's round
    robin."""
    import base64
    auth = P.vmauth.AuthConfig({
        "users": [
            {"username": "u1", "password": "p1", "url_map": [
                {"src_paths": ["/api/v1/query.*"],
                 "src_hosts": ["vm\\.example\\.com"],
                 "url_prefix": ["http://a1/", "http://a2"]},
                {"src_paths": ["/api/v1/write"],
                 "url_prefix": "http://w1"}]},
            {"bearer_token": "tok2",
             "url_prefix": ["http://b1", "http://b2", "http://b3"]}],
        "unauthorized_user": {"url_prefix": "http://open"}})

    def basic(s):
        return {"Authorization": "Basic " + base64.b64encode(s).decode()}
    def name(headers):
        u = auth.find_user(headers)
        return None if u is None else u.name
    u1 = auth.find_user(basic(b"u1:p1"))
    # an empty basic credential: the reference names the user with no
    # username (the bearer user here); the port names no one
    assert name(basic(b":")) == (None if P is PORT else "bearer")
    out = [u1.name, name(basic(b"u1:bad")),
           name({"Authorization": "Bearer tok2"}),
           name({"Authorization": "Bearer tok3"}), name({}),
           auth.unauthorized_user.route("/anything", "")]
    out += [u1.route("/api/v1/query_range", "vm.example.com")
            for _ in range(3)]
    out += [u1.route("/api/v1/query", "other.host"),
            u1.route("/api/v1/write", "x"), u1.route("/metrics", "x")]
    bearer = auth.find_user({"Authorization": "Bearer tok2"})
    out += [bearer.route("/p", "") for _ in range(4)]
    assert out == ["u1", None, "bearer", None, None, "http://open",
                   "http://a1", "http://a2", "http://a1", None, "http://w1",
                   None, "http://b1", "http://b2", "http://b3", "http://b1"]
    return out


def _vmauth_proxy(P, tmp):
    """vmauth's proxy in front of vmsingle, configured with a JSON file:
    401 with WWW-Authenticate without credentials or with a wrong
    password, basic auth and a bearer token routed through, 400 for a path
    no url_map entry takes, the JWT user's claim held, 502 from a backend
    that is down; the query answered as the server answers it.  An empty
    basic credential gets the port's 401 (the reference lets it in as the
    bearer user), and is left out of the result the two compare."""
    import base64
    import urllib.error
    single = Single(P, tmp / "data")
    single.storage.add_rows([({"__name__": "am", "i": str(i)}, T0, 3.0 + i)
                             for i in range(3)])
    down = free_ports(1)[0]
    cfg = tmp / "auth.json"
    cfg.write_text(json.dumps({"users": [
        {"username": "u1", "password": "p1",
         "url_map": [{"src_paths": ["/api/v1/.*"],
                      "url_prefix": single.base}]},
        {"bearer_token": "tok2", "url_prefix": single.base},
        {"name": "jwty", "url_prefix": single.base,
         "jwt_secrets": ["topsecret"],
         "jwt_required_claims": {"team": "dev"}},
        {"username": "gone", "password": "x",
         "url_prefix": f"http://127.0.0.1:{down}"}]}))
    auth, srv = P.vmauth.build(P.vmauth.parse_flags(
        [f"-auth.config={cfg}", "-httpListenAddr=127.0.0.1:0"]))
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    q = "/api/v1/query?" + urllib.parse.urlencode(
        {"query": "sum(am)", "time": T0 / 1e3})

    def call(path, header=None):
        req = urllib.request.Request(base + path)
        if header:
            req.add_header("Authorization", header)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())["data"], None
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode(), e.headers.get(
                "WWW-Authenticate")

    def basic(s):
        return "Basic " + base64.b64encode(s).decode()
    try:
        out = {"none": call(q), "wrong_password": call(q, basic(b"u1:no")),
               "basic": call(q, basic(b"u1:p1")),
               "bearer": call(q, "Bearer tok2"),
               "no_route": call("/other", basic(b"u1:p1")),
               "jwt": call(q, "Bearer " + _hs_token("topsecret",
                                                    {"team": "dev"})),
               "jwt_claim": call(q, "Bearer " + _hs_token("topsecret",
                                                          {"team": "ops"})),
               "down": call(q, basic(b"gone:x"))}
        empty = call(q, basic(b":"))
        direct = single.client.query("sum(am)", T0 / 1e3)["data"]
        requests = {u.name: u.requests for u in auth.users}
    finally:
        srv.stop()
        single.close()
    assert [out[k][0] for k in out] == [401, 401, 200, 200, 400, 200, 401,
                                        502]
    assert out["none"][2] == 'Basic realm="vmauth"'
    for k in ("basic", "bearer", "jwt"):
        assert out[k][1] == direct, k
    assert out["down"][1].startswith("backend error")
    if P is PORT:
        assert empty[0] == 401 and empty[2] == 'Basic realm="vmauth"'
    else:
        assert empty[:2] == (200, direct)
    # a request without a route counts against no user
    assert requests == {"u1": 1, "bearer": 1 if P is PORT else 2,
                        "jwty": 1, "gone": 1}
    return {k: v[:2] if v[0] != 502 else v[0] for k, v in out.items()}


@pytest.mark.parametrize("case", [_jwt_hs, _jwt_rs256, _jwt_vmauth_user,
                                  _vmauth_find_user, _vmauth_proxy],
                         ids=["jwt_hs", "jwt_rs256", "jwt_vmauth_user",
                              "find_user", "proxy"])
def test_vmauth(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- vmbackup / vmrestore ----------------------------------------------------

def _snapshot_of(single, name: str, n: int) -> str:
    """`n` series of `name` in the server's store, flushed, snapshotted:
    the snapshot's directory."""
    single.storage.add_rows([({"__name__": name, "i": str(i)},
                              T0 + i * 1000, float(i)) for i in range(n)])
    single.storage.force_flush()
    snap = single.storage.create_snapshot()
    return os.path.join(single.storage.snapshots_dir(), snap)


def _backup_round(P, tmp, single, snap_dir, remote, name, n) -> dict:
    """Back up twice (the second uploads nothing), restore into a new
    directory, open it: the stats and the restored series count."""
    st = P.vmbackup.backup(snap_dir, remote)
    assert st["uploaded"] > 0
    st2 = P.vmbackup.backup(snap_dir, remote)
    assert st2["uploaded"] == 0 and st2["skipped"] == st["uploaded"]
    dst = str(tmp / "restored")
    rs = P.vmbackup.restore(remote, dst)
    rs2 = P.vmbackup.restore(remote, dst)  # every file already there
    assert rs2 == {"downloaded": 0, "skipped": rs["downloaded"],
                   "removed": 0}
    s2 = P.Storage(dst)
    try:
        res = s2.search_series(P.filters_from_dict({"__name__": name}),
                               T0 - 1000, T0 + 100_000)
        got = sorted((r.metric_name.to_dict()["i"], r.values.tolist())
                     for r in res)
    finally:
        s2.close()
    assert len(got) == n
    return {"backup": st, "again": st2, "restore": rs, "series": got}


def _backup_fs(P, tmp):
    single = Single(P, tmp / "data")
    try:
        snap_dir = _snapshot_of(single, "bm", 50)
        remote = P.vmbackup.open_remote(f"fs://{tmp / 'bkp'}")
        assert isinstance(remote, P.vmbackup.FsRemote)
        out = _backup_round(P, tmp, single, snap_dir, remote, "bm", 50)
        # a file gone from the snapshot is deleted from the backup
        gone = sorted(remote.list_files())[0]
        os.unlink(os.path.join(snap_dir, gone))
        st3 = P.vmbackup.backup(snap_dir, remote)
        assert st3["deleted"] == 1 and gone not in remote.list_files()
        out["after_delete"] = st3
    finally:
        single.close()
    return out


def _fake_s3(P, objects):
    """A minimal in-process S3: PUT/GET/DELETE objects and ListObjectsV2,
    like the reference's custom-endpoint tests."""
    import urllib.parse

    def handler(req):
        path = urllib.parse.unquote(req.path.lstrip("/"))
        if req.method == "PUT":
            objects[path] = req.body
            return P.Response(200, b"")
        if req.method == "DELETE":
            objects.pop(path, None)
            return P.Response(204, b"")
        if req.method == "GET" and req.arg("list-type") == "2":
            bucket = path.split("?")[0]
            prefix = req.arg("prefix", "")
            # real S3 keys exclude the bucket name
            items = "".join(
                f"<Contents><Key>{k[len(bucket) + 1:]}</Key>"
                f"<Size>{len(v)}</Size></Contents>"
                for k, v in objects.items()
                if k.startswith(bucket + "/" + prefix))
            xml = (f"<ListBucketResult>{items}"
                   f"<IsTruncated>false</IsTruncated></ListBucketResult>")
            return P.Response(200, xml.encode(), "application/xml")
        if req.method == "GET":
            if path in objects:
                return P.Response(200, objects[path],
                                  "application/octet-stream")
            return P.Response(404, b"not found")
        return P.Response(400, b"")
    return handler


def _backup_s3(P, tmp):
    objects: dict[str, bytes] = {}
    fake = _serve(P, {"/": _fake_s3(P, objects)})
    single = Single(P, tmp / "data")
    try:
        snap_dir = _snapshot_of(single, "s3m", 30)
        remote = P.vmbackup.S3Remote(
            "bkt", "backups/daily", endpoint=f"http://127.0.0.1:{fake.port}",
            access_key="AK", secret_key="SK")
        out = _backup_round(P, tmp, single, snap_dir, remote, "s3m", 30)
        assert all(k.startswith("bkt/backups/daily/") for k in objects)
    finally:
        single.close()
        fake.stop()
    return out


def _fake_gcs(P, objects, seen_auth):
    """An in-process GCS JSON API (fake-gcs-server analog): object list
    paginated two at a time, media upload, download and delete."""
    import urllib.parse

    def handler(req):
        seen_auth.append(req.headers.get("authorization", ""))
        path = req.path
        if req.method == "POST" and path.startswith("/upload/"):
            name = urllib.parse.unquote(req.arg("name"))
            objects[name] = req.body
            return P.Response(200, json.dumps(
                {"name": name, "size": str(len(req.body))}).encode())
        if req.method == "GET" and path == "/storage/v1/b/bkt/o":
            prefix = req.arg("prefix", "")
            keys = sorted(k for k in objects if k.startswith(prefix))
            start = int(req.arg("pageToken") or 0)
            page = keys[start:start + 2]
            resp = {"items": [{"name": k, "size": str(len(objects[k]))}
                              for k in page]}
            if start + 2 < len(keys):
                resp["nextPageToken"] = str(start + 2)
            return P.Response(200, json.dumps(resp).encode())
        if path.startswith("/storage/v1/b/bkt/o/"):
            name = urllib.parse.unquote(path[len("/storage/v1/b/bkt/o/"):])
            if req.method == "DELETE":
                return (P.Response(204, b"") if objects.pop(name, None)
                        is not None else P.Response(404, b""))
            if req.method == "GET" and name in objects:
                return P.Response(200, objects[name],
                                  "application/octet-stream")
            return P.Response(404, b"not found")
        return P.Response(400, b"bad request")
    return handler


def _backup_gcs(P, tmp):
    objects: dict[str, bytes] = {}
    seen_auth: list[str] = []
    fake = _serve(P, {"/": _fake_gcs(P, objects, seen_auth)})
    single = Single(P, tmp / "data")
    try:
        snap_dir = _snapshot_of(single, "gm", 20)
        remote = P.vmbackup.open_remote(
            "gs://bkt/backups/g1", endpoint=f"http://127.0.0.1:{fake.port}",
            token="tok123")
        assert isinstance(remote, P.vmbackup.GcsRemote)
        out = _backup_round(P, tmp, single, snap_dir, remote, "gm", 20)
        assert seen_auth and set(seen_auth) == {"Bearer tok123"}
    finally:
        single.close()
        fake.stop()
    return out


def _fake_azurite(P, objects, bad_sigs, account, acct_key):
    """An in-process Azure Blob service that verifies SharedKey signatures
    (x-ms-date canonicalization + HMAC-SHA256 over the account key), with
    container listing paginated by marker."""
    import base64
    import hashlib
    import hmac
    import urllib.parse

    def check_sig(req, query):
        auth = req.headers.get("authorization", "")
        if not auth.startswith(f"SharedKey {account}:"):
            bad_sigs.append(("missing", auth))
            return
        xms = {k: v for k, v in req.headers.items()
               if k.lower().startswith("x-ms-")}
        canon_h = "".join(f"{k.lower()}:{v}\n"
                          for k, v in sorted(xms.items()))
        canon_r = f"/{account}{req.path}"
        if query:
            params = urllib.parse.parse_qs(query, keep_blank_values=True)
            for k in sorted(params):
                canon_r += f"\n{k.lower()}:{','.join(params[k])}"
        cl = str(len(req.body)) if req.body else ""
        ct = req.headers.get("content-type", "")
        to_sign = (f"{req.method}\n\n\n{cl}\n\n{ct}\n\n\n\n\n\n\n"
                   f"{canon_h}{canon_r}")
        want = base64.b64encode(hmac.new(
            base64.b64decode(acct_key), to_sign.encode(),
            hashlib.sha256).digest()).decode()
        if auth != f"SharedKey {account}:{want}":
            bad_sigs.append((to_sign, auth))

    def handler(req):
        check_sig(req, urllib.parse.urlparse(req.handler.path).query)
        path = urllib.parse.unquote(req.path.lstrip("/"))
        if req.method == "GET" and req.arg("comp") == "list":
            prefix = req.arg("prefix", "")
            keys = sorted(k for k in objects if k.startswith(prefix))
            start = int(req.arg("marker") or 0)
            page = keys[start:start + 2]
            blobs = "".join(
                f"<Blob><Name>{k}</Name><Properties>"
                f"<Content-Length>{len(objects[k])}</Content-Length>"
                f"</Properties></Blob>" for k in page)
            nm = (f"<NextMarker>{start + 2}</NextMarker>"
                  if start + 2 < len(keys) else "<NextMarker/>")
            xml = (f"<EnumerationResults><Blobs>{blobs}</Blobs>{nm}"
                   f"</EnumerationResults>")
            return P.Response(200, xml.encode(), "application/xml")
        key = path.split("/", 1)[1] if "/" in path else ""
        if req.method == "PUT":
            objects[key] = req.body
            return P.Response(201, b"")
        if req.method == "DELETE":
            return (P.Response(202, b"") if objects.pop(key, None)
                    is not None else P.Response(404, b""))
        if req.method == "GET":
            if key in objects:
                return P.Response(200, objects[key],
                                  "application/octet-stream")
            return P.Response(404, b"not found")
        return P.Response(400, b"")
    return handler


def _backup_azblob(P, tmp):
    import base64
    account, acct_key = "devacct", base64.b64encode(b"secret-key").decode()
    objects: dict[str, bytes] = {}
    bad_sigs: list = []
    fake = _serve(P, {"/": _fake_azurite(P, objects, bad_sigs, account,
                                         acct_key)})
    single = Single(P, tmp / "data")
    try:
        snap_dir = _snapshot_of(single, "azm", 15)
        remote = P.vmbackup.open_remote(
            "azblob://cont/backups/a1",
            endpoint=f"http://127.0.0.1:{fake.port}", account=account,
            key=acct_key)
        assert isinstance(remote, P.vmbackup.AzblobRemote)
        out = _backup_round(P, tmp, single, snap_dir, remote, "azm", 15)
        assert not bad_sigs, bad_sigs[0]
    finally:
        single.close()
        fake.stop()
    return out


def _backup_via_http_snapshot(P, tmp):
    """main_backup with -snapshot.createURL (the server snapshots itself),
    then main_restore, then a vmsingle on the restored directory answering
    the query the source answers."""
    single = Single(P, tmp / "data")
    try:
        single.storage.add_rows([({"__name__": "hm", "i": str(i)},
                                  T0 + j * 15_000, float(i * 100 + j))
                                 for i in range(8) for j in range(20)])
        P.vmbackup.main_backup([f"-storageDataPath={tmp / 'data'}",
                                f"-snapshot.createURL={single.base}",
                                f"-dst=fs://{tmp / 'bkp'}"])
        (snap,) = single.storage.list_snapshots()
        P.vmbackup.main_restore([f"-src=fs://{tmp / 'bkp'}",
                                 f"-storageDataPath={tmp / 'restored'}"])
        want = single.client.query_range("sum(rate(hm[1m]))", T0 / 1e3,
                                         (T0 + 19 * 15_000) / 1e3, 15)
    finally:
        single.close()
    restored = Single(P, tmp / "restored")
    try:
        got = restored.client.query_range("sum(rate(hm[1m]))", T0 / 1e3,
                                          (T0 + 19 * 15_000) / 1e3, 15)
    finally:
        restored.close()
    assert got["data"] == want["data"] and want["data"]["result"]
    with pytest.raises(SystemExit):
        P.vmbackup.main_backup([f"-storageDataPath={tmp / 'data'}",
                                f"-dst=fs://{tmp / 'bkp'}"])
    with pytest.raises(ValueError, match="unsupported backup destination"):
        P.vmbackup.open_remote("ftp://x/y")
    return {"snapshot_format": len(snap.split("-")), "data": got["data"]}


@pytest.mark.parametrize("case", [_backup_fs, _backup_s3, _backup_gcs,
                                  _backup_azblob, _backup_via_http_snapshot],
                         ids=["fs", "s3", "gcs", "azblob", "http_snapshot"])
def test_vmbackup(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- vmctl -------------------------------------------------------------------

def _vmctl_native(P, tmp):
    """vm_native: every series, then only what the source took after the
    first copy (the time filter), nothing copied twice."""
    src = Single(P, tmp / "src")
    dst = Single(P, tmp / "dst")
    try:
        src.storage.add_rows([({"__name__": "mig", "i": str(i)}, T0,
                               float(i)) for i in range(20)])
        n = P.vmctl.vm_native(src.base, dst.base, "mig")
        assert n == 20
        res = dst.client.query("count(mig)", T0 / 1e3 + 10)
        assert res["data"]["result"][0]["value"][1] == "20"
        src.storage.add_rows([({"__name__": "mig", "i": str(i)},
                               T0 + 60_000, float(i + 1)) for i in range(5)])
        n2 = P.vmctl.vm_native(src.base, dst.base, '{__name__="mig"}',
                               start=str((T0 + 30_000) / 1e3))
        dst.storage.force_flush()
        t = (T0 + 60_000) / 1e3
        late = [dst.client.query(q, t)["data"]["result"][0]["value"][1]
                for q in ("sum(count_over_time(mig[2m]))",
                          'sum(mig{i=~"[0-4]"})')]
    finally:
        src.close()
        dst.close()
    assert n2 == 5 and late == ["25", "15"]
    return [n, n2, res["data"], late]


def _vmctl_remote_read(P, tmp):
    src = Single(P, tmp / "src")
    dst = Single(P, tmp / "dst")
    try:
        src.storage.add_rows([({"__name__": "rrm", "i": str(i)},
                               T0 + j * 15_000, float(i * 10 + j))
                              for i in range(5) for j in range(20)])
        n = P.vmctl.remote_read(src.base, dst.base, '{__name__="rrm"}',
                                T0, T0 + 20 * 15_000)
        assert n == 100
        r = dst.client.query("count(rrm)", (T0 + 19 * 15_000) / 1e3)
        assert r["data"]["result"][0]["value"][1] == "5"
        n2 = P.vmctl.remote_read(src.base, dst.base, "rrm",
                                 T0, T0 + 20 * 15_000, chunk_rows=7)
        with pytest.raises(ValueError, match="cannot parse matchers"):
            P.vmctl.remote_read(src.base, dst.base, "{bad}", T0, T0 + 1)
        dst.storage.force_flush()
        s = dst.client.query("sum(rrm)", (T0 + 19 * 15_000) / 1e3)
    finally:
        src.close()
        dst.close()
    return [n, n2, r["data"], s["data"]]


def _vmctl_import_files(P, tmp):
    """import_file's three formats (Prometheus text, Influx lines,
    OpenTSDB telnet puts) into vmsingle."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "p.txt").write_text("".join(
        f'pf_m{{i="{i}"}} {i}.5 {T0 + i}\n' for i in range(12)) + "\n")
    (tmp / "i.txt").write_text("".join(
        f"if_m,i={i} v={i * 2} {(T0 + i) * 1_000_000}\n" for i in range(9)))
    (tmp / "o.txt").write_text("".join(
        f"put of_m {(T0 + i) // 1000} {i * 3} i={i}\n" for i in range(7)))
    dst = Single(P, tmp / "dst")
    try:
        n = [P.vmctl.import_file(str(tmp / "p.txt"), dst.base, "prometheus",
                                 chunk_lines=5),
             P.vmctl.import_file(str(tmp / "i.txt"), dst.base, "influx"),
             P.vmctl.import_file(str(tmp / "o.txt"), dst.base, "opentsdb")]
        dst.storage.force_flush()
        t = (T0 + 60_000) / 1e3
        got = [dst.client.query(q, t)["data"]["result"][0]["value"][1]
               for q in ("sum(pf_m)", "count(pf_m)", "sum(if_m_v)",
                         "sum(of_m)", "count(of_m)")]
    finally:
        dst.close()
    assert n == [12, 9, 7] and got == ["72", "12", "72", "63", "7"]
    return [n, got]


@pytest.mark.parametrize("case", [_vmctl_native, _vmctl_remote_read,
                                  _vmctl_import_files],
                         ids=["vm_native", "remote_read", "import_files"])
def test_vmctl(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- the port's vmsingle -rule -----------------------------------------------

RULES = {"groups": [{"name": "srv", "interval": "1h", "rules": [
    {"record": "instance:m:rate5m",
     "expr": "sum by (instance)(rate(rm_total[5m]))"},
    {"record": "instance:m:rate5m:again",
     "expr": "sum by (instance)(rate(rm_total[5m]))"},
    {"alert": "RateHigh",
     "expr": "sum by (instance)(rate(rm_total[5m])) > 2", "for": "1m",
     "labels": {"severity": "page"}}]}]}


def _counters(n_inst: int, per: int, end_ms: int, scrapes: int):
    """Seeded integer counters (so the cold upload packs delta planes
    and K1 decodes them): (labels, ts, value) rows, `scrapes` at 15 s up
    to end_ms, instance i rising about i + 1 a second."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n_inst):
        for j in range(per):
            incr = rng.integers(0, 30 * (i + 1), scrapes)
            vals = np.cumsum(incr).astype(np.float64)
            for k in range(scrapes):
                rows.append(({"__name__": "rm_total", "instance": f"i{i}",
                              "s": str(j)},
                             end_ms - (scrapes - 1 - k) * 15_000,
                             float(vals[k])))
    return rows


@pytest.fixture()
def carded(tmp_path, monkeypatch):
    """The port's vmsingle with -rule and the CUDA engine on the CPU
    (the kernels' plain versions, their calls counted)."""
    from victoriametrics_tpu_torch.ops import device_decode as dd
    from victoriametrics_tpu_torch.ops import device_rollup as dr
    from victoriametrics_tpu_torch.query.cuda_engine import CUDAEngine
    calls = {"K1": 0, "K2": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap
    monkeypatch.setattr(dd, "decode_tiles_plain",
                        counted("K1", dd.decode_tiles_plain))
    monkeypatch.setattr(dr, "rollup_aggregate_tile_plain",
                        counted("K2", dr.rollup_aggregate_tile_plain))
    (tmp_path / "rules.json").write_text(json.dumps(RULES))
    single = Single(PORT, tmp_path / "data",
                    [f"-rule={tmp_path / 'rules.json'}"])
    single.api.tpu = CUDAEngine(device="cpu", min_series=4)
    for g in single.api.rule_groups:
        g.stop()  # evaluated below, on the data's clock
    yield single, calls
    single.close()


def test_vmsingle_rule_group_armed_and_rows_in_the_store(carded):
    single, calls = carded
    (g,) = single.api.rule_groups
    assert [r.name for r in g.rules] == [
        "instance:m:rate5m", "instance:m:rate5m:again", "RateHigh"]
    assert isinstance(g.ds, PORT.vmalert.EngineDatasource)
    assert isinstance(g.rw, PORT.vmalert.LocalWriter)
    end = (int(time.time() * 1000) - DAY) // 60_000 * 60_000
    rows = _counters(4, 3, end + 120_000, 48)
    single.storage.add_rows([r for r in rows if r[1] <= end])
    single.storage.force_flush()
    written = []
    real = g.rw.write
    g.rw.write = lambda rows: written.append(rows) or real(rows)
    ms = single.api.matstreams
    states, launched = [], []
    for k in range(3):
        t = end + k * 60_000
        if k:  # the scrapes up to this instant
            single.storage.add_rows([r for r in rows
                                     if t - 60_000 < r[1] <= t])
        e0, r0, c0 = ms.instant_evals, ms.instant_reuse, dict(calls)
        g.eval_once(t / 1e3, notify=False)
        # two distinct expressions an instant: 3 rules, 2 evaluations
        assert (ms.instant_evals - e0, ms.instant_reuse - r0) == (2, 1)
        launched.append({n: calls[n] - c0[n] for n in calls})
        states.append(sorted(s["state"] for s in g.rules[2]._active.values()))
    # every evaluation reached the engine's K2; the first cold one K1 too
    assert all(d["K2"] >= 1 for d in launched), launched
    assert launched[0]["K1"] >= 1, launched
    assert states[0] and set(states[0]) == {"pending"}
    assert set(states[2]) == {"firing"}
    # the rows recorded equal the host evaluator's at each instant
    from victoriametrics_tpu_torch.query.exec import exec_query
    from victoriametrics_tpu_torch.query.format_value import fmt_value
    for k, got in enumerate(written):
        t = end + k * 60_000
        ec = single.api._ec(t, t, 300_000)
        ec.tpu, ec.disable_cache = None, True
        host = {json.dumps(r.metric_name.to_dict(), sort_keys=True):
                float(fmt_value(r.values[-1]))
                for r in exec_query(ec, RULES["groups"][0]["rules"][0]
                                    ["expr"])}
        rec = {json.dumps({k2: v for k2, v in lb.items()
                           if k2 != "__name__"}, sort_keys=True): v
               for lb, ts, v in got
               if lb["__name__"] == "instance:m:rate5m"}
        assert len(rec) == 4 and rec == host
    single.storage.force_flush()
    res = single.client.query("instance:m:rate5m",
                              (end + 120_000) / 1e3)["data"]["result"]
    assert len(res) == 4
    firing = single.client.query('ALERTS{alertstate="firing"}',
                                 (end + 120_000) / 1e3)["data"]["result"]
    assert {r["metric"]["alertname"] for r in firing} == {"RateHigh"}
    code, body = single.client.get("/api/v1/rules")
    assert code == 200
    assert json.loads(body)["data"]["groups"][0]["name"] == "srv"


def test_vmsingle_rules_equal_the_http_poll(carded):
    """EngineDatasource == HTTP poll: a standalone vmalert polling the
    same server over /api/v1/query records the server-side group's rows
    and alert states at the same instants."""
    single, _ = carded
    (g,) = single.api.rule_groups
    end = (int(time.time() * 1000) - DAY) // 60_000 * 60_000
    single.storage.add_rows(_counters(4, 3, end + 120_000, 48))
    single.storage.force_flush()
    polled = PORT.vmalert.Group(RULES["groups"][0],
                                PORT.vmalert.Datasource(single.base),
                                [], None)
    for k in range(3):
        t = (end + k * 60_000) / 1e3
        server_rows, poll_rows = [], []
        for grp, out in ((g, server_rows), (polled, poll_rows)):
            for r in grp.rules:
                if isinstance(r, PORT.vmalert.RecordingRule):
                    out.extend(sorted(json.dumps(x, sort_keys=True)
                                      for x in r.eval(grp.ds, t)))
                else:
                    r.eval(grp.ds, t)
                    out.append(sorted(json.dumps(s, sort_keys=True)
                                      for s in r._active.values()))
        assert server_rows == poll_rows and server_rows[0]


# -- the apps as processes, jax and PyYAML blocked ---------------------------

SITECUSTOMIZE = """
import atexit, json, sys
BLOCKED = ("jax", "jaxlib", "xxhash", "victoriametrics_tpu", "yaml")
for _m in BLOCKED:
    sys.modules[_m] = None


def _report():
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED
                    and sys.modules[m] is not None)
    print("LEAKED " + json.dumps(leaked), flush=True)


atexit.register(_report)
"""


def _wait_health(proc, port, log, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=1):
                return
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(log.read_text())
            time.sleep(0.1)
    raise TimeoutError(log.read_text())


def test_apps_run_as_processes_without_jax_or_yaml(tmp_path):
    """vmalert, vmagent, vmalert_tool, vmauth, vmbackup and vmctl as
    processes (``python -m``) in an interpreter where jax, the JAX
    package, xxhash and PyYAML are blocked, each configured with a JSON
    file: vmagent scrapes an exporter into a vmsingle, vmalert records
    from it, the tool passes its test file, vmauth proxies a query,
    vmbackup backs the server up and vmctl migrates; SIGTERM ends the
    servers with exit 0."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]))
    single = Single(PORT, tmp_path / "data")
    exporter = _serve(PORT, {"/metrics": lambda req: PORT.Response.text(
        'proc_metric{src="exp"} 7.5\n')})
    (tmp_path / "scrape.json").write_text(json.dumps({"scrape_configs": [{
        "job_name": "pj", "scrape_interval": "1s",
        "static_configs": [{"targets": [f"127.0.0.1:{exporter.port}"]}]}]}))
    (tmp_path / "rules.json").write_text(json.dumps({"groups": [{
        "name": "pg", "interval": "1s", "rules": [
            {"record": "pj:sum", "expr": "sum(proc_metric)"}]}]}))
    agent_port, alert_port = free_ports(2)
    procs = {}
    try:
        for name, flags, port in (
                ("vmagent", [f"-promscrape.config={tmp_path / 'scrape.json'}",
                             f"-remoteWrite.url={single.base}/api/v1/write",
                             f"-remoteWrite.tmpDataPath={tmp_path / 'q'}",
                             f"-httpListenAddr=127.0.0.1:{agent_port}"],
                 agent_port),
                ("vmalert", [f"-rule={tmp_path / 'rules.json'}",
                             f"-datasource.url={single.base}",
                             f"-remoteWrite.url={single.base}",
                             f"-httpListenAddr=127.0.0.1:{alert_port}"],
                 alert_port)):
            log = tmp_path / f"{name}.log"
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m",
                 f"victoriametrics_tpu_torch.apps.{name}", *flags],
                cwd=str(tmp_path), env=env, stdout=open(log, "wb"),
                stderr=subprocess.STDOUT), log)
            _wait_health(procs[name][0], port, log)
        deadline = time.time() + 60
        got = {}
        while time.time() < deadline and len(got) < 2:
            for q in ("proc_metric", "pj:sum"):
                res = single.client.query(q)["data"]["result"]
                if res:
                    got[q] = res[0]["value"][1]
            time.sleep(0.3)
        assert got == {"proc_metric": "7.5", "pj:sum": "7.5"}, \
            {n: log.read_text()[-2000:] for n, (_, log) in procs.items()}
        code, body = Client(agent_port).get("/api/v1/targets")
        (t,) = json.loads(body)["data"]["activeTargets"]
        assert code == 200 and t["health"] == "up"
        for name, (proc, log) in procs.items():
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
            text = log.read_text()
            assert "shutdown complete" in text and "LEAKED []" in text, \
                text[-3000:]
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        exporter.stop()
        single.close()
    (tmp_path / "t.json").write_text(json.dumps({
        "rule_files": ["rules.json"],
        "tests": [{"interval": "1m",
                   "input_series": [{"series": "proc_metric",
                                     "values": "1+1x5"}],
                   "metricsql_expr_test": [{
                       "expr": "sum(proc_metric)", "eval_time": "3m",
                       "exp_samples": [{"value": 4}]}]}]}))
    out = subprocess.run(
        [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmalert_tool",
         "unittest", f"--files={tmp_path / 't.json'}"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert "LEAKED []" in out.stdout
    _operations_as_processes(tmp_path, env)


def _run_app(env, cwd, module, *flags):
    """One app run to its end (``python -m``): its exit code and output."""
    out = subprocess.run(
        [sys.executable, "-m", f"victoriametrics_tpu_torch.apps.{module}",
         *flags], cwd=str(cwd), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=120)
    return out.returncode, out.stdout


def _operations_as_processes(tmp_path, env):
    """vmauth (a JSON -auth.config) in front of a vmsingle, vmbackup
    through the server's /snapshot/create (twice: the second uploads
    nothing), vmctl vm-native into a second vmsingle, and vmctl
    verify-block and prometheus-tsdb on a block written by the port's
    promtsdb; each process with jax, the JAX package, xxhash and PyYAML
    blocked."""
    import base64

    from victoriametrics_tpu_torch.utils import promtsdb
    src, dst = Single(PORT, tmp_path / "ops_src"), Single(PORT,
                                                          tmp_path / "ops_dst")
    auth_port = free_ports(1)[0]
    (tmp_path / "auth.json").write_text(json.dumps({"users": [
        {"username": "ops", "password": "pw", "url_prefix": src.base}]}))
    log = tmp_path / "vmauth.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmauth",
         f"-auth.config={tmp_path / 'auth.json'}",
         f"-httpListenAddr=127.0.0.1:{auth_port}"],
        cwd=str(tmp_path), env=env, stdout=open(log, "wb"),
        stderr=subprocess.STDOUT)
    try:
        src.storage.add_rows([({"__name__": "ops_m", "i": str(i)},
                               T0 + j * 15_000, float(i * 100 + j))
                              for i in range(6) for j in range(20)])
        _wait_health(proc, auth_port, log)
        q = {"query": "sum(rate(ops_m[1m]))", "start": T0 / 1e3,
             "end": (T0 + 19 * 15_000) / 1e3, "step": 15}
        req = urllib.request.Request(
            f"http://127.0.0.1:{auth_port}/api/v1/query_range?" +
            urllib.parse.urlencode(q))
        req.add_header("Authorization",
                       "Basic " + base64.b64encode(b"ops:pw").decode())
        with urllib.request.urlopen(req, timeout=30) as r:
            proxied = json.loads(r.read())["data"]
        direct = src.client.query_range(**q)["data"]
        assert proxied == direct and direct["result"]
        flags = [f"-storageDataPath={tmp_path / 'ops_src'}",
                 f"-dst=fs://{tmp_path / 'bkp'}"]
        rc, text = _run_app(env, tmp_path, "vmbackup",
                            f"-snapshot.createURL={src.base}", *flags)
        assert rc == 0 and "LEAKED []" in text, text[-3000:]
        first = re.search(r"backup: uploaded=(\d+) skipped=0", text)
        assert first and int(first.group(1)) > 0, text[-3000:]
        (snap,) = src.storage.list_snapshots()
        rc, text = _run_app(env, tmp_path, "vmbackup",
                            f"-snapshotName={snap}", *flags)
        assert rc == 0 and "LEAKED []" in text, text[-3000:]
        assert f"backup: uploaded=0 skipped={first.group(1)} deleted=0" \
            in text, text[-3000:]
        rc, text = _run_app(env, tmp_path, "vmctl", "vm-native",
                            f"--vm-native-src-addr={src.base}",
                            f"--vm-native-dst-addr={dst.base}",
                            '--vm-native-filter-match={__name__="ops_m"}')
        assert rc == 0 and "LEAKED []" in text, text[-3000:]
        assert "migrated 6 series chunks" in text, text[-3000:]
        ts = T0 + np.arange(20, dtype=np.int64) * 15_000
        promtsdb.write_block(str(tmp_path / "tsdb" / "01BLOCK"), [
            ({"__name__": "tsdb_m", "i": str(i)}, ts, ts * 0.0 + i)
            for i in range(4)])
        rc, text = _run_app(env, tmp_path, "vmctl", "verify-block",
                            f"--block-path={tmp_path / 'tsdb' / '01BLOCK'}")
        assert rc == 0 and '"ok": true' in text and "LEAKED []" in text, \
            text[-3000:]
        rc, text = _run_app(env, tmp_path, "vmctl", "prometheus-tsdb",
                            f"--tsdb-path={tmp_path / 'tsdb'}",
                            f"--dst-addr={dst.base}")
        assert rc == 0 and "migrated 80 samples" in text and \
            "LEAKED []" in text, text[-3000:]
        dst.storage.force_flush()
        assert dst.client.query_range(**q)["data"] == direct
        t = (T0 + 19 * 15_000) / 1e3
        assert dst.client.query("sum(tsdb_m)", t)["data"]["result"][0][
            "value"][1] == "6"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        assert "vmauth started" in log.read_text() and \
            "LEAKED []" in log.read_text(), log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        src.close()
        dst.close()


def _wait_log(log, text, count=1, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if log.read_text().count(text) >= count:
            return
        time.sleep(0.1)
    raise TimeoutError(log.read_text()[-3000:])


@pytest.mark.parametrize("app", ["vmsingle", "vmagent"])
def test_a_reload_that_fails_keeps_serving_the_old_config(tmp_path, app):
    """With PyYAML (and jax, the JAX package, xxhash) blocked, a config
    rewritten as YAML that is not JSON and reloaded into a running server
    (SIGHUP; on vmagent also ``/-/reload``) is logged as "reload failed,
    keeping old config" naming PyYAML, and the process goes on serving
    with the old config, then stops on SIGTERM with exit 0."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]))
    port = free_ports(1)[0]
    single = exporter = proc = None
    try:
        if app == "vmsingle":
            cfg = tmp_path / "relabel.json"
            cfg.write_text(json.dumps([{"action": "drop",
                                        "source_labels": ["__name__"],
                                        "regex": "dropped_m"}]))
            flags = [f"-storageDataPath={tmp_path / 'data'}",
                     f"-relabelConfig={cfg}", "-search.tpuBackend=false"]
            new = "- action: drop\n  source_labels: [__name__]\n" \
                  "  regex: kept_m\n"
        else:
            single = Single(PORT, tmp_path / "data")
            exporter = _serve(PORT, {"/metrics": lambda req:
                                     PORT.Response.text("exp_m 1\n")})
            target = f"127.0.0.1:{exporter.port}"
            cfg = tmp_path / "scrape.json"
            cfg.write_text(json.dumps({"scrape_configs": [{
                "job_name": "old", "scrape_interval": "1s",
                "static_configs": [{"targets": [target]}]}]}))
            flags = [f"-promscrape.config={cfg}",
                     f"-remoteWrite.url={single.base}/api/v1/write",
                     f"-remoteWrite.tmpDataPath={tmp_path / 'q'}"]
            new = "scrape_configs:\n- job_name: new\n"
        log = tmp_path / f"{app}.log"
        proc = subprocess.Popen(
            [sys.executable, "-m", f"victoriametrics_tpu_torch.apps.{app}",
             *flags, f"-httpListenAddr=127.0.0.1:{port}"],
            cwd=str(tmp_path), env=env, stdout=open(log, "wb"),
            stderr=subprocess.STDOUT)
        _wait_health(proc, port, log)
        cfg.write_text(new)
        proc.send_signal(signal.SIGHUP)
        failed = "reload failed, keeping old config"
        _wait_log(log, failed)
        c = Client(port)
        if app == "vmagent":
            assert c.get("/-/reload") == (200, b"OK")
            _wait_log(log, failed, count=2)
        assert proc.poll() is None, log.read_text()[-3000:]
        assert all("PyYAML" in ln for ln in log.read_text().splitlines()
                   if failed in ln)
        if app == "vmsingle":
            now = int(time.time() * 1000)
            assert c.post("/api/v1/import/prometheus",
                          f"dropped_m 1 {now}\nkept_m 2 {now}\n".encode()
                          )[0] == 204
            c.force_flush()
            assert c.query("dropped_m", now / 1e3)["data"]["result"] == []
            (kept,) = c.query("kept_m", now / 1e3)["data"]["result"]
            assert kept["value"][1] == "2"
        else:
            code, body = c.get("/api/v1/targets")
            (t,) = json.loads(body)["data"]["activeTargets"]
            assert code == 200 and t["labels"]["job"] == "old", t
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        text = log.read_text()
        assert "shutdown complete" in text and "LEAKED []" in text, \
            text[-3000:]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if exporter is not None:
            exporter.stop()
        if single is not None:
            single.close()
