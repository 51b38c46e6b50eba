"""The port's satellite apps against the reference's: the persistent
queue, vmagent (scrape -> persistent queue -> remote write), every
service-discovery provider against fake API servers, vmalert (alerting
and recording rules, notifier, remote write, replay, state restore, the
alerting clock) and vmalert_tool.

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
three apps as processes with jax, the JAX package, xxhash and PyYAML
blocked, configured with JSON files.
"""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types
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
                                              vmalert_tool, vmsingle)
        from victoriametrics_tpu.httpapi.server import HTTPServer, Response
        from victoriametrics_tpu.ingest import (discovery, persistentqueue,
                                                remote_write)
        from victoriametrics_tpu.ops import decimal as dec
        from victoriametrics_tpu.utils import profiler
        host = []
    else:
        from victoriametrics_tpu_torch.apps import (vmagent, vmalert,
                                                    vmalert_tool, vmsingle)
        from victoriametrics_tpu_torch.httpapi.server import (HTTPServer,
                                                              Response)
        from victoriametrics_tpu_torch.ingest import (discovery,
                                                      persistentqueue,
                                                      remote_write)
        from victoriametrics_tpu_torch.ops import decimal as dec
        from victoriametrics_tpu_torch.utils import profiler
        host = ["-search.tpuBackend=false"]  # no card on the CPU
    return types.SimpleNamespace(
        name=name, vmagent=vmagent, vmalert=vmalert,
        vmalert_tool=vmalert_tool, vmsingle=vmsingle, HTTPServer=HTTPServer,
        Response=Response, discovery=discovery,
        PersistentQueue=persistentqueue.PersistentQueue,
        remote_write=remote_write, dec=dec, profiler=profiler, host=host)


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
    """vmalert, vmagent and vmalert_tool as processes (``python -m``) in an
    interpreter where jax, the JAX package, xxhash and PyYAML are
    blocked, each configured with a JSON file: vmagent scrapes an
    exporter into a vmsingle, vmalert records from it, the tool passes
    its test file; SIGTERM ends the servers with exit 0."""
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
