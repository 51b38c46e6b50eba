"""Service discovery providers (reference lib/promscrape/discovery/):
kubernetes (pod/node/service/endpoints roles), consul, ec2, plus the
static/file providers handled inline by vmagent.

Each provider resolves a scrape config section to [(address, labels)]
where labels carry the provider's __meta_* set (the subset most relabel
configs use; reference emits a wider set). Providers are plain HTTP
clients so tests can point them at fake API servers (the reference tests
do the same via custom endpoints).

The port's copy of ``victoriametrics_tpu/ingest/discovery.py``, whole:
every provider, ``DiscoveryError`` and the last-known-good targets.
"""

from __future__ import annotations

import json
import urllib.request

from ..utils import logger


class DiscoveryError(RuntimeError):
    """Provider API failure — callers keep their last-known-good targets
    instead of treating this as an empty target list."""


def _get_json(url: str, headers: dict | None = None, timeout: float = 10.0):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


# -- kubernetes (discovery/kubernetes/) --------------------------------------

def kubernetes_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Supported roles: pod, node, service, endpoints."""
    api = cfg.get("api_server", "http://127.0.0.1:8001").rstrip("/")
    role = cfg.get("role", "pod")
    headers = {}
    token = cfg.get("bearer_token", "")
    token_file = cfg.get("bearer_token_file", "")
    if token_file:
        try:
            token = open(token_file).read().strip()
        except OSError as e:
            logger.errorf("kubernetes_sd: cannot read token: %s", e)
    if token:
        headers["Authorization"] = f"Bearer {token}"
    ns = cfg.get("namespaces", {}).get("names", [])
    out: list[tuple[str, dict]] = []

    def paths(kind):
        if ns:
            return [f"{api}/api/v1/namespaces/{n}/{kind}" for n in ns]
        return [f"{api}/api/v1/{kind}"]

    try:
        if role == "pod":
            for url in paths("pods"):
                for item in _get_json(url, headers).get("items", []):
                    meta = item.get("metadata", {})
                    status = item.get("status", {})
                    ip = status.get("podIP")
                    if not ip:
                        continue
                    base = {
                        "__meta_kubernetes_namespace":
                            meta.get("namespace", ""),
                        "__meta_kubernetes_pod_name": meta.get("name", ""),
                        "__meta_kubernetes_pod_ip": ip,
                        "__meta_kubernetes_pod_node_name":
                            item.get("spec", {}).get("nodeName", ""),
                        "__meta_kubernetes_pod_phase":
                            status.get("phase", ""),
                    }
                    for k, v in (meta.get("labels") or {}).items():
                        base["__meta_kubernetes_pod_label_" +
                             _sanitize(k)] = v
                    ports = [p for c in item.get("spec", {}).get(
                        "containers", []) for p in c.get("ports", [])]
                    if not ports:
                        out.append((ip, dict(base)))
                    for p in ports:
                        labels = dict(base)
                        labels["__meta_kubernetes_pod_container_port_number"] \
                            = str(p.get("containerPort", ""))
                        if p.get("name"):
                            labels["__meta_kubernetes_pod_container_port_name"] \
                                = p["name"]
                        out.append((f"{ip}:{p.get('containerPort')}", labels))
        elif role == "node":
            for item in _get_json(f"{api}/api/v1/nodes",
                                  headers).get("items", []):
                meta = item.get("metadata", {})
                addrs = {a.get("type"): a.get("address") for a in
                         item.get("status", {}).get("addresses", [])}
                ip = addrs.get("InternalIP") or addrs.get("Hostname")
                if not ip:
                    continue
                labels = {"__meta_kubernetes_node_name":
                          meta.get("name", "")}
                for k, v in (meta.get("labels") or {}).items():
                    labels["__meta_kubernetes_node_label_" +
                           _sanitize(k)] = v
                out.append((f"{ip}:10250", labels))
        elif role in ("service", "endpoints"):
            kind = "services" if role == "service" else "endpoints"
            for url in paths(kind):
                for item in _get_json(url, headers).get("items", []):
                    meta = item.get("metadata", {})
                    base = {
                        "__meta_kubernetes_namespace":
                            meta.get("namespace", ""),
                        f"__meta_kubernetes_{role}_name":
                            meta.get("name", ""),
                    }
                    if role == "service":
                        ip = item.get("spec", {}).get("clusterIP")
                        if not ip or ip == "None":  # headless services
                            continue
                        for p in item.get("spec", {}).get("ports", []):
                            labels = dict(base)
                            labels["__meta_kubernetes_service_port_number"] \
                                = str(p.get("port", ""))
                            out.append((f"{ip}:{p.get('port')}", labels))
                    else:
                        for ss in item.get("subsets", []):
                            for a in ss.get("addresses", []):
                                for p in ss.get("ports", []):
                                    out.append((
                                        f"{a.get('ip')}:{p.get('port')}",
                                        dict(base)))
        else:
            logger.errorf("kubernetes_sd: unsupported role %r", role)
    except (OSError, ValueError) as e:
        raise DiscoveryError(f"kubernetes_sd {api} role={role}: {e}") from e
    return out


def _sanitize(k: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in k)


# -- consul (discovery/consul/) ----------------------------------------------

def consul_sd(cfg: dict) -> list[tuple[str, dict]]:
    server = cfg.get("server", "127.0.0.1:8500")
    scheme = cfg.get("scheme", "http")
    base = f"{scheme}://{server}/v1"
    headers = {}
    if cfg.get("token"):
        headers["X-Consul-Token"] = cfg["token"]
    out: list[tuple[str, dict]] = []
    try:
        services = cfg.get("services") or list(
            _get_json(f"{base}/catalog/services", headers))
        for svc in services:
            for e in _get_json(f"{base}/health/service/{svc}", headers):
                node = e.get("Node", {})
                s = e.get("Service", {})
                addr = s.get("Address") or node.get("Address", "")
                port = s.get("Port", 0)
                labels = {
                    "__meta_consul_service": s.get("Service", svc),
                    "__meta_consul_node": node.get("Node", ""),
                    "__meta_consul_address": node.get("Address", ""),
                    "__meta_consul_service_address": addr,
                    "__meta_consul_service_port": str(port),
                    "__meta_consul_tags":
                        "," + ",".join(s.get("Tags") or []) + ",",
                    "__meta_consul_dc": node.get("Datacenter", ""),
                }
                out.append((f"{addr}:{port}", labels))
    except (OSError, ValueError) as e:
        raise DiscoveryError(f"consul_sd {server}: {e}") from e
    return out


# -- ec2 (discovery/ec2/) -----------------------------------------------------

def ec2_sd(cfg: dict) -> list[tuple[str, dict]]:
    """DescribeInstances with SigV4 signing; `endpoint` override makes it
    testable against a fake server (the reference supports the same)."""
    region = cfg.get("region", "us-east-1")
    endpoint = cfg.get("endpoint",
                       f"https://ec2.{region}.amazonaws.com")
    port = int(cfg.get("port", 80))
    access_key = cfg.get("access_key", "")
    secret_key = cfg.get("secret_key", "")
    body = "Action=DescribeInstances&Version=2013-10-15"
    headers = {"Content-Type":
               "application/x-www-form-urlencoded; charset=utf-8"}
    if access_key and secret_key:
        headers.update(_sigv4_headers(
            "POST", endpoint, body, region, "ec2", access_key, secret_key))
    out: list[tuple[str, dict]] = []
    try:
        req = urllib.request.Request(endpoint, data=body.encode(),
                                     headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=15) as r:
            xml = r.read().decode("utf-8", "replace")
        for inst in _parse_ec2_instances(xml):
            ip = inst.get("privateIpAddress")
            if not ip:
                continue
            labels = {
                "__meta_ec2_instance_id": inst.get("instanceId", ""),
                "__meta_ec2_private_ip": ip,
                "__meta_ec2_instance_type": inst.get("instanceType", ""),
                "__meta_ec2_availability_zone":
                    inst.get("availabilityZone", ""),
                "__meta_ec2_instance_state": inst.get("state", ""),
            }
            if inst.get("publicIpAddress"):
                labels["__meta_ec2_public_ip"] = inst["publicIpAddress"]
            for k, v in inst.get("tags", {}).items():
                labels["__meta_ec2_tag_" + _sanitize(k)] = v
            out.append((f"{ip}:{port}", labels))
    except (OSError, ValueError) as e:
        raise DiscoveryError(f"ec2_sd {endpoint}: {e}") from e
    return out


def _parse_ec2_instances(xml: str) -> list[dict]:
    import xml.etree.ElementTree as ET
    root = ET.fromstring(xml)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[:root.tag.index("}") + 1]
    out = []
    for item in root.iter(f"{ns}instancesSet"):
        for inst in item.findall(f"{ns}item"):
            d = {}
            for field in ("instanceId", "instanceType",
                          "privateIpAddress", "publicIpAddress"):
                el = inst.find(f"{ns}{field}")
                if el is not None and el.text:
                    d[field] = el.text
            st = inst.find(f"{ns}instanceState/{ns}name")
            if st is not None:
                d["state"] = st.text
            az = inst.find(f"{ns}placement/{ns}availabilityZone")
            if az is not None:
                d["availabilityZone"] = az.text
            tags = {}
            for t in inst.findall(f"{ns}tagSet/{ns}item"):
                k = t.find(f"{ns}key")
                v = t.find(f"{ns}value")
                if k is not None and v is not None:
                    tags[k.text] = v.text or ""
            d["tags"] = tags
            out.append(d)
    return out


def _sigv4_headers(method: str, url: str, body, region: str,
                   service: str, access_key: str, secret_key: str) -> dict:
    """AWS Signature Version 4 (lib/awsapi/sign.go analog): hashes the RAW
    byte payload, sends x-amz-content-sha256 (required by S3), and
    canonicalizes the query string in sorted order."""
    import datetime
    import hashlib
    import hmac
    from urllib.parse import parse_qsl, quote, urlparse
    if isinstance(body, str):
        body = body.encode()
    u = urlparse(url)
    # SigV4 signing embeds an absolute timestamp the server skew-checks
    now = datetime.datetime.now(datetime.timezone.utc)  # vmt: disable=VMT001
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body).hexdigest()
    q = sorted(parse_qsl(u.query, keep_blank_values=True))
    canonical_query = "&".join(
        f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}" for k, v in q)
    canonical_headers = (f"host:{u.netloc}\n"
                         f"x-amz-content-sha256:{payload_hash}\n"
                         f"x-amz-date:{amz_date}\n")
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical = "\n".join([method, quote(u.path or "/", safe="/-_.~"),
                           canonical_query, canonical_headers,
                           signed_headers, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])

    def _hmac(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    auth = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={sig}")
    return {"Authorization": auth, "X-Amz-Date": amz_date,
            "X-Amz-Content-Sha256": payload_hash}


# -- http (discovery/http/) --------------------------------------------------

def http_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Generic HTTP SD (the escape hatch everything else can feed):
    GET url -> [{"targets": [...], "labels": {...}}, ...]
    (reference lib/promscrape/discovery/http/api.go)."""
    url = cfg.get("url", "")
    if not url:
        raise DiscoveryError("http_sd: missing url")
    headers = {}
    token = cfg.get("bearer_token", "")
    if cfg.get("bearer_token_file"):
        try:
            token = open(cfg["bearer_token_file"]).read().strip()
        except OSError as e:
            logger.errorf("http_sd: cannot read token: %s", e)
    if token:
        headers["Authorization"] = f"Bearer {token}"
    ba = cfg.get("basic_auth") or {}
    if ba.get("username"):
        import base64
        cred = f"{ba['username']}:{ba.get('password', '')}".encode()
        headers["Authorization"] = \
            "Basic " + base64.b64encode(cred).decode()
    try:
        groups = _get_json(url, headers)
    except Exception as e:
        raise DiscoveryError(f"http_sd {url}: {e}") from e
    out: list[tuple[str, dict]] = []
    for g in groups or []:
        labels = {f"__meta_{k}" if not k.startswith("__") else k: str(v)
                  for k, v in (g.get("labels") or {}).items()}
        labels["__meta_url"] = url
        for t in g.get("targets") or []:
            out.append((t, dict(labels)))
    return out


# -- dns (discovery/dns/) ----------------------------------------------------

_DNS_TYPES = {"SRV": 33, "A": 1, "AAAA": 28}


def _dns_encode_name(name: str) -> bytes:
    out = b""
    for part in name.rstrip(".").split("."):
        p = part.encode()
        out += bytes([len(p)]) + p
    return out + b"\x00"


def _dns_read_name(msg: bytes, off: int) -> tuple[str, int]:
    """Compression-aware name decode; returns (name, next offset)."""
    parts = []
    jumped = False
    end = off
    for _ in range(128):  # loop guard
        ln = msg[off]
        if ln & 0xC0 == 0xC0:  # pointer
            ptr = ((ln & 0x3F) << 8) | msg[off + 1]
            if not jumped:
                end = off + 2
            off = ptr
            jumped = True
            continue
        if ln == 0:
            if not jumped:
                end = off + 1
            break
        parts.append(msg[off + 1:off + 1 + ln].decode("ascii", "replace"))
        off += 1 + ln
    return ".".join(parts), end


def _dns_query(name: str, qtype: int, server: str, port: int = 53,
               timeout: float = 3.0) -> list[tuple]:
    """Minimal UDP DNS client: returns [(rtype, rdata)] answers, where SRV
    rdata = (prio, weight, port, target) and A/AAAA rdata = ip string."""
    import socket
    import struct as _s
    qid = (hash(name) ^ id(object())) & 0xFFFF
    msg = _s.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0) + \
        _dns_encode_name(name) + _s.pack(">HH", qtype, 1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(msg, (server, port))
        resp, _ = s.recvfrom(8192)
    rid, flags, qd, an, _, _ = _s.unpack(">HHHHHH", resp[:12])
    if rid != qid or (flags & 0x000F) != 0:
        raise DiscoveryError(f"dns_sd: bad response for {name}")
    off = 12
    for _ in range(qd):  # skip questions
        _, off = _dns_read_name(resp, off)
        off += 4
    out = []
    for _ in range(an):
        _, off = _dns_read_name(resp, off)
        rtype, _, _, rdlen = _s.unpack(">HHIH", resp[off:off + 10])
        off += 10
        rd = resp[off:off + rdlen]
        if rtype == 33:  # SRV
            prio, weight, prt = _s.unpack(">HHH", rd[:6])
            target, _ = _dns_read_name(resp, off + 6)
            out.append((rtype, (prio, weight, prt, target)))
        elif rtype == 1 and rdlen == 4:
            out.append((rtype, ".".join(str(b) for b in rd)))
        elif rtype == 28 and rdlen == 16:
            import socket as _sock
            out.append((rtype, _sock.inet_ntop(_sock.AF_INET6, rd)))
        off += rdlen
    return out


def _system_resolver() -> tuple[str, int]:
    try:
        with open("/etc/resolv.conf") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "nameserver":
                    return parts[1], 53
    except OSError:
        pass
    return "127.0.0.1", 53


def dns_sd(cfg: dict) -> list[tuple[str, dict]]:
    """SRV/A/AAAA record discovery (lib/promscrape/discovery/dns). The
    resolver defaults to /etc/resolv.conf; `resolver` ("host:port")
    overrides it — tests point it at a fake UDP server."""
    qtype_name = (cfg.get("type") or "SRV").upper()
    qtype = _DNS_TYPES.get(qtype_name)
    if qtype is None:
        raise DiscoveryError(f"dns_sd: unsupported type {qtype_name!r}")
    port = cfg.get("port")
    if qtype_name != "SRV" and port is None:
        raise DiscoveryError("dns_sd: `port` is required for A/AAAA")
    resolver = cfg.get("resolver", "")
    if resolver:
        host, _, rp = resolver.partition(":")
        server = (host, int(rp or 53))
    else:
        server = _system_resolver()
    out: list[tuple[str, dict]] = []
    for name in cfg.get("names", []) or []:
        import struct
        try:
            answers = _dns_query(name, qtype, server[0], server[1])
        except (OSError, DiscoveryError, IndexError, ValueError,
                struct.error) as e:
            # Index/struct errors = malformed/truncated datagrams; they must
            # degrade to last-known-good targets, not kill the SD loop
            raise DiscoveryError(f"dns_sd {name}: {e}") from e
        for rtype, rd in answers:
            meta = {"__meta_dns_name": name}
            if rtype == 33:
                prio, weight, prt, target = rd
                meta["__meta_dns_srv_record_target"] = target
                meta["__meta_dns_srv_record_port"] = str(prt)
                addr = f"{target}:{port if port is not None else prt}"
            else:
                addr = f"{rd}:{port}"
            out.append((addr, meta))
    return out


# -- docker (discovery/docker/) ----------------------------------------------

def _docker_get(host: str, path: str, timeout: float = 10.0):
    """GET against a docker daemon: tcp/http hosts via urllib, unix://
    sockets via a raw HTTPConnection bound to the socket path."""
    if host.startswith("unix://"):
        import http.client
        import socket

        class _UnixConn(http.client.HTTPConnection):
            def __init__(self, spath):
                super().__init__("localhost", timeout=timeout)
                self._spath = spath

            def connect(self):
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(timeout)
                s.connect(self._spath)
                self.sock = s

        conn = _UnixConn(host[len("unix://"):])
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        if resp.status != 200:
            raise DiscoveryError(f"docker {path}: HTTP {resp.status}")
        return json.loads(data)
    base = host.rstrip("/")
    if base.startswith("tcp://"):
        base = "http://" + base[len("tcp://"):]
    return _get_json(base + path)


def docker_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Container discovery against the Docker Engine API
    (lib/promscrape/discovery/docker): one target per container network,
    port = first private port (or `port` from the config)."""
    host = cfg.get("host", "unix:///var/run/docker.sock")
    dport = int(cfg.get("port", 80))
    try:
        containers = _docker_get(host, "/containers/json")
    except (OSError, ValueError, DiscoveryError) as e:
        raise DiscoveryError(f"docker_sd {host}: {e}") from e
    out: list[tuple[str, dict]] = []
    for c in containers or []:
        names = c.get("Names") or ["/"]
        meta_base = {
            "__meta_docker_container_id": c.get("Id", ""),
            "__meta_docker_container_name": names[0],
            "__meta_docker_container_state": c.get("State", ""),
        }
        for k, v in (c.get("Labels") or {}).items():
            meta_base[f"__meta_docker_container_label_{_sanitize(k)}"] = v
        ports = [p for p in (c.get("Ports") or [])
                 if p.get("PrivatePort")]
        nets = (c.get("NetworkSettings") or {}).get("Networks") or {}
        for net_name, net in nets.items():
            ip = net.get("IPAddress", "")
            if not ip:
                continue
            meta = dict(meta_base)
            meta["__meta_docker_network_name"] = net_name
            meta["__meta_docker_network_ip"] = ip
            if ports:
                p = ports[0]
                meta["__meta_docker_port_private"] = str(p["PrivatePort"])
                if p.get("PublicPort"):
                    meta["__meta_docker_port_public"] = str(p["PublicPort"])
                out.append((f"{ip}:{p['PrivatePort']}", meta))
            else:
                out.append((f"{ip}:{dport}", meta))
    return out


# -- gce (discovery/gce/) ----------------------------------------------------

def gce_sd(cfg: dict) -> list[tuple[str, dict]]:
    """GCE instance discovery (lib/promscrape/discovery/gce): compute API
    instance list with metadata-server auth; `api_server` points it at
    fakes."""
    project = cfg.get("project", "")
    zone = cfg.get("zone", "")
    if not project or not zone:
        raise DiscoveryError("gce_sd: project and zone are required")
    api = cfg.get("api_server",
                  "https://compute.googleapis.com").rstrip("/")
    port = int(cfg.get("port", 80))
    headers = {}
    token = cfg.get("access_token", "")
    if not token and "googleapis.com" in api:
        try:
            req = urllib.request.Request(
                "http://metadata.google.internal/computeMetadata/v1/"
                "instance/service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=5) as r:
                token = json.load(r)["access_token"]
        except Exception as e:
            raise DiscoveryError(f"gce_sd: metadata token: {e}") from e
    if token:
        headers["Authorization"] = f"Bearer {token}"
    url = (f"{api}/compute/v1/projects/{project}/zones/{zone}/instances")
    out: list[tuple[str, dict]] = []
    try:
        while True:
            resp = _get_json(url, headers)
            for inst in resp.get("items", []):
                ifaces = inst.get("networkInterfaces") or []
                ip = ifaces[0].get("networkIP", "") if ifaces else ""
                if not ip:
                    continue
                meta = {
                    "__meta_gce_instance_id": str(inst.get("id", "")),
                    "__meta_gce_instance_name": inst.get("name", ""),
                    "__meta_gce_instance_status": inst.get("status", ""),
                    "__meta_gce_machine_type":
                        inst.get("machineType", "").rsplit("/", 1)[-1],
                    "__meta_gce_network":
                        (ifaces[0].get("network", "").rsplit("/", 1)[-1]
                         if ifaces else ""),
                    "__meta_gce_private_ip": ip,
                    "__meta_gce_project": project,
                    "__meta_gce_zone": zone,
                }
                for it in (inst.get("metadata") or {}).get("items", []):
                    meta[f"__meta_gce_metadata_{_sanitize(it['key'])}"] = \
                        it.get("value", "")
                tags = (inst.get("tags") or {}).get("items", [])
                if tags:
                    # separator-wrapped, so `,tag,` regexes match every
                    # position (Prometheus gce_sd format)
                    meta["__meta_gce_tags"] = "," + ",".join(tags) + ","
                ac = ifaces[0].get("accessConfigs") if ifaces else None
                if ac and ac[0].get("natIP"):
                    meta["__meta_gce_public_ip"] = ac[0]["natIP"]
                out.append((f"{ip}:{port}", meta))
            tok = resp.get("nextPageToken")
            if not tok:
                break
            url = (f"{api}/compute/v1/projects/{project}/zones/{zone}"
                   f"/instances?pageToken={tok}")
    except (OSError, ValueError) as e:
        raise DiscoveryError(f"gce_sd {api}: {e}") from e
    return out


# -- azure (discovery/azure/) ------------------------------------------------

def azure_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Azure VM discovery (lib/promscrape/discovery/azure): ARM VM list +
    NIC private-IP resolution, OAuth client-credentials auth.
    `api_server`/`token_url` overrides point it at fakes."""
    sub = cfg.get("subscription_id", "")
    if not sub:
        raise DiscoveryError("azure_sd: subscription_id is required")
    api = cfg.get("api_server",
                  "https://management.azure.com").rstrip("/")
    port = int(cfg.get("port", 80))
    headers = {}
    token = cfg.get("access_token", "")
    if not token and cfg.get("client_id"):
        import urllib.parse
        tenant = cfg.get("tenant_id", "")
        token_url = cfg.get(
            "token_url",
            f"https://login.microsoftonline.com/{tenant}/oauth2/token")
        body = urllib.parse.urlencode({
            "grant_type": "client_credentials",
            "client_id": cfg["client_id"],
            "client_secret": cfg.get("client_secret", ""),
            "resource": api + "/",
        }).encode()
        try:
            req = urllib.request.Request(token_url, data=body)
            with urllib.request.urlopen(req, timeout=10) as r:
                token = json.load(r)["access_token"]
        except Exception as e:
            raise DiscoveryError(f"azure_sd: token: {e}") from e
    if token:
        headers["Authorization"] = f"Bearer {token}"
    rg = cfg.get("resource_group", "")
    scope = (f"/subscriptions/{sub}/resourceGroups/{rg}" if rg
             else f"/subscriptions/{sub}")
    url = (f"{api}{scope}/providers/Microsoft.Compute/virtualMachines"
           f"?api-version=2022-03-01")
    out: list[tuple[str, dict]] = []
    try:
        while url:
            resp = _get_json(url, headers)
            for vm in resp.get("value", []):
                props = vm.get("properties") or {}
                meta = {
                    "__meta_azure_machine_id": vm.get("id", ""),
                    "__meta_azure_machine_name": vm.get("name", ""),
                    "__meta_azure_machine_location":
                        vm.get("location", ""),
                    "__meta_azure_machine_resource_group":
                        vm.get("id", "").split("/resourceGroups/")[-1]
                        .split("/")[0] if "/resourceGroups/" in
                        vm.get("id", "") else "",
                    "__meta_azure_machine_os_type":
                        ((props.get("storageProfile") or {})
                         .get("osDisk") or {}).get("osType", ""),
                    "__meta_azure_subscription_id": sub,
                }
                for k, v in (vm.get("tags") or {}).items():
                    meta[f"__meta_azure_machine_tag_{_sanitize(k)}"] = v
                ip = ""
                nics = ((props.get("networkProfile") or {})
                        .get("networkInterfaces") or [])
                if nics:
                    nic_url = (f"{api}{nics[0].get('id', '')}"
                               f"?api-version=2022-05-01")
                    nic = _get_json(nic_url, headers)
                    for ipc in ((nic.get("properties") or {})
                                .get("ipConfigurations") or []):
                        ip = (ipc.get("properties") or {}).get(
                            "privateIPAddress", "")
                        if ip:
                            break
                if not ip:
                    continue
                meta["__meta_azure_machine_private_ip"] = ip
                out.append((f"{ip}:{port}", meta))
            url = resp.get("nextLink", "")
    except (OSError, ValueError) as e:
        raise DiscoveryError(f"azure_sd {api}: {e}") from e
    return out


# -- nomad (discovery/nomad/) ------------------------------------------------

def nomad_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Nomad service discovery (lib/promscrape/discovery/nomad): list
    service names, then each service's registrations; one target per
    registration at Address:Port."""
    import urllib.parse as _up
    server = cfg.get("server", "localhost:4646")
    if not server.startswith(("http://", "https://")):
        server = "http://" + server
    base = f"{server.rstrip('/')}/v1"
    q = "?" + _up.urlencode({"namespace": cfg.get("namespace", "default"),
                             "region": cfg.get("region", "global")})
    try:
        listing = _get_json(f"{base}/services{q}")
        out: list[tuple[str, dict]] = []
        for group in listing or []:
            for svc in group.get("Services") or []:
                name = svc.get("ServiceName", "")
                if not name:
                    continue
                for reg in _get_json(
                        f"{base}/service/"
                        f"{_up.quote(name, safe='')}{q}") or []:
                    addr = reg.get("Address", "")
                    port = reg.get("Port", 0)
                    meta = {
                        "__meta_nomad_address": addr,
                        "__meta_nomad_dc": reg.get("Datacenter", ""),
                        "__meta_nomad_namespace":
                            reg.get("Namespace", ""),
                        "__meta_nomad_node_id": reg.get("NodeID", ""),
                        "__meta_nomad_service":
                            reg.get("ServiceName", ""),
                        "__meta_nomad_service_address": addr,
                        "__meta_nomad_service_alloc_id":
                            reg.get("AllocID", ""),
                        "__meta_nomad_service_id": reg.get("ID", ""),
                        "__meta_nomad_service_job_id":
                            reg.get("JobID", ""),
                        "__meta_nomad_service_port": str(port),
                        "__meta_nomad_tags":
                            "," + ",".join(reg.get("Tags") or []) + ",",
                    }
                    for tag in reg.get("Tags") or []:
                        k, sep, v = tag.partition("=")
                        if sep:
                            meta[f"__meta_nomad_tag_{_sanitize(k)}"] = v
                        meta[f"__meta_nomad_tagpresent_{_sanitize(k)}"] \
                            = "true"
                    out.append((f"{addr}:{port}", meta))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"nomad_sd {server}: {e}") from e


# -- dockerswarm (discovery/dockerswarm/) ------------------------------------

def dockerswarm_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Docker Swarm discovery (lib/promscrape/discovery/dockerswarm):
    roles tasks (default), services, nodes against the engine API."""
    host = cfg.get("host", "unix:///var/run/docker.sock")
    role = cfg.get("role", "tasks")
    dport = int(cfg.get("port", 80))
    try:
        if role == "nodes":
            out = []
            for n in _docker_get(host, "/nodes") or []:
                desc = n.get("Description") or {}
                status = n.get("Status") or {}
                spec = n.get("Spec") or {}
                meta = {
                    "__meta_dockerswarm_node_id": n.get("ID", ""),
                    "__meta_dockerswarm_node_address":
                        status.get("Addr", ""),
                    "__meta_dockerswarm_node_availability":
                        spec.get("Availability", ""),
                    "__meta_dockerswarm_node_hostname":
                        desc.get("Hostname", ""),
                    "__meta_dockerswarm_node_role": spec.get("Role", ""),
                    "__meta_dockerswarm_node_status":
                        status.get("State", ""),
                    "__meta_dockerswarm_node_platform_architecture":
                        (desc.get("Platform") or {}).get(
                            "Architecture", ""),
                    "__meta_dockerswarm_node_platform_os":
                        (desc.get("Platform") or {}).get("OS", ""),
                    "__meta_dockerswarm_node_engine_version":
                        (desc.get("Engine") or {}).get(
                            "EngineVersion", ""),
                }
                for k, v in (spec.get("Labels") or {}).items():
                    meta["__meta_dockerswarm_node_label_"
                         f"{_sanitize(k)}"] = v
                out.append((f"{status.get('Addr', '')}:{dport}", meta))
            return out
        services = {s["ID"]: s for s in _docker_get(host, "/services")
                    or []}
        if role == "services":
            out = []
            for s in services.values():
                spec = s.get("Spec") or {}
                meta = {
                    "__meta_dockerswarm_service_id": s.get("ID", ""),
                    "__meta_dockerswarm_service_name":
                        spec.get("Name", ""),
                    "__meta_dockerswarm_service_mode":
                        next(iter(spec.get("Mode") or {"": None})).lower(),
                }
                for k, v in (spec.get("Labels") or {}).items():
                    meta["__meta_dockerswarm_service_label_"
                         f"{_sanitize(k)}"] = v
                eps = ((s.get("Endpoint") or {}).get("VirtualIPs")
                       or [])
                for ep in eps:
                    ip = (ep.get("Addr") or "").split("/")[0]
                    if ip:
                        out.append((f"{ip}:{dport}", dict(meta)))
            return out
        # role == tasks
        nodes = {n["ID"]: n for n in _docker_get(host, "/nodes") or []}
        out = []
        for t in _docker_get(host, "/tasks") or []:
            svc = services.get(t.get("ServiceID", "")) or {}
            node = nodes.get(t.get("NodeID", "")) or {}
            meta = {
                "__meta_dockerswarm_task_id": t.get("ID", ""),
                "__meta_dockerswarm_task_desired_state":
                    t.get("DesiredState", ""),
                "__meta_dockerswarm_task_state":
                    (t.get("Status") or {}).get("State", ""),
                "__meta_dockerswarm_task_slot": str(t.get("Slot", "")),
                "__meta_dockerswarm_service_id":
                    t.get("ServiceID", ""),
                "__meta_dockerswarm_service_name":
                    (svc.get("Spec") or {}).get("Name", ""),
                "__meta_dockerswarm_node_id": t.get("NodeID", ""),
                "__meta_dockerswarm_node_hostname":
                    ((node.get("Description") or {})
                     .get("Hostname", "")),
                "__meta_dockerswarm_node_address":
                    (node.get("Status") or {}).get("Addr", ""),
            }
            for k, v in (((t.get("Spec") or {}).get("ContainerSpec")
                          or {}).get("Labels") or {}).items():
                meta["__meta_dockerswarm_container_label_"
                     f"{_sanitize(k)}"] = v
            nets = t.get("NetworksAttachments") or []
            placed = False
            for na in nets:
                for addr in na.get("Addresses") or []:
                    ip = addr.split("/")[0]
                    out.append((f"{ip}:{dport}", dict(meta)))
                    placed = True
            if not placed:
                node_addr = (node.get("Status") or {}).get("Addr", "")
                if node_addr:
                    out.append((f"{node_addr}:{dport}", meta))
        return out
    except (OSError, ValueError, KeyError, DiscoveryError) as e:
        raise DiscoveryError(f"dockerswarm_sd {host}: {e}") from e


# -- eureka (discovery/eureka/) ----------------------------------------------

def eureka_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Eureka app-instance discovery (lib/promscrape/discovery/eureka):
    GET {server}/apps, one target per instance at hostName:port."""
    server = cfg.get("server", "localhost:8080/eureka/v2")
    if not server.startswith(("http://", "https://")):
        server = "http://" + server
    try:
        data = _get_json(f"{server.rstrip('/')}/apps",
                         headers={"Accept": "application/json"})
        out: list[tuple[str, dict]] = []
        apps = ((data or {}).get("applications") or {}) \
            .get("application") or []
        if isinstance(apps, dict):
            apps = [apps]
        for app in apps:
            instances = app.get("instance") or []
            if isinstance(instances, dict):
                instances = [instances]
            for inst in instances:
                port_info = inst.get("port") or {}
                port = int(port_info.get("$", 80))
                meta = {
                    "__meta_eureka_app_name": app.get("name", ""),
                    "__meta_eureka_app_instance_id":
                        inst.get("instanceId", ""),
                    "__meta_eureka_app_instance_hostname":
                        inst.get("hostName", ""),
                    "__meta_eureka_app_instance_ip_addr":
                        inst.get("ipAddr", ""),
                    "__meta_eureka_app_instance_status":
                        inst.get("status", ""),
                    "__meta_eureka_app_instance_port": str(port),
                    "__meta_eureka_app_instance_port_enabled":
                        str(port_info.get("@enabled", "")),
                    "__meta_eureka_app_instance_vip_address":
                        inst.get("vipAddress", ""),
                    "__meta_eureka_app_instance_secure_vip_address":
                        inst.get("secureVipAddress", ""),
                    "__meta_eureka_app_instance_homepage_url":
                        inst.get("homePageUrl", ""),
                    "__meta_eureka_app_instance_statuspage_url":
                        inst.get("statusPageUrl", ""),
                    "__meta_eureka_app_instance_healthcheck_url":
                        inst.get("healthCheckUrl", ""),
                    "__meta_eureka_app_instance_country_id":
                        str(inst.get("countryId", "")),
                    "__meta_eureka_app_instance_datacenterinfo_name":
                        (inst.get("dataCenterInfo") or {})
                        .get("name", ""),
                }
                for k, v in (inst.get("metadata") or {}).items():
                    meta["__meta_eureka_app_instance_metadata_"
                         f"{_sanitize(k)}"] = str(v)
                out.append((f"{inst.get('hostName', '')}:{port}", meta))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"eureka_sd {server}: {e}") from e


# -- openstack (discovery/openstack/) ----------------------------------------

def openstack_sd(cfg: dict) -> list[tuple[str, dict]]:
    """OpenStack Nova instance discovery
    (lib/promscrape/discovery/openstack): keystone password auth for a
    token, then /servers/detail; role=hypervisor lists hypervisors."""
    identity = cfg.get("identity_endpoint", "")
    if not identity:
        raise DiscoveryError("openstack_sd: identity_endpoint is required")
    dport = int(cfg.get("port", 80))
    role = cfg.get("role", "instance")
    try:
        auth = {"auth": {
            "identity": {"methods": ["password"], "password": {"user": {
                "name": cfg.get("username", ""),
                "domain": {"name": cfg.get("domain_name", "Default")},
                "password": cfg.get("password", "")}}},
            "scope": {"project": {
                "name": cfg.get("project_name", ""),
                "domain": {"name": cfg.get("domain_name", "Default")}}}}}
        req = urllib.request.Request(
            f"{identity.rstrip('/')}/auth/tokens",
            data=json.dumps(auth).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            token = resp.headers.get("X-Subject-Token", "")
            body = json.loads(resp.read())
        catalog = ((body.get("token") or {}).get("catalog")) or []
        nova = ""
        for svc in catalog:
            if svc.get("type") == "compute":
                for ep in svc.get("endpoints") or []:
                    if ep.get("interface") == "public":
                        nova = ep.get("url", "")
        if not nova:
            raise DiscoveryError("no compute endpoint in catalog")
        hdrs = {"X-Auth-Token": token}
        out: list[tuple[str, dict]] = []
        if role == "hypervisor":
            data = _get_json(f"{nova.rstrip('/')}/os-hypervisors/detail",
                             headers=hdrs)
            for h in data.get("hypervisors") or []:
                meta = {
                    "__meta_openstack_hypervisor_id": str(h.get("id", "")),
                    "__meta_openstack_hypervisor_hostname":
                        h.get("hypervisor_hostname", ""),
                    "__meta_openstack_hypervisor_host_ip":
                        h.get("host_ip", ""),
                    "__meta_openstack_hypervisor_state":
                        h.get("state", ""),
                    "__meta_openstack_hypervisor_status":
                        h.get("status", ""),
                    "__meta_openstack_hypervisor_type":
                        h.get("hypervisor_type", ""),
                }
                out.append((f"{h.get('host_ip', '')}:{dport}", meta))
            return out
        url = f"{nova.rstrip('/')}/servers/detail"
        while url:
            data = _get_json(url, headers=hdrs)
            for srv in data.get("servers") or []:
                flavor = (srv.get("flavor") or {})
                meta_base = {
                    "__meta_openstack_instance_id": srv.get("id", ""),
                    "__meta_openstack_instance_name":
                        srv.get("name", ""),
                    "__meta_openstack_instance_status":
                        srv.get("status", ""),
                    "__meta_openstack_instance_flavor":
                        flavor.get("original_name", flavor.get("id", "")),
                    "__meta_openstack_project_id":
                        srv.get("tenant_id", ""),
                    "__meta_openstack_user_id": srv.get("user_id", ""),
                }
                for k, v in (srv.get("metadata") or {}).items():
                    meta_base[f"__meta_openstack_tag_{_sanitize(k)}"] = \
                        str(v)
                for pool, addrs in (srv.get("addresses") or {}).items():
                    for a in addrs or []:
                        ip = a.get("addr", "")
                        if not ip:
                            continue
                        meta = dict(meta_base)
                        meta["__meta_openstack_address_pool"] = pool
                        meta["__meta_openstack_private_ip"] = ip
                        out.append((f"{ip}:{dport}", meta))
            # Nova caps page size server-side; follow the next link
            url = next((ln.get("href", "")
                        for ln in data.get("servers_links") or []
                        if ln.get("rel") == "next"), "")
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"openstack_sd {identity}: {e}") from e


# -- digitalocean (discovery/digitalocean/) ----------------------------------

def digitalocean_sd(cfg: dict) -> list[tuple[str, dict]]:
    """DigitalOcean droplet discovery
    (lib/promscrape/discovery/digitalocean): /v2/droplets with bearer
    auth; target = public IPv4:port."""
    server = cfg.get("server", "https://api.digitalocean.com")
    dport = int(cfg.get("port", 80))
    headers = {}
    if cfg.get("bearer_token"):
        headers["Authorization"] = f"Bearer {cfg['bearer_token']}"
    out: list[tuple[str, dict]] = []
    url = f"{server.rstrip('/')}/v2/droplets?per_page=200"
    try:
        while url:
            data = _get_json(url, headers=headers)
            for d in data.get("droplets") or []:
                v4 = (d.get("networks") or {}).get("v4") or []
                pub = next((n["ip_address"] for n in v4
                            if n.get("type") == "public"), "")
                priv = next((n["ip_address"] for n in v4
                             if n.get("type") == "private"), "")
                if not pub:
                    continue
                meta = {
                    "__meta_digitalocean_droplet_id":
                        str(d.get("id", "")),
                    "__meta_digitalocean_droplet_name":
                        d.get("name", ""),
                    "__meta_digitalocean_image":
                        (d.get("image") or {}).get("slug", ""),
                    "__meta_digitalocean_image_name":
                        (d.get("image") or {}).get("name", ""),
                    "__meta_digitalocean_private_ipv4": priv,
                    "__meta_digitalocean_public_ipv4": pub,
                    "__meta_digitalocean_region":
                        (d.get("region") or {}).get("slug", ""),
                    "__meta_digitalocean_size":
                        (d.get("size") or {}).get("slug", ""),
                    "__meta_digitalocean_status": d.get("status", ""),
                    "__meta_digitalocean_vpc": d.get("vpc_uuid", ""),
                    "__meta_digitalocean_tags":
                        "," + ",".join(d.get("tags") or []) + ",",
                    "__meta_digitalocean_features":
                        "," + ",".join(d.get("features") or []) + ",",
                }
                out.append((f"{pub}:{dport}", meta))
            url = (((data.get("links") or {}).get("pages") or {})
                   .get("next", ""))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"digitalocean_sd {server}: {e}") from e


# -- consulagent (discovery/consulagent/) ------------------------------------

def consulagent_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Consul local-agent discovery (lib/promscrape/discovery/
    consulagent): /v1/agent/self + /v1/agent/services — the agent's own
    registrations, no catalog and no health filtering (services in
    critical state are still emitted; relabel on the health metadata if
    you need to drop them)."""
    server = cfg.get("server", "localhost:8500")
    if not server.startswith(("http://", "https://")):
        server = "http://" + server
    base = server.rstrip("/")
    try:
        node = _get_json(f"{base}/v1/agent/self") or {}
        member = node.get("Member") or {}
        node_name = member.get("Name", "")
        dc = (node.get("Config") or {}).get("Datacenter", "")
        services = _get_json(f"{base}/v1/agent/services") or {}
        want = set(cfg.get("services") or [])
        out: list[tuple[str, dict]] = []
        for svc in services.values():
            name = svc.get("Service", "")
            if want and name not in want:
                continue
            addr = svc.get("Address") or member.get("Addr", "")
            port = svc.get("Port", 0)
            meta = {
                "__meta_consulagent_address": member.get("Addr", ""),
                "__meta_consulagent_dc": dc,
                "__meta_consulagent_namespace":
                    svc.get("Namespace", ""),
                "__meta_consulagent_node": node_name,
                "__meta_consulagent_service": name,
                "__meta_consulagent_service_address": addr,
                "__meta_consulagent_service_id": svc.get("ID", ""),
                "__meta_consulagent_service_port": str(port),
                "__meta_consulagent_tags":
                    "," + ",".join(svc.get("Tags") or []) + ",",
            }
            for t in svc.get("Tags") or []:
                meta[f"__meta_consulagent_tag_{_sanitize(t)}"] = t
            for k, v in (svc.get("Meta") or {}).items():
                meta["__meta_consulagent_service_metadata_"
                     f"{_sanitize(k)}"] = str(v)
            out.append((f"{addr}:{port}", meta))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"consulagent_sd {server}: {e}") from e


# -- hetzner (discovery/hetzner/) --------------------------------------------

def hetzner_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Hetzner Cloud discovery (lib/promscrape/discovery/hetzner,
    role=hcloud): /v1/servers with bearer auth, paginated."""
    role = cfg.get("role", "hcloud")
    if role != "hcloud":
        raise DiscoveryError(f"hetzner_sd: unsupported role {role!r}")
    server = cfg.get("endpoint", "https://api.hetzner.cloud")
    dport = int(cfg.get("port", 80))
    headers = {}
    if cfg.get("bearer_token"):
        headers["Authorization"] = f"Bearer {cfg['bearer_token']}"
    url = f"{server.rstrip('/')}/v1/servers?page=1&per_page=50"
    out: list[tuple[str, dict]] = []
    try:
        # network id -> name (private_net entries carry numeric ids; the
        # documented label shape uses the network NAME); paginated like
        # /v1/servers
        net_names = {}
        try:
            nurl = f"{server.rstrip('/')}/v1/networks?page=1&per_page=50"
            while nurl:
                ndata = _get_json(nurl, headers=headers) or {}
                for nw in ndata.get("networks") or []:
                    net_names[nw.get("id")] = nw.get("name", "")
                nxt = (((ndata.get("meta") or {}).get("pagination") or {})
                       .get("next_page"))
                nurl = (f"{server.rstrip('/')}/v1/networks?page={nxt}"
                        f"&per_page=50") if nxt else ""
        except (OSError, ValueError, KeyError):
            pass  # label falls back to the id
        while url:
            data = _get_json(url, headers=headers)
            for s in data.get("servers") or []:
                pub = ((s.get("public_net") or {}).get("ipv4")
                       or {}).get("ip", "")
                dc = s.get("datacenter") or {}
                loc = dc.get("location") or {}
                stype = s.get("server_type") or {}
                img = s.get("image") or {}
                meta = {
                    "__meta_hetzner_server_id": str(s.get("id", "")),
                    "__meta_hetzner_server_name": s.get("name", ""),
                    "__meta_hetzner_server_status": s.get("status", ""),
                    "__meta_hetzner_public_ipv4": pub,
                    "__meta_hetzner_datacenter": dc.get("name", ""),
                    "__meta_hetzner_hcloud_datacenter_location":
                        loc.get("name", ""),
                    "__meta_hetzner_hcloud_datacenter_location_network_zone":
                        loc.get("network_zone", ""),
                    "__meta_hetzner_hcloud_server_type":
                        stype.get("name", ""),
                    "__meta_hetzner_hcloud_cpu_cores":
                        str(stype.get("cores", "")),
                    "__meta_hetzner_hcloud_cpu_type":
                        stype.get("cpu_type", ""),
                    "__meta_hetzner_hcloud_memory_size_gb":
                        str(stype.get("memory", "")),
                    "__meta_hetzner_hcloud_disk_size_gb":
                        str(stype.get("disk", "")),
                    "__meta_hetzner_hcloud_image_name":
                        img.get("name", ""),
                    "__meta_hetzner_hcloud_image_os_flavor":
                        img.get("os_flavor", ""),
                    "__meta_hetzner_hcloud_image_os_version":
                        img.get("os_version", ""),
                }
                for k, v in (s.get("labels") or {}).items():
                    meta[f"__meta_hetzner_hcloud_label_{_sanitize(k)}"] \
                        = str(v)
                    meta["__meta_hetzner_hcloud_labelpresent_"
                         f"{_sanitize(k)}"] = "true"
                for pn in (s.get("private_net") or []):
                    ip = pn.get("ip", "")
                    if ip:
                        nid = pn.get("network", "")
                        nname = net_names.get(nid, str(nid))
                        meta.setdefault(
                            "__meta_hetzner_hcloud_private_ipv4_"
                            f"{_sanitize(str(nname))}", ip)
                if pub:
                    out.append((f"{pub}:{dport}", meta))
            nxt = (((data.get("meta") or {}).get("pagination") or {})
                   .get("next_page"))
            url = (f"{server.rstrip('/')}/v1/servers?page={nxt}"
                   f"&per_page=50") if nxt else ""
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"hetzner_sd {server}: {e}") from e


# -- vultr (discovery/vultr/) ------------------------------------------------

def vultr_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Vultr instance discovery (lib/promscrape/discovery/vultr):
    /v2/instances with bearer auth, cursor-paginated."""
    server = cfg.get("endpoint", "https://api.vultr.com")
    dport = int(cfg.get("port", 80))
    headers = {}
    if cfg.get("bearer_token"):
        headers["Authorization"] = f"Bearer {cfg['bearer_token']}"
    url = f"{server.rstrip('/')}/v2/instances?per_page=100"
    out: list[tuple[str, dict]] = []
    try:
        while url:
            data = _get_json(url, headers=headers)
            for inst in data.get("instances") or []:
                ip = inst.get("main_ip", "")
                if not ip:
                    continue
                meta = {
                    "__meta_vultr_instance_id": inst.get("id", ""),
                    "__meta_vultr_instance_label": inst.get("label", ""),
                    "__meta_vultr_instance_hostname":
                        inst.get("hostname", ""),
                    "__meta_vultr_instance_os": inst.get("os", ""),
                    "__meta_vultr_instance_os_id":
                        str(inst.get("os_id", "")),
                    "__meta_vultr_instance_region":
                        inst.get("region", ""),
                    "__meta_vultr_instance_plan": inst.get("plan", ""),
                    "__meta_vultr_instance_main_ip": ip,
                    "__meta_vultr_instance_internal_ip":
                        inst.get("internal_ip", ""),
                    "__meta_vultr_instance_main_ipv6":
                        inst.get("v6_main_ip", ""),
                    "__meta_vultr_instance_server_status":
                        inst.get("server_status", ""),
                    "__meta_vultr_instance_vcpu_count":
                        str(inst.get("vcpu_count", "")),
                    "__meta_vultr_instance_ram_mb":
                        str(inst.get("ram", "")),
                    "__meta_vultr_instance_disk_gb":
                        str(inst.get("disk", "")),
                    "__meta_vultr_instance_allowed_bandwidth_gb":
                        str(inst.get("allowed_bandwidth", "")),
                    "__meta_vultr_instance_features":
                        "," + ",".join(inst.get("features") or []) + ",",
                    "__meta_vultr_instance_tags":
                        "," + ",".join(inst.get("tags") or []) + ",",
                }
                out.append((f"{ip}:{dport}", meta))
            cursor = (((data.get("meta") or {}).get("links") or {})
                      .get("next", ""))
            import urllib.parse as _up
            url = (f"{server.rstrip('/')}/v2/instances?per_page=100"
                   f"&cursor={_up.quote(cursor, safe='')}") \
                if cursor else ""
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"vultr_sd {server}: {e}") from e


# -- marathon (discovery/marathon/) ------------------------------------------

def marathon_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Marathon app/task discovery (lib/promscrape/discovery/marathon):
    /v2/apps?embed=apps.tasks, one target per task port."""
    servers = cfg.get("servers") or ["http://localhost:8080"]
    data = None
    errs = []
    for srv_url in servers:  # try each configured server (failover)
        base = srv_url.rstrip("/")
        try:
            data = _get_json(f"{base}/v2/apps?embed=apps.tasks")
            break
        except (OSError, ValueError) as e:
            errs.append(f"{base}: {e}")
    if data is None:
        raise DiscoveryError(f"marathon_sd: all servers failed: "
                             f"{'; '.join(errs)}")
    try:
        out: list[tuple[str, dict]] = []
        for app in (data.get("apps") or []):
            app_id = app.get("id", "")
            labels_app = app.get("labels") or {}
            container = app.get("container") or {}
            image = (container.get("docker") or {}).get("image", "")
            port_defs = app.get("portDefinitions") or []
            for task in app.get("tasks") or []:
                host = task.get("host", "")
                ports = task.get("ports") or []
                for pi, port in enumerate(ports):
                    meta = {
                        "__meta_marathon_app": app_id,
                        "__meta_marathon_task": task.get("id", ""),
                        "__meta_marathon_image": image,
                        "__meta_marathon_port_index": str(pi),
                    }
                    for k, v in labels_app.items():
                        meta[f"__meta_marathon_app_label_{_sanitize(k)}"] \
                            = str(v)
                    if pi < len(port_defs):
                        for k, v in (port_defs[pi].get("labels")
                                     or {}).items():
                            meta["__meta_marathon_port_definition_label_"
                                 f"{_sanitize(k)}"] = str(v)
                    out.append((f"{host}:{port}", meta))
        return out
    except (ValueError, KeyError) as e:
        raise DiscoveryError(f"marathon_sd {base}: {e}") from e


# -- puppetdb (discovery/puppetdb/) ------------------------------------------

def puppetdb_sd(cfg: dict) -> list[tuple[str, dict]]:
    """PuppetDB resource discovery (lib/promscrape/discovery/puppetdb):
    POST a PQL query to /pdb/query/v4, one target per resource."""
    url = cfg.get("url", "")
    query = cfg.get("query", "")
    if not url or not query:
        raise DiscoveryError("puppetdb_sd: url and query are required")
    dport = int(cfg.get("port", 80))
    include_params = bool(cfg.get("include_parameters"))
    try:
        req = urllib.request.Request(
            f"{url.rstrip('/')}/pdb/query/v4",
            data=json.dumps({"query": query}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            resources = json.loads(resp.read())
        out: list[tuple[str, dict]] = []
        for r in resources or []:
            certname = r.get("certname", "")
            if not certname:
                continue
            meta = {
                "__meta_puppetdb_certname": certname,
                "__meta_puppetdb_environment": r.get("environment", ""),
                "__meta_puppetdb_exported":
                    str(bool(r.get("exported"))).lower(),
                "__meta_puppetdb_file": r.get("file", "") or "",
                "__meta_puppetdb_query": query,
                "__meta_puppetdb_resource": r.get("resource", ""),
                "__meta_puppetdb_tags":
                    "," + ",".join(r.get("tags") or []) + ",",
            }
            if include_params:
                for k, v in (r.get("parameters") or {}).items():
                    meta[f"__meta_puppetdb_parameter_{_sanitize(k)}"] = \
                        str(v)
            out.append((f"{certname}:{dport}", meta))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"puppetdb_sd {url}: {e}") from e


# -- ovhcloud (discovery/ovhcloud/) ------------------------------------------

# per-endpoint server/local clock delta for OVH request signing, fetched
# once and reused (the official client does the same)
_OVH_TIME_DELTA: dict[str, int] = {}


def _ovh_get(cfg: dict, endpoint: str, path: str):
    """Signed OVH API GET (discovery/ovhcloud/common.go): signature =
    "$1$" + sha1(AS+CK+method+url+body+timestamp). A failed /auth/time
    is LOUD — local time would just produce mysterious 403s on skewed
    hosts."""
    import hashlib
    import time as _time
    app_key = cfg.get("application_key", "")
    app_secret = cfg.get("application_secret", "")
    consumer = cfg.get("consumer_key", "")
    delta = _OVH_TIME_DELTA.get(endpoint)
    if delta is None:
        try:
            delta = int(_get_json(f"{endpoint}/auth/time")) - \
                int(_time.time())  # vmt: disable=VMT001 (signing skew)
        except (OSError, ValueError, TypeError) as e:
            raise DiscoveryError(
                f"ovhcloud: cannot fetch {endpoint}/auth/time for "
                f"request signing: {e}") from e
        _OVH_TIME_DELTA[endpoint] = delta
    # request signing needs the real wall clock, not the cached one: the
    # signature embeds an absolute timestamp the server checks for skew
    ts = int(_time.time()) + delta  # vmt: disable=VMT001
    url = endpoint + path
    sig = hashlib.sha1(
        f"{app_secret}+{consumer}+GET+{url}++{ts}".encode()).hexdigest()
    return _get_json(url, headers={
        "X-Ovh-Application": app_key,
        "X-Ovh-Consumer": consumer,
        "X-Ovh-Timestamp": str(ts),
        "X-Ovh-Signature": f"$1${sig}",
        "Accept": "application/json"})


def ovhcloud_sd(cfg: dict) -> list[tuple[str, dict]]:
    """OVHcloud discovery (lib/promscrape/discovery/ovhcloud): roles
    vps (default) and dedicated_server, per-name detail + /ips calls."""
    import urllib.parse as _up
    endpoint = cfg.get("endpoint", "https://eu.api.ovh.com/1.0")
    role = cfg.get("service", cfg.get("role", "vps"))
    if role not in ("vps", "dedicated_server"):
        raise DiscoveryError(
            f"ovhcloud_sd: unknown service {role!r} "
            "(want `vps` or `dedicated_server`)")
    dport = int(cfg.get("port", 80))
    out: list[tuple[str, dict]] = []
    try:
        if role == "dedicated_server":
            for name in _ovh_get(cfg, endpoint, "/dedicated/server") or []:
                qn = _up.quote(name, safe="")
                d = _ovh_get(cfg, endpoint, f"/dedicated/server/{qn}")
                ips = _ovh_get(cfg, endpoint,
                               f"/dedicated/server/{qn}/ips") or []
                v4 = next((ip for ip in ips if ":" not in ip), "")
                v6 = next((ip for ip in ips if ":" in ip), "")
                meta = {
                    "__meta_ovhcloud_dedicated_server_name":
                        d.get("name", name),
                    "__meta_ovhcloud_dedicated_server_server_id":
                        str(d.get("serverId", "")),
                    "__meta_ovhcloud_dedicated_server_state":
                        d.get("state", ""),
                    "__meta_ovhcloud_dedicated_server_os":
                        d.get("os", ""),
                    "__meta_ovhcloud_dedicated_server_datacenter":
                        d.get("datacenter", ""),
                    "__meta_ovhcloud_dedicated_server_rack":
                        d.get("rack", ""),
                    "__meta_ovhcloud_dedicated_server_reverse":
                        d.get("reverse", ""),
                    "__meta_ovhcloud_dedicated_server_commercial_range":
                        d.get("commercialRange", ""),
                    "__meta_ovhcloud_dedicated_server_link_speed":
                        str(d.get("linkSpeed", "")),
                    "__meta_ovhcloud_dedicated_server_support_level":
                        d.get("supportLevel", ""),
                    "__meta_ovhcloud_dedicated_server_no_intervention":
                        str(bool(d.get("noIntervention"))).lower(),
                    "__meta_ovhcloud_dedicated_server_ipv4": v4.split(
                        "/")[0],
                    "__meta_ovhcloud_dedicated_server_ipv6": v6.split(
                        "/")[0],
                }
                addr = v4.split("/")[0] or d.get("reverse", name)
                out.append((f"{addr}:{dport}", meta))
            return out
        for name in _ovh_get(cfg, endpoint, "/vps") or []:
            qn = _up.quote(name, safe="")
            d = _ovh_get(cfg, endpoint, f"/vps/{qn}")
            ips = _ovh_get(cfg, endpoint, f"/vps/{qn}/ips") or []
            v4 = next((ip for ip in ips if ":" not in ip), "")
            v6 = next((ip for ip in ips if ":" in ip), "")
            model = d.get("model") or {}
            meta = {
                "__meta_ovhcloud_vps_name": d.get("name", name),
                "__meta_ovhcloud_vps_display_name":
                    d.get("displayName", ""),
                "__meta_ovhcloud_vps_cluster": d.get("cluster", ""),
                "__meta_ovhcloud_vps_state": d.get("state", ""),
                "__meta_ovhcloud_vps_zone": d.get("zone", ""),
                "__meta_ovhcloud_vps_datacenter":
                    str(d.get("datacenter", "")),
                "__meta_ovhcloud_vps_disk": str(model.get("disk", "")),
                "__meta_ovhcloud_vps_memory_limit":
                    str(d.get("memoryLimit", "")),
                "__meta_ovhcloud_vps_memory":
                    str(model.get("memory", "")),
                "__meta_ovhcloud_vps_model_name":
                    model.get("name", ""),
                "__meta_ovhcloud_vps_model_vcore":
                    str(model.get("vcore", "")),
                "__meta_ovhcloud_vps_maximum_additional_ip":
                    str(model.get("maximumAdditionnalIp", "")),
                "__meta_ovhcloud_vps_version": str(model.get(
                    "version", "")),
                "__meta_ovhcloud_vps_ipv4": v4.split("/")[0],
                "__meta_ovhcloud_vps_ipv6": v6.split("/")[0],
            }
            addr = v4.split("/")[0] or name
            out.append((f"{addr}:{dport}", meta))
        return out
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise DiscoveryError(f"ovhcloud_sd {endpoint}: {e}") from e


# -- yandexcloud (discovery/yandexcloud/) ------------------------------------

def yandexcloud_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Yandex Cloud compute discovery
    (lib/promscrape/discovery/yandexcloud): IAM-token auth, then
    clouds -> folders -> instances; one target per instance with
    per-interface ip/dns labels."""
    api = cfg.get("api_endpoint", "https://api.cloud.yandex.net") \
        .rstrip("/")
    dport = int(cfg.get("port", 80))
    token = cfg.get("iam_token", "")
    try:
        if not token:
            md = _get_json(
                "http://169.254.169.254/computeMetadata/v1/instance/"
                "service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"})
            token = md.get("access_token", "")
        hdrs = {"Authorization": f"Bearer {token}"}

        def paged(url: str, key: str):
            """Follow nextPageToken like every other paginated provider
            here."""
            sep = "&" if "?" in url else "?"
            page = ""
            while True:
                got = _get_json(url + (f"{sep}pageToken={page}" if page
                                       else ""), headers=hdrs) or {}
                yield from got.get(key) or []
                page = got.get("nextPageToken", "")
                if not page:
                    return

        folders = []
        for cloud in paged(f"{api}/resource-manager/v1/clouds", "clouds"):
            folders.extend(paged(
                f"{api}/resource-manager/v1/folders?cloudId="
                f"{cloud.get('id', '')}", "folders"))
        out: list[tuple[str, dict]] = []
        for folder in folders:
            fid = folder.get("id", "")
            for inst in paged(
                    f"{api}/compute/v1/instances?folderId={fid}",
                    "instances"):
                res = inst.get("resources") or {}
                meta = {
                    "__meta_yandexcloud_instance_id": inst.get("id", ""),
                    "__meta_yandexcloud_instance_name":
                        inst.get("name", ""),
                    "__meta_yandexcloud_instance_fqdn":
                        inst.get("fqdn", ""),
                    "__meta_yandexcloud_instance_status":
                        inst.get("status", ""),
                    "__meta_yandexcloud_instance_platform_id":
                        inst.get("platformId", ""),
                    "__meta_yandexcloud_folder_id": fid,
                    "__meta_yandexcloud_instance_resources_cores":
                        str(res.get("cores", "")),
                    "__meta_yandexcloud_instance_resources_core_fraction":
                        str(res.get("coreFraction", "")),
                    "__meta_yandexcloud_instance_resources_memory":
                        str(res.get("memory", "")),
                }
                for k, v in (inst.get("labels") or {}).items():
                    meta["__meta_yandexcloud_instance_label_"
                         f"{_sanitize(k)}"] = str(v)
                addr = ""
                for i, nic in enumerate(
                        inst.get("networkInterfaces") or []):
                    v4 = nic.get("primaryV4Address") or {}
                    priv = v4.get("address", "")
                    if priv:
                        meta[f"__meta_yandexcloud_instance_private_ip_"
                             f"{i}"] = priv
                        addr = addr or priv
                    nat = (v4.get("oneToOneNat") or {}).get("address", "")
                    if nat:
                        meta[f"__meta_yandexcloud_instance_public_ip_"
                             f"{i}"] = nat
                        if cfg.get("prefer_public_ip"):
                            addr = nat
                    for di, rec in enumerate(
                            v4.get("dnsRecords") or []):
                        meta[f"__meta_yandexcloud_instance_private_dns_"
                             f"{di}"] = rec.get("fqdn", "")
                if not addr:
                    addr = inst.get("fqdn", "")
                if addr:
                    out.append((f"{addr}:{dport}", meta))
        return out
    except (OSError, ValueError, KeyError) as e:
        raise DiscoveryError(f"yandexcloud_sd {api}: {e}") from e


# -- kuma (discovery/kuma/) --------------------------------------------------

def kuma_sd(cfg: dict) -> list[tuple[str, dict]]:
    """Kuma service-mesh discovery (lib/promscrape/discovery/kuma): one
    xDS DiscoveryRequest POSTed as JSON to
    {server}/v3/discovery:monitoringassignments (the MADS REST variant;
    an empty version/nonce fetches the full assignment set — the
    stateless pull matching every other provider here)."""
    import urllib.parse as _up
    server = cfg.get("server", "")
    if not server:
        raise DiscoveryError("kuma_sd: missing server")
    if "://" not in server:
        server = "http://" + server
    psu = _up.urlparse(server)
    path = psu.path
    if not path.endswith("/"):
        path += "/"
    url = (f"{psu.scheme}://{psu.netloc}{path}"
           "v3/discovery:monitoringassignments")
    if psu.query:
        url += "?" + psu.query
    body = json.dumps({
        "version_info": "",
        "node": {"id": cfg.get("client_id", "victoriametrics_tpu")},
        "resource_names": [],
        "type_url": "type.googleapis.com/"
                    "kuma.observability.v1.MonitoringAssignment",
        "response_nonce": "",
    }).encode()
    try:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json",
                                     "Accept": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            dresp = json.loads(resp.read())
        if not isinstance(dresp, dict):
            raise DiscoveryError(
                f"kuma_sd {server}: unexpected response shape "
                f"{type(dresp).__name__}")
        out: list[tuple[str, dict]] = []
        for r in dresp.get("resources") or []:
            for t in r.get("targets") or []:
                meta = {
                    "instance": t.get("name", ""),
                    "__scheme__": t.get("scheme", ""),
                    "__metrics_path__": t.get("metrics_path", ""),
                    "__meta_kuma_dataplane": t.get("name", ""),
                    "__meta_kuma_mesh": r.get("mesh", ""),
                    "__meta_kuma_service": r.get("service", ""),
                }
                for src in (r.get("labels") or {}, t.get("labels") or {}):
                    for k, v in src.items():
                        meta[f"__meta_kuma_label_{_sanitize(k)}"] = str(v)
                meta = {k: v for k, v in meta.items() if v}
                addr = t.get("address", "")
                if addr:
                    out.append((addr, meta))
        return out
    except (OSError, ValueError, KeyError, AttributeError,
            TypeError) as e:
        raise DiscoveryError(f"kuma_sd {server}: {e}") from e


PROVIDERS = {
    "kubernetes_sd_configs": kubernetes_sd,
    "consul_sd_configs": consul_sd,
    "ec2_sd_configs": ec2_sd,
    "http_sd_configs": http_sd,
    "dns_sd_configs": dns_sd,
    "docker_sd_configs": docker_sd,
    "gce_sd_configs": gce_sd,
    "azure_sd_configs": azure_sd,
    "nomad_sd_configs": nomad_sd,
    "dockerswarm_sd_configs": dockerswarm_sd,
    "eureka_sd_configs": eureka_sd,
    "openstack_sd_configs": openstack_sd,
    "digitalocean_sd_configs": digitalocean_sd,
    "consulagent_sd_configs": consulagent_sd,
    "hetzner_sd_configs": hetzner_sd,
    "vultr_sd_configs": vultr_sd,
    "marathon_sd_configs": marathon_sd,
    "puppetdb_sd_configs": puppetdb_sd,
    "ovhcloud_sd_configs": ovhcloud_sd,
    "yandexcloud_sd_configs": yandexcloud_sd,
    "kuma_sd_configs": kuma_sd,
}


def discover_targets(sc: dict, last_good: dict | None = None
                     ) -> list[tuple[str, dict]]:
    """All dynamic-provider targets for one scrape config section. On a
    provider error the provider's previous successful result is reused
    (Prometheus keeps last-known-good targets across SD hiccups); pass a
    persistent `last_good` dict to enable that."""
    import json as _json
    out: list[tuple[str, dict]] = []
    for key, fn in PROVIDERS.items():
        for cfg in sc.get(key, []) or []:
            ck = (key, _json.dumps(cfg, sort_keys=True))
            try:
                got = fn(cfg)
            except DiscoveryError as e:
                logger.errorf("%s; keeping last-known-good targets", e)
                got = (last_good or {}).get(ck, [])
            else:
                if last_good is not None:
                    last_good[ck] = got
            out.extend(got)
    return out
