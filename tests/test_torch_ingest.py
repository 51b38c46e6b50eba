"""The port's ingest layer (``victoriametrics_tpu_torch/ingest``) against
the reference's, in one process: every parser of ``parsers.py``, the
remote-write and remote-read codecs (snappy and zstd bodies), OTLP, the
protobuf wire helpers, the snappy codec (libsnappy and the pure-Python
codec against each other), relabeling (``hashmod`` against the
reference's ``xxhash`` digest) and the rate and series limiters.  Each
pair is fed the same bytes and must give the same rows, or the same
error, exactly (floats compared by their bits)."""

import json
import math
import struct

import numpy as np
import pytest

from victoriametrics_tpu.ingest import otlp as r_otlp
from victoriametrics_tpu.ingest import parsers as r_parsers
from victoriametrics_tpu.ingest import protowire as r_pw
from victoriametrics_tpu.ingest import ratelimiter as r_rl
from victoriametrics_tpu.ingest import relabel as r_relabel
from victoriametrics_tpu.ingest import remote_write as r_rw
from victoriametrics_tpu.ingest import serieslimits as r_sl
from victoriametrics_tpu.ingest import snappy as r_snappy
from victoriametrics_tpu_torch.ingest import otlp as p_otlp
from victoriametrics_tpu_torch.ingest import parsers as p_parsers
from victoriametrics_tpu_torch.ingest import protowire as p_pw
from victoriametrics_tpu_torch.ingest import ratelimiter as p_rl
from victoriametrics_tpu_torch.ingest import relabel as p_relabel
from victoriametrics_tpu_torch.ingest import remote_write as p_rw
from victoriametrics_tpu_torch.ingest import serieslimits as p_sl
from victoriametrics_tpu_torch.ingest import snappy as p_snappy

T0 = 1_753_700_000_000


def norm(x):
    """A comparable form: floats by their bits, rows as tuples, generators
    materialised; the two packages' Row classes compare as fields."""
    if isinstance(x, float):
        return ("f", struct.pack("<d", x).hex())
    if hasattr(x, "labels") and hasattr(x, "timestamp"):
        return ("row", norm(x.labels), x.timestamp, norm(x.value))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.tobytes())
    if isinstance(x, (list, tuple)) or hasattr(x, "__next__"):
        return [norm(i) for i in x]
    return x


def outcome(fn, *args, **kw):
    try:
        return ("ok", norm(fn(*args, **kw)))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("err", type(e).__name__, str(e))


def same(name, *args, **kw):
    """Run parsers.<name> of both packages on the same input."""
    want = outcome(getattr(r_parsers, name), *args, **kw)
    got = outcome(getattr(p_parsers, name), *args, **kw)
    assert got == want, (name, args)
    return got


def _seeded_prom_text(seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines = ["# HELP m_total a counter", "# TYPE m_total counter"]
    for i in range(40):
        v = rng.choice([rng.normal() * 1e3, float(rng.integers(0, 1e9)),
                        np.inf, -np.inf, np.nan])
        sv = {np.inf: "+Inf", -np.inf: "-Inf"}.get(v, repr(float(v)))
        if isinstance(v, float) and math.isnan(v):
            sv = "NaN"
        lab = f'{{job="j{i % 3}",inst="h-{i}",esc="a\\"b\\\\c"}}' \
            if i % 4 else ""
        ts = "" if i % 5 == 0 else f" {T0 + int(rng.integers(0, 1e6))}"
        lines.append(f"m_total{lab} {sv}{ts}")
    return "\n".join(lines) + "\n"


PROM_CASES = [
    _seeded_prom_text(0), _seeded_prom_text(1),
    'up 1\nup{a="1"} 2 1700000000000\n',
    'bad{a="1" 2\n', 'm{a="1"} notanumber\n', "m{} \n",
    'm{a="x",b="y",} 3e-5 1753700000123\n# comment\n\n',
    'm{a="\\n"} 1.5\n', "m 0x1f\n",
]


@pytest.mark.parametrize("i", range(len(PROM_CASES)))
def test_parse_prometheus(i):
    same("parse_prometheus", PROM_CASES[i], T0)
    same("parse_prometheus_metadata", PROM_CASES[i])


INFLUX_CASES = [
    f"cpu,host=h1 usage_user=42.5,usage_system=7 {T0 * 1_000_000}",
    f"cpu,host=h1,region=us\\ west value=1i,flag=true,s=\"str\" {T0 * 10**6}",
    "mem free=10u\nmem,h=a used=3.25",
    "weird\\,name,t\\=k=v\\ x f=1 1",
    "broken line without fields",
    "m f=1 notatime",
    f"disk,path=/ used=1e3,total=2E3 {T0 * 10**6}\n\n# c\n",
]


@pytest.mark.parametrize("i", range(len(INFLUX_CASES)))
@pytest.mark.parametrize("db", ["", "telegraf"])
def test_parse_influx(i, db):
    same("parse_influx", INFLUX_CASES[i], T0, db)


def test_parse_jsonl_and_series_to_jsonl():
    rng = np.random.default_rng(2)
    lines = []
    for i in range(10):
        ts = (T0 + np.sort(rng.integers(0, 10**6, 5))).tolist()
        vals = rng.normal(size=5).tolist()
        line = p_parsers.series_to_jsonl({"__name__": "jm", "i": str(i)},
                                         np.array(ts), np.array(vals))
        assert line == r_parsers.series_to_jsonl(
            {"__name__": "jm", "i": str(i)}, np.array(ts), np.array(vals))
        lines.append(line)
    text = "\n".join(lines)
    same("parse_jsonl", text)
    same("parse_jsonl", text + '\n{"metric": {"__name__": "x"}, '
         '"values": [null, "Infinity"], "timestamps": [1, 2]}')
    same("parse_jsonl", '{"metric": {}, "values": [1]}')
    same("parse_jsonl", "{not json")


CSV_CASES = [
    ("h1,42.5,1753700000\nh2,7.5,1753700000\n",
     "1:label:host,2:metric:temp,3:time:unix_s"),
    ("2025-07-28T10:00:00Z,a,1,2\n", "1:time:rfc3339,2:label:x,3:metric:m1,"
     "4:metric:m2"),
    ("1753700000123,a,1.5\n", "1:time:unix_ms,2:label:x,3:metric:m"),
    ("a,b\n", "1:label:x"),
    ("a,notnum\n", "1:label:x,2:metric:m"),
    ("1,2\n", "bad:fmt"),
]


@pytest.mark.parametrize("i", range(len(CSV_CASES)))
def test_parse_csv(i):
    same("parse_csv", *CSV_CASES[i], T0)


@pytest.mark.parametrize("text", [
    f"foo.bar.baz;dc=east 10.5 {T0 // 1000}\nx.y 1\n",
    "a.b 1.5 -1\nbad line\n", "m;t=v;u=w 3 1753700000\n", "only_name\n",
])
def test_parse_graphite(text):
    same("parse_graphite", text, T0)


@pytest.mark.parametrize("text", [
    "put sys.cpu 1753700000 42.5 host=a dc=b\nput x 1753700000123 1\n",
    "put broken\n", "get x 1 2\n",
])
def test_parse_opentsdb_telnet(text):
    same("parse_opentsdb_telnet", text)


@pytest.mark.parametrize("body", [
    json.dumps([{"metric": "ot.m", "timestamp": T0 // 1000, "value": 9.5,
                 "tags": {"t": "x"}}]).encode(),
    json.dumps({"metric": "one", "timestamp": T0, "value": "3",
                "tags": {}}).encode(),
    b"[{\"metric\": 1}]", b"not json",
])
def test_parse_opentsdb_http(body):
    same("parse_opentsdb_http", body)


@pytest.mark.parametrize("body", [
    json.dumps({"series": [{"metric": "dd.m", "points": [[T0 // 1000, 1.5],
                                                        [T0 // 1000 + 10, 2]],
                            "host": "h1", "tags": ["env:prod", "solo"],
                            "device": "sda"}]}).encode(),
    b'{"series": [{"metric": "x"}]}', b"[]", b"{bad",
])
def test_parse_datadog_v1(body):
    same("parse_datadog_v1", body)


@pytest.mark.parametrize("body", [
    json.dumps({"series": [{"metric": "dd2.m", "points": [
        {"timestamp": T0 // 1000, "value": 4.25}],
        "resources": [{"name": "h", "type": "host"}],
        "tags": ["a:b"]}]}).encode(),
    b'{"series": [{"metric": "x", "points": [{}]}]}', b"{bad",
])
def test_parse_datadog_v2(body):
    same("parse_datadog_v2", body)


@pytest.mark.parametrize("body", [
    json.dumps([{"Events": [{"eventType": "SystemSample",
                             "timestamp": T0 // 1000, "cpuPercent": 25,
                             "entityKey": "h1", "memoryUsedBytes": 1e9,
                             "someString": "s"}]}]).encode(),
    b"[{}]", b"{bad",
])
def test_parse_newrelic(body):
    same("parse_newrelic", body)


@pytest.mark.parametrize("text", [
    "\n".join(json.dumps({"host": {"host": "zh", "name": "Zabbix host"},
                          "groups": ["g1"], "item_tags": [
                              {"tag": "app", "value": "web"}],
                          "itemid": 7, "name": "CPU load",
                          "clock": T0 // 1000, "ns": 5, "value": v,
                          "type": 0})
              for v in (1.5, 2)),
    '{"host": {}, "value": "x", "type": 4}', "{bad",
])
def test_parse_zabbixconnector(text):
    same("parse_zabbixconnector", text)


@pytest.mark.parametrize("key", [
    b'm{a="1",b="x\\"y"}', b"plain", b'm{}', b'm{a="1"', b'{a="1"}'])
def test_series_keys(key):
    got = same("labels_from_series_key", key)
    if got[0] == "ok":
        labels = p_parsers.labels_from_series_key(key)
        assert p_parsers.series_key_from_labels(labels) == \
            r_parsers.series_key_from_labels(labels)


# -- remote write / read, protobuf wire, snappy --------------------------------

def _rw_series(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        labels = [("__name__", "rw_m"), ("i", str(i)),
                  ("job", f"j{i % 3}")]
        ts = (T0 + np.sort(rng.integers(0, 10**6, 8))).tolist()
        vals = rng.normal(size=8) * 10.0 ** rng.integers(-3, 9)
        vals[rng.integers(0, 8)] = np.nan
        out.append((labels, list(zip(ts, vals.tolist()))))
    return out


@pytest.mark.parametrize("compress", ["snappy", "zstd", "none"])
def test_remote_write_round_trip(compress):
    series = _rw_series(3)
    mine = p_rw.build_write_request(series, compress=compress)
    ref = r_rw.build_write_request(series, compress=compress)
    if compress != "zstd":  # zstd frames may differ by library; rows not
        assert mine == ref
    for body in (mine, ref):
        want = outcome(lambda b: list(r_rw.parse_write_request(b, compress)),
                       body)
        got = outcome(lambda b: list(p_rw.parse_write_request(b, compress)),
                      body)
        assert got == want and got[0] == "ok"


@pytest.mark.parametrize("body", [b"", b"\x0a\x05trunc", b"\xff\xff\xff",
                                  b"\x0a\x02\x0a\x00"])
def test_remote_write_bad_bodies(body):
    for enc in ("none", "snappy"):
        assert outcome(lambda: list(p_rw.parse_write_request(body, enc))) == \
            outcome(lambda: list(r_rw.parse_write_request(body, enc)))


def test_remote_read_codecs():
    matchers = [("=", "__name__", "rw_m"), ("=~", "job", "j.*"),
                ("!=", "i", "3")]
    req = p_rw.build_read_request(T0, T0 + 10**6, matchers)
    assert req == r_rw.build_read_request(T0, T0 + 10**6, matchers)
    assert norm(list(p_rw.parse_read_request(req))) == \
        norm(list(r_rw.parse_read_request(req)))
    rng = np.random.default_rng(4)
    results = [[({"__name__": "m", "i": str(i)},
                 T0 + np.arange(5, dtype=np.int64) * 15_000,
                 rng.normal(size=5)) for i in range(3)]]
    resp = p_rw.build_read_response(results)
    assert resp == r_rw.build_read_response(results)
    assert norm(p_rw.parse_read_response(resp)) == \
        norm(r_rw.parse_read_response(resp))


def test_protowire():
    rng = np.random.default_rng(5)
    buf_p, buf_r = bytearray(), bytearray()
    for i in range(50):
        x = int(rng.integers(0, 2**63))
        d = float(rng.normal())
        for pw, buf in ((p_pw, buf_p), (r_pw, buf_r)):
            pw.w_varint(buf, x)
            pw.w_int64(buf, i + 1, -x)
            pw.w_double(buf, i + 1, d)
            pw.w_bytes(buf, i + 1, b"payload%d" % i)
    assert buf_p == buf_r
    data = bytes(buf_p)
    i = 0
    while i < 100:
        assert p_pw.read_varint(data, i) == r_pw.read_varint(data, i)
        i += 7
    msg = bytearray()
    for i in range(20):
        p_pw.w_int64(msg, i % 5 + 1, -i)
        p_pw.w_double(msg, i % 5 + 1, i / 3)
        p_pw.w_bytes(msg, i % 5 + 1, b"x" * i)
    assert norm(list(p_pw.iter_fields(bytes(msg)))) == \
        norm(list(r_pw.iter_fields(bytes(msg))))
    assert outcome(lambda: list(p_pw.iter_fields(b"\x0a\xff"))) == \
        outcome(lambda: list(r_pw.iter_fields(b"\x0a\xff")))
    for v in (0, 1, 2**63, 2**64 - 1, 12345):
        assert p_pw.zigzag64(v) == r_pw.zigzag64(v)
        assert p_pw.as_signed(v) == r_pw.as_signed(v)
        assert norm(p_pw.as_double(v)) == norm(r_pw.as_double(v))


@pytest.mark.parametrize("seed", range(4))
def test_snappy_both_codecs(seed):
    """libsnappy (ctypes) and the pure-Python codec against each other,
    and against the reference's module."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 200_000))
    data = bytes(rng.integers(0, 4 if seed % 2 else 256, n, dtype=np.uint8))
    py = p_snappy._py_compress(data)
    assert py == r_snappy._py_compress(data)
    assert p_snappy._py_decompress(py) == data
    assert p_snappy.decompress(py) == data
    if p_snappy._lib is not None:
        lib = p_snappy.compress(data)
        assert lib == r_snappy.compress(data)
        assert p_snappy._py_decompress(lib) == data
        assert p_snappy.decompress(lib) == data
    for bad in (b"\xff\xff\xff\xff\xff\xff", py[:len(py) // 2] + b"\x07",
                b"\x05\x00"):
        assert outcome(p_snappy._py_decompress, bad) == \
            outcome(r_snappy._py_decompress, bad)
        assert outcome(p_snappy.decompress, bad) == \
            outcome(r_snappy.decompress, bad)


# -- OTLP ----------------------------------------------------------------------

def _otlp_payload(pw, seed: int, t0: int = T0) -> bytes:
    """An ExportMetricsServiceRequest with gauges, cumulative sums,
    histograms and summaries, built with the wire helpers."""
    rng = np.random.default_rng(seed)

    def kv(key, val):
        b = bytearray()
        pw.w_bytes(b, 1, key.encode())
        av = bytearray()
        if isinstance(val, str):
            pw.w_bytes(av, 1, val.encode())
        elif isinstance(val, bool):
            pw.w_tag(av, 2, 0)
            pw.w_varint(av, int(val))
        else:
            pw.w_tag(av, 4, 1)
            av += struct.pack("<d", val)
        pw.w_bytes(b, 2, bytes(av))
        return bytes(b)

    def fixed64(buf, fnum, u):
        pw.w_tag(buf, fnum, 1)
        buf += struct.pack("<Q", u)

    def num_dp(ts_ns, val, attrs=(), flags=0):
        dp = bytearray()
        fixed64(dp, 3, ts_ns)
        if isinstance(val, int):
            pw.w_tag(dp, 6, 1)
            dp += struct.pack("<q", val)
        else:
            pw.w_tag(dp, 4, 1)
            dp += struct.pack("<d", val)
        for k, v in attrs:
            pw.w_bytes(dp, 7, kv(k, v))
        if flags:
            pw.w_tag(dp, 8, 0)
            pw.w_varint(dp, flags)
        return bytes(dp)

    def metric(name, field, dps, extra=b""):
        m = bytearray()
        pw.w_bytes(m, 1, name.encode())
        body = bytearray()
        for dp in dps:
            pw.w_bytes(body, 1, dp)
        body += extra
        pw.w_bytes(m, field, bytes(body))
        return bytes(m)

    def hist_dp(ts_ns):
        dp = bytearray()
        fixed64(dp, 3, ts_ns)
        fixed64(dp, 4, int(rng.integers(10, 100)))
        pw.w_tag(dp, 5, 1)
        dp += struct.pack("<d", float(rng.normal() * 100))
        pw.w_bytes(dp, 6, struct.pack("<QQQ", *rng.integers(0, 9, 3)))
        pw.w_bytes(dp, 7, struct.pack("<dd", 0.1, 1.0))
        pw.w_bytes(dp, 9, kv("route", "/a"))
        return bytes(dp)

    def summary_dp(ts_ns):
        dp = bytearray()
        fixed64(dp, 3, ts_ns)
        fixed64(dp, 4, 7)
        pw.w_tag(dp, 5, 1)
        dp += struct.pack("<d", 12.5)
        for q, v in ((0.5, 1.25), (0.99, 9.5)):
            qv = bytearray()
            pw.w_tag(qv, 1, 1)
            qv += struct.pack("<d", q)
            pw.w_tag(qv, 2, 1)
            qv += struct.pack("<d", v)
            pw.w_bytes(dp, 6, bytes(qv))
        return bytes(dp)

    ts_ns = t0 * 1_000_000
    sm = bytearray()
    gauges = [num_dp(ts_ns + i, float(rng.normal()),
                     [("env", "dev"), ("n", float(i)), ("b", True)])
              for i in range(5)]
    pw.w_bytes(sm, 2, metric("otlp.gauge", 5, gauges))
    sums = [num_dp(ts_ns + i, int(rng.integers(0, 1000)), [("k", "v")],
                   flags=1 if i == 2 else 0) for i in range(4)]
    temp = bytearray()
    pw.w_tag(temp, 2, 0)
    pw.w_varint(temp, 2)
    pw.w_tag(temp, 3, 0)
    pw.w_varint(temp, 1)
    pw.w_bytes(sm, 2, metric("otlp.requests", 7, sums, bytes(temp)))
    pw.w_bytes(sm, 2, metric("otlp.latency", 9, [hist_dp(ts_ns),
                                                  hist_dp(ts_ns + 1)]))
    pw.w_bytes(sm, 2, metric("otlp.sum", 11, [summary_dp(ts_ns)]))
    resource = bytearray()
    pw.w_bytes(resource, 1, kv("service.name", "svc1"))
    rm = bytearray()
    pw.w_bytes(rm, 1, bytes(resource))
    pw.w_bytes(rm, 2, bytes(sm))
    req = bytearray()
    pw.w_bytes(req, 1, bytes(rm))
    return bytes(req)


@pytest.mark.parametrize("seed", range(3))
def test_otlp(seed):
    body = _otlp_payload(p_pw, seed)
    assert body == _otlp_payload(r_pw, seed)
    want = outcome(lambda: list(r_otlp.parse_otlp(body)))
    assert want[0] == "ok" and want[1]
    assert outcome(lambda: list(p_otlp.parse_otlp(body))) == want


@pytest.mark.parametrize("body", [b"", b"\x01\x02 not a protobuf",
                                  b"\x0a\x03\x12\x01"])
def test_otlp_garbage(body):
    assert outcome(lambda: list(p_otlp.parse_otlp(body))) == \
        outcome(lambda: list(r_otlp.parse_otlp(body)))


# -- relabeling ----------------------------------------------------------------

RELABEL_CFG = [
    {"action": "replace", "source_labels": ["job", "i"],
     "target_label": "ji", "separator": "-"},
    {"action": "hashmod", "source_labels": ["i"], "target_label": "shard",
     "modulus": 7},
    {"action": "labelmap", "regex": "e_(.+)", "replacement": "x_$1"},
    {"action": "keep_if_equal", "source_labels": ["a", "b"]},
    {"action": "drop", "source_labels": ["job"], "regex": "j2"},
    {"action": "labeldrop", "regex": "tmp.*"},
    {"action": "lowercase", "source_labels": ["Up"], "target_label": "up"},
    {"action": "graphite", "match": "*.svc.*",
     "labels": {"__name__": "svc_$2", "host": "$1"}},
    {"if": '{job="j1"}', "action": "replace", "target_label": "one",
     "replacement": "yes"},
]


def _labelsets(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        d = {"__name__": "m" if i % 9 else f"h{i}.svc.x", "i": str(i),
             "job": f"j{i % 3}", "e_a": "1", "tmp1": "z",
             "Up": "MiXeD"}
        if rng.random() < 0.5:
            d["a"] = d["b"] = str(rng.integers(0, 3))
        else:
            d["a"], d["b"] = "1", "2"
        out.append(d)
    return out


@pytest.mark.parametrize("k", range(len(RELABEL_CFG) + 1))
def test_relabel(k):
    """Each action alone, then the whole chain, on the same label sets."""
    cfg = RELABEL_CFG if k == len(RELABEL_CFG) else [RELABEL_CFG[k]]
    mine = p_relabel.parse_relabel_configs(cfg)
    ref = r_relabel.parse_relabel_configs(cfg)
    for labels in _labelsets(k):
        assert outcome(mine.apply, dict(labels)) == \
            outcome(ref.apply, dict(labels))


def test_relabel_hashmod_is_xxhash():
    """hashmod goes through the port's native xxh64, which must give the
    xxhash digest the reference uses."""
    import xxhash
    cfg = [{"action": "hashmod", "source_labels": ["i"],
            "target_label": "s", "modulus": 2**32 - 5}]
    mine = p_relabel.parse_relabel_configs(cfg)
    for i in range(200):
        src = f"series-{i}-" + "x" * (i % 40)
        got = mine.apply({"__name__": "m", "i": src})["s"]
        assert got == str(xxhash.xxh64_intdigest(src.encode()) % (2**32 - 5))


@pytest.mark.parametrize("cfg", [
    [{"action": "nosuchaction"}], [{"action": "replace", "regex": "("}],
    [{"action": "hashmod", "source_labels": ["a"]}], "not: [valid",
])
def test_relabel_config_errors(cfg):
    """The same error, or configs that relabel alike."""
    def parsed(mod):
        try:
            return mod.parse_relabel_configs(cfg)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            return (type(e).__name__, str(e))
    mine, ref = parsed(p_relabel), parsed(r_relabel)
    if isinstance(ref, tuple):
        assert mine == ref
        return
    for labels in _labelsets(9):
        assert outcome(mine.apply, dict(labels)) == \
            outcome(ref.apply, dict(labels))


# -- limits --------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_rate_limiter_sequence():
    """The same admissions, rejections and Retry-After values on a fake
    clock."""
    seqs = []
    for mod in (p_rl, r_rl):
        clk = FakeClock()
        rl = mod.RateLimiter(1000, clock=clk)
        trl = mod.TenantRateLimiters(global_limit=3000, per_tenant_limit=700,
                                     max_wait_s=0, clock=clk)
        rs = np.random.default_rng(6)
        out = []
        for _ in range(200):
            n = int(rs.integers(0, 600))
            clk.t += float(rs.random()) * 0.3
            out.append(rl.register_bounded(n, max_wait_s=0))
            try:
                trl.register(n, tenant=(int(rs.integers(0, 3)), 0))
                out.append("ok")
            except mod.RateLimitedError as e:
                out.append(("429", e.retry_after_s, str(e)))
        out.append((rl.limit_reached, trl.enabled()))
        seqs.append(out)
    assert seqs[0] == seqs[1]


def test_series_limits():
    rng = np.random.default_rng(7)
    mine = p_sl.SeriesLimits(max_labels_per_series=5, max_label_name_len=8,
                             max_label_value_len=10)
    ref = r_sl.SeriesLimits(max_labels_per_series=5, max_label_name_len=8,
                            max_label_value_len=10)
    for _ in range(300):
        n = int(rng.integers(1, 8))
        labels = {("k" * int(rng.integers(1, 11)) + str(j)):
                  "v" * int(rng.integers(0, 13)) for j in range(n)}
        assert mine.check(labels) == ref.check(labels)
    assert mine.metrics() == ref.metrics()
