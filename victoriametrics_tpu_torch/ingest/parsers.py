"""Text-based ingestion parsers (reference lib/protoparser/*):

- Prometheus text exposition (lib/protoparser/prometheus)
- InfluxDB line protocol (lib/protoparser/influx)
- VM JSON-lines import/export format (lib/protoparser/vmimport)
- CSV with format spec (lib/protoparser/csvimport)
- Graphite plaintext (lib/protoparser/graphite)
- OpenTSDB telnet put + HTTP JSON (lib/protoparser/opentsdb{,http})
- DataDog v1/v2 JSON (lib/protoparser/datadog{v1,v2})
- NewRelic infra JSON (lib/protoparser/newrelic)

Every parser yields Row(labels, timestamp_ms, value); labels is a list of
(name, value) str pairs including __name__.

The port's copy of ``victoriametrics_tpu/ingest/parsers.py``, whole:
``parse_prometheus_fast`` reads through the port's native line scanner
(``native/parse.cpp``, ``native.parse_prom_raw``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time


@dataclasses.dataclass
class Row:
    labels: list          # [(name, value)]
    timestamp: int        # unix ms; 0 = "now"
    value: float

    def with_default_ts(self, now_ms: int) -> "Row":
        if self.timestamp == 0:
            self.timestamp = now_ms
        return self


def _now_ms() -> int:
    from ..utils import fasttime
    return fasttime.unix_ms()


# -- Prometheus text exposition ----------------------------------------------

def parse_prometheus(text: str, default_ts: int = 0):
    """`metric{a="b"} value [timestamp_ms]` lines; # comments skipped."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        row = _parse_prom_line(line)
        if row is not None:
            yield row.with_default_ts(default_ts or _now_ms())


def _find_closing_brace(s: str, start: int) -> int:
    """Quote-aware scan for the '}' ending a label set ('}' may appear
    inside quoted label values). Returns -1 when unterminated."""
    in_q = False
    i = start
    n = len(s)
    while i < n:
        c = s[i]
        if in_q:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_q = False
        elif c == '"':
            in_q = True
        elif c == "}":
            return i
        i += 1
    return -1


def _parse_prom_line(line: str) -> Row | None:
    labels = []
    brace = line.find("{")
    sp = line.find(" ")
    if brace >= 0 and (sp < 0 or brace < sp):
        name = line[:brace]
        close = _find_closing_brace(line, brace + 1)
        if close < 0:
            return None
        lab_str = line[brace + 1:close]
        rest = line[close + 1:]
        labels.append(("__name__", name.strip()))
        labels += _parse_prom_labels(lab_str)
    else:
        parts = line.split(None, 1)
        if len(parts) < 2:
            return None
        name, rest = parts
        labels.append(("__name__", name))
    fields = rest.split()
    if not fields:
        return None
    try:
        value = _parse_float(fields[0])
    except ValueError:
        return None
    ts = 0
    if len(fields) > 1:
        try:
            ts = int(float(fields[1]))
        except ValueError:
            ts = 0
    return Row(labels, ts, value)


def _parse_prom_labels(s: str) -> list:
    out = []
    i = 0
    n = len(s)
    while i < n:
        while i < n and s[i] in ", \t":
            i += 1
        if i >= n:
            break
        j = s.index("=", i)
        name = s[i:j].strip()
        i = j + 1
        if i < n and s[i] == '"':
            i += 1
            buf = []
            while i < n and s[i] != '"':
                if s[i] == "\\" and i + 1 < n:
                    c = s[i + 1]
                    buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(c, "\\" + c))
                    i += 2
                else:
                    buf.append(s[i])
                    i += 1
            i += 1
            out.append((name, "".join(buf)))
        else:
            j = i
            while j < n and s[j] not in ",":
                j += 1
            out.append((name, s[i:j].strip()))
            i = j
    return [(k, v) for k, v in out if v]


def _parse_float(s: str) -> float:
    sl = s.lower()
    if sl in ("nan",):
        return math.nan
    if sl in ("+inf", "inf"):
        return math.inf
    if sl == "-inf":
        return -math.inf
    return float(s)


# -- InfluxDB line protocol ---------------------------------------------------

def parse_influx(text: str, default_ts: int = 0, db: str = ""):
    """measurement[,tag=v...] field=value[,field2=v2...] [timestamp_ns]

    Each field becomes a metric named {measurement}_{field} (the reference's
    default influx mapping with -influxMeasurementFieldSeparator="_")."""
    now = default_ts or _now_ms()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        yield from _parse_influx_line(line, now, db)


def _split_unescaped(s: str, sep: str, escapable=",= ", keep=False):
    """Split on unescaped `sep`. With keep=True the escape sequences are
    preserved in the pieces (so nested splits still see them); unescape
    with _influx_unescape after the LAST split."""
    out = []
    cur = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s) and s[i + 1] in escapable + "\\":
            if keep:
                cur.append(c)
            cur.append(s[i + 1])
            i += 2
            continue
        if c == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _influx_unescape(s: str, escapable=",= "):
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s) and s[i + 1] in escapable + "\\":
            out.append(s[i + 1])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_influx_line(line: str, now: int, db: str):
    if "\\" not in line and '"' not in line:
        # fast path: no escapes / quoted strings — plain splits (the
        # overwhelmingly common shape from telegraf and tsbs load)
        sections = line.split(" ", 2)
        if len(sections) < 2:
            return
        ts = now
        if len(sections) > 2 and sections[2].strip():
            ts = int(sections[2].strip()) // 1_000_000  # ns -> ms
        parts = sections[0].split(",")
        measurement = parts[0]
        tags = [("db", db)] if db else []
        for t in parts[1:]:
            k, sep, v = t.partition("=")
            if sep and v:
                tags.append((k, v))
        for f in sections[1].split(","):
            fname, sep, fval = f.partition("=")
            if not sep:
                continue
            v = _influx_field_value(fval)
            if v is None:
                continue
            name = f"{measurement}_{fname}" if fname != "value" else measurement
            yield Row([("__name__", name)] + tags, ts, v)
        return
    # slow path: split into up to 3 space-separated sections honoring
    # escapes/quotes
    sections = []
    cur = []
    in_quotes = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == '"':
            in_quotes = not in_quotes
            cur.append(c)
        elif c == "\\" and i + 1 < len(line):
            cur.append(c)
            cur.append(line[i + 1])
            i += 1
        elif c == " " and not in_quotes and len(sections) < 2:
            sections.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    sections.append("".join(cur))
    if len(sections) < 2:
        return
    key = sections[0]
    fields_str = sections[1]
    ts = now
    if len(sections) > 2 and sections[2].strip():
        ts = int(sections[2].strip()) // 1_000_000  # ns -> ms
    parts = _split_unescaped(key, ",", keep=True)
    measurement = _influx_unescape(parts[0])
    tags = []
    if db:
        tags.append(("db", db))
    for t in parts[1:]:
        # split on the FIRST unescaped '=' (matches the fast path's
        # partition(): later '=' belong to the value)
        kv = _split_unescaped(t, "=", keep=True)
        if len(kv) >= 2 and kv[1]:
            tags.append((_influx_unescape(kv[0]),
                         _influx_unescape("=".join(kv[1:]))))
    for f in _split_unescaped(fields_str, ",", keep=True):
        kv = _split_unescaped(f, "=", keep=True)
        if len(kv) < 2:
            continue
        fname, fval = _influx_unescape(kv[0]), "=".join(kv[1:])
        v = _influx_field_value(fval)
        if v is None:
            continue
        name = f"{measurement}_{fname}" if fname != "value" else measurement
        yield Row([("__name__", name)] + tags, ts, v)


def _influx_field_value(s: str):
    if not s:
        return None
    if s[0] == '"':
        return None  # string field: not a sample
    if s in ("t", "T", "true", "True", "TRUE"):
        return 1.0
    if s in ("f", "F", "false", "False", "FALSE"):
        return 0.0
    if s.endswith(("i", "u")):
        s = s[:-1]
    try:
        return float(s)
    except ValueError:
        return None


# -- VM JSON lines (import/export) -------------------------------------------

def parse_jsonl(text: str):
    """{"metric":{"__name__":"m","l":"v"},"values":[..],"timestamps":[..]}"""
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        labels = list(obj["metric"].items())
        vals = obj.get("values", [])
        tss = obj.get("timestamps", [])
        for ts, v in zip(tss, vals):
            yield Row(labels, int(ts),
                      math.nan if v is None else float(v))


def series_to_jsonl(metric: dict, timestamps, values) -> str:
    vals = [None if (isinstance(v, float) and math.isnan(v)) else v
            for v in values]
    return json.dumps({"metric": metric, "values": vals,
                       "timestamps": [int(t) for t in timestamps]},
                      separators=(",", ":"))


# -- CSV with format spec ------------------------------------------------------

def parse_csv(text: str, fmt: str, default_ts: int = 0):
    """fmt: comma-separated column rules like
    "2:metric:temperature,1:label:city,3:time:unix_ms"
    (reference lib/protoparser/csvimport/column_descriptor.go)."""
    import csv as _csv
    import io
    rules = []
    for item in fmt.split(","):
        pos, kind, arg = (item.split(":", 2) + [""])[:3]
        rules.append((int(pos) - 1, kind, arg))
    now = default_ts or _now_ms()
    for rec in _csv.reader(io.StringIO(text)):
        if not rec:
            continue
        labels = []
        ts = now
        metrics = []
        try:
            for pos, kind, arg in rules:
                cell = rec[pos]
                if kind == "label":
                    if cell:
                        labels.append((arg, cell))
                elif kind == "metric":
                    metrics.append((arg, _parse_float(cell)))
                elif kind == "time":
                    if arg == "unix_s":
                        ts = int(float(cell) * 1000)
                    elif arg == "unix_ms":
                        ts = int(float(cell))
                    elif arg == "unix_ns":
                        ts = int(float(cell)) // 1_000_000
                    elif arg.startswith("rfc3339"):
                        import datetime
                        ts = int(datetime.datetime.fromisoformat(
                            cell.replace("Z", "+00:00")).timestamp() * 1000)
        except (IndexError, ValueError):
            continue
        for name, val in metrics:
            yield Row([("__name__", name)] + labels, ts, val)


# -- Graphite plaintext --------------------------------------------------------

def parse_graphite(text: str, default_ts: int = 0):
    """`metric.path[;tag=value...] value [timestamp_s]`"""
    now = default_ts or _now_ms()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        name_part = parts[0]
        tags = []
        if ";" in name_part:
            segs = name_part.split(";")
            name_part = segs[0]
            for t in segs[1:]:
                if "=" in t:
                    k, v = t.split("=", 1)
                    if v:
                        tags.append((k, v))
        try:
            value = _parse_float(parts[1])
        except ValueError:
            continue
        ts = now
        if len(parts) > 2:
            try:
                t = float(parts[2])
                ts = int(t * 1000) if t > 0 else now
            except ValueError:
                pass
        yield Row([("__name__", name_part)] + tags, ts, value)


# -- OpenTSDB ------------------------------------------------------------------

def parse_opentsdb_telnet(text: str):
    """`put metric ts value tag=v ...` (seconds or ms timestamps)."""
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 4 or parts[0] != "put":
            continue
        try:
            ts = int(float(parts[2]))
            value = _parse_float(parts[3])
        except ValueError:
            continue
        if ts < 1e12:
            ts *= 1000
        tags = []
        for t in parts[4:]:
            if "=" in t:
                k, v = t.split("=", 1)
                if v:
                    tags.append((k, v))
        yield Row([("__name__", parts[1])] + tags, int(ts), value)


def parse_opentsdb_http(body: bytes):
    """JSON: single object or array of {metric, timestamp, value, tags}."""
    obj = json.loads(body)
    items = obj if isinstance(obj, list) else [obj]
    for it in items:
        ts = int(it.get("timestamp", 0))
        if ts and ts < 1e12:
            ts *= 1000
        tags = [(k, str(v)) for k, v in it.get("tags", {}).items() if v]
        yield Row([("__name__", str(it["metric"]))] + tags,
                  ts or _now_ms(), float(it["value"]))


# -- DataDog -------------------------------------------------------------------

def parse_datadog_v1(body: bytes):
    """POST /api/v1/series: {"series":[{"metric","points":[[ts_s, v]],
    "tags":["k:v"], "host"}]}"""
    obj = json.loads(body)
    for s in obj.get("series", []):
        labels = [("__name__", _dd_name(s["metric"]))]
        if s.get("host"):
            labels.append(("host", s["host"]))
        if s.get("device"):
            labels.append(("device", s["device"]))
        for tag in s.get("tags") or []:
            if ":" in tag:
                k, v = tag.split(":", 1)
                if v:
                    labels.append((k.replace("-", "_").replace(".", "_"), v))
        for point in s.get("points", []):
            ts, v = point[0], point[1]
            yield Row(list(labels), int(float(ts) * 1000), float(v))


def parse_datadog_v2(body: bytes):
    """POST /api/v2/series: points have {"timestamp": s, "value": v}."""
    obj = json.loads(body)
    for s in obj.get("series", []):
        labels = [("__name__", _dd_name(s["metric"]))]
        for r in s.get("resources") or []:
            if r.get("type") and r.get("name"):
                labels.append((r["type"], r["name"]))
        for tag in s.get("tags") or []:
            if ":" in tag:
                k, v = tag.split(":", 1)
                if v:
                    labels.append((k.replace("-", "_").replace(".", "_"), v))
        for p in s.get("points", []):
            yield Row(list(labels), int(p["timestamp"]) * 1000,
                      float(p["value"]))


def _dd_name(name: str) -> str:
    return name.replace("-", "_").replace(".", "_").replace(" ", "_")


# -- NewRelic ------------------------------------------------------------------

def parse_newrelic(body: bytes):
    """Infra agent events JSON -> samples (numeric event fields)."""
    obj = json.loads(body)
    for ev_list in obj if isinstance(obj, list) else [obj]:
        events = ev_list.get("Events", [])
        for ev in events:
            etype = _snake(str(ev.get("eventType", "newrelic")))
            ts = int(ev.get("timestamp", 0))
            if ts and ts < 1e12:
                ts *= 1000
            labels = []
            samples = []
            for k, v in ev.items():
                if k in ("eventType", "timestamp"):
                    continue
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    samples.append((k, float(v)))
                elif isinstance(v, str) and v:
                    labels.append((_snake(k), v))
            for k, v in samples:
                yield Row([("__name__", f"{etype}_{_snake(k)}")] + labels,
                          ts or _now_ms(), v)


def _snake(s: str) -> str:
    out = []
    for i, c in enumerate(s):
        if c.isupper() and i and (not s[i - 1].isupper()):
            out.append("_")
        out.append(c.lower())
    return "".join(out).replace(".", "_").replace("-", "_")


# -- Zabbix Connector (lib/protoparser/zabbixconnector/parser.go) -------------

def parse_zabbixconnector(text: str):
    """JSON lines from Zabbix real-time export (item values):
    {"host":{"host":"h","name":"visible"},"name":"item","value":1.5,
     "clock":..., "ns":..., "item_tags":[{"tag":"t","value":"v"},...]}
    Labels: __name__=name, host, hostname, tag_<k>=<v>."""
    import json as _json
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            o = _json.loads(line)
        except ValueError:
            continue
        host = o.get("host") or {}
        name = o.get("name")
        if not host.get("host") or not host.get("name") or not name:
            continue
        if "value" not in o or "clock" not in o:
            continue
        try:
            value = float(o["value"])
            ts = int(o["clock"]) * 1000 + int(o.get("ns", 0)) // 1_000_000
        except (TypeError, ValueError):
            continue
        labels = [("__name__", str(name)), ("host", str(host["host"])),
                  ("hostname", str(host["name"]))]
        for t in o.get("item_tags") or []:
            k = t.get("tag")
            v = t.get("value", "")
            if k and v:
                labels.append((f"tag_{k}", str(v)))
        yield Row(labels, ts, value)


def parse_prometheus_metadata(text: str) -> dict:
    """# HELP / # TYPE comments -> {metric: {"type": t, "help": h}}
    (lib/storage/metricsmetadata source data)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("#"):
            continue
        parts = line.split(None, 3)
        # strictly "# TYPE <name> <type>" / "# HELP <name> <text>" — any
        # other comment is ignored
        if len(parts) < 4 or parts[0] != "#" or \
                parts[1] not in ("HELP", "TYPE"):
            continue
        kind, name, rest = parts[1], parts[2], parts[3]
        e = out.setdefault(name, {"type": "", "help": ""})
        if kind == "TYPE":
            e["type"] = rest.strip()
        else:
            e["help"] = rest
    return out


def labels_from_series_key(key: bytes) -> list:
    """Decompose a raw `name{labels}` series key (as produced by the native
    parser, native/parse.cpp) into [(name, value), ...] — the slow path
    taken only on TSID-cache misses. Duplicate label names collapse
    last-wins, matching the dict(labels) Python ingest path. Raises
    ValueError on malformed keys (callers skip the row)."""
    text = key.decode("utf-8", "replace")
    try:
        row = _parse_prom_line(text + " 0")
    except ValueError as e:
        raise ValueError(f"invalid series key {text!r}: {e}") from None
    if row is None:
        raise ValueError(f"invalid series key {text!r}")
    return list(dict(row.labels).items())


def series_key_from_labels(labels) -> bytes:
    """Inverse of labels_from_series_key: build the canonical raw
    `name{k="v",...}` text key from [(name, value)] pairs (labels sorted,
    values escaped). Used by cluster vminsert to ship RELABELED series
    keys columnar — the storage node must see the post-transform key."""
    name = ""
    rest = []
    for k, v in labels:
        ks = k.decode() if isinstance(k, bytes) else k
        vs = v.decode() if isinstance(v, bytes) else v
        if ks == "__name__":
            name = vs
        else:
            rest.append((ks, vs))
    rest.sort()
    if not rest:
        return name.encode()
    parts = []
    for ks, vs in rest:
        vs = vs.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append(f'{ks}="{vs}"')
    return f"{name}{{{','.join(parts)}}}".encode()


def parse_prometheus_fast(data: bytes, default_ts: int = 0):
    """Native-accelerated prometheus parse returning raw-key rows
    [(series_key_bytes, ts_ms, value)] suitable for Storage.add_rows.
    Falls back to the Python parser (materialized labels) when the native
    library is unavailable."""
    from .. import native
    rows = native.parse_prom_raw(data, default_ts or _now_ms())
    if rows is not None:
        return rows
    out = []
    for row in parse_prometheus(data.decode("utf-8", "replace"), default_ts):
        out.append((row.labels, row.timestamp, row.value))
    return out
