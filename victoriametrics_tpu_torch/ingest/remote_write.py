"""Prometheus remote-write protocol (reference lib/protoparser/
promremotewrite + lib/prompb/prompb.go): snappy- or zstd-compressed
protobuf WriteRequest.

prompb schema subset:
  WriteRequest { repeated TimeSeries timeseries = 1;
                 repeated MetricMetadata metadata = 3; }
  TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
  Label        { string name = 1; string value = 2; }
  Sample       { double value = 1; int64 timestamp = 2; }

The port's copy of ``victoriametrics_tpu/ingest/remote_write.py``,
whole.
"""

from __future__ import annotations

from ..ops import compress as zstd
from . import snappy
from .protowire import (as_double, as_signed, iter_fields, w_bytes, w_double,
                        w_int64)


def parse_write_request(body: bytes, encoding: str = "snappy"):
    """Yields (labels: list[(str, str)], samples: list[(ts_ms, value)])."""
    if encoding == "snappy":
        data = snappy.decompress(body)
    elif encoding == "zstd":
        data = zstd.decompress(body)
    elif encoding in ("", "none", "identity"):
        data = body
    else:
        raise ValueError(f"unsupported remote-write encoding {encoding!r}")
    for fnum, wt, v in iter_fields(data):
        if fnum == 1 and wt == 2:
            yield _parse_timeseries(v)


def _parse_timeseries(data: bytes):
    labels = []
    samples = []
    for fnum, wt, v in iter_fields(data):
        if fnum == 1 and wt == 2:
            name = value = ""
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 2:
                    value = v2.decode("utf-8", "replace")
            labels.append((name, value))
        elif fnum == 2 and wt == 2:
            val = 0.0
            ts = 0
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 1:
                    val = as_double(v2)
                elif f2 == 2 and w2 == 0:
                    ts = as_signed(v2)
            samples.append((ts, val))
    return labels, samples


def build_write_request(series, compress: str = "snappy") -> bytes:
    """series: iterable of (labels list[(str,str)], samples list[(ts, val)]).
    Used by the remote-write client (vmagent) and tests."""
    out = bytearray()
    for labels, samples in series:
        ts_buf = bytearray()
        for name, value in labels:
            lbuf = bytearray()
            w_bytes(lbuf, 1, name.encode())
            w_bytes(lbuf, 2, value.encode())
            w_bytes(ts_buf, 1, bytes(lbuf))
        for ts, val in samples:
            sbuf = bytearray()
            w_double(sbuf, 1, float(val))
            w_int64(sbuf, 2, int(ts))
            w_bytes(ts_buf, 2, bytes(sbuf))
        w_bytes(out, 1, bytes(ts_buf))
    raw = bytes(out)
    if compress == "snappy":
        return snappy.compress(raw)
    if compress == "zstd":
        return zstd.compress(raw)
    return raw


# -- Prometheus remote_read (prompb ReadRequest/ReadResponse) ----------------

_MATCH_OPS = {"=": 0, "!=": 1, "=~": 2, "!~": 3}


def build_read_request(start_ms: int, end_ms: int,
                       matchers: list[tuple[str, str, str]]) -> bytes:
    """ReadRequest proto, snappy-compressed. matchers: [(op, name, value)]
    with op in =, !=, =~, !~."""
    q = bytearray()
    w_int64(q, 1, start_ms)
    w_int64(q, 2, end_ms)
    for op, name, value in matchers:
        m = bytearray()
        t = _MATCH_OPS[op]
        if t:
            w_int64(m, 1, t)
        w_bytes(m, 2, name.encode())
        w_bytes(m, 3, value.encode())
        w_bytes(q, 3, bytes(m))
    req = bytearray()
    w_bytes(req, 1, bytes(q))
    return snappy.compress(bytes(req))


def parse_read_response(body: bytes):
    """Yields (labels, [(ts_ms, value)]) per series from a
    snappy-compressed ReadResponse."""
    data = snappy.decompress(body)
    for fnum, wt, val in iter_fields(data):
        if fnum != 1 or wt != 2:        # QueryResult
            continue
        for f2, w2, ts_data in iter_fields(val):
            if f2 != 1 or w2 != 2:      # TimeSeries
                continue
            yield _parse_timeseries(ts_data)


def parse_read_request(body: bytes, encoding: str = "snappy"):
    """Yields (start_ms, end_ms, [(op, name, value)]) per Query from a
    ReadRequest (the server side of remote_read)."""
    ops = {v: k for k, v in _MATCH_OPS.items()}
    data = snappy.decompress(body) if encoding == "snappy" else body
    for fnum, wt, q in iter_fields(data):
        if fnum != 1 or wt != 2:
            continue
        start = end = 0
        matchers = []
        for f2, w2, v in iter_fields(q):
            if f2 == 1 and w2 == 0:
                start = as_signed(v)
            elif f2 == 2 and w2 == 0:
                end = as_signed(v)
            elif f2 == 3 and w2 == 2:
                t = 0
                name = value = ""
                for f3, w3, v3 in iter_fields(v):
                    if f3 == 1 and w3 == 0:
                        t = v3
                    elif f3 == 2:
                        name = v3.decode("utf-8", "replace")
                    elif f3 == 3:
                        value = v3.decode("utf-8", "replace")
                matchers.append((ops.get(t, "="), name, value))
        yield start, end, matchers


def build_read_response(results: list) -> bytes:
    """results: [[(labels_dict, ts_array, vals_array), ...]] one inner list
    per query. Returns snappy(ReadResponse)."""
    out = bytearray()
    for series_list in results:
        qr = bytearray()
        for labels, ts, vals in series_list:
            tsb = bytearray()
            for k, v in sorted(labels.items()):
                lb = bytearray()
                w_bytes(lb, 1, k.encode())
                w_bytes(lb, 2, v.encode())
                w_bytes(tsb, 1, bytes(lb))
            for t, v in zip(ts, vals):
                sb = bytearray()
                w_double(sb, 1, float(v))
                w_int64(sb, 2, int(t))
                w_bytes(tsb, 2, bytes(sb))
            w_bytes(qr, 1, bytes(tsb))
        w_bytes(out, 1, bytes(qr))
    return snappy.compress(bytes(out))
