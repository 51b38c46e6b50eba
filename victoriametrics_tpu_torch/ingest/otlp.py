"""OpenTelemetry OTLP/HTTP metrics ingestion (reference lib/protoparser/
opentelemetry, 2626 LoC of easyproto decoding — here via the same protowire
reader used for remote-write).

Wire schema subset (opentelemetry/proto/metrics/v1/metrics.proto):

  ExportMetricsServiceRequest { repeated ResourceMetrics resource_metrics=1 }
  ResourceMetrics { Resource resource=1; repeated ScopeMetrics scope_metrics=2 }
  Resource        { repeated KeyValue attributes=1 }
  ScopeMetrics    { repeated Metric metrics=2 }
  Metric { string name=1; ...; oneof { Gauge gauge=5; Sum sum=7;
           Histogram histogram=9; Summary summary=11 } }
  Gauge/Sum       { repeated NumberDataPoint data_points=1 }
  Histogram       { repeated HistogramDataPoint data_points=1 }
  Summary         { repeated SummaryDataPoint data_points=1 }
  NumberDataPoint { time_unix_nano=3 fixed64; as_double=4; as_int=6 sfixed64;
                    attributes=7 }
  HistogramDataPoint { count=4 fixed64; sum=5 double; bucket_counts=6 packed
                    fixed64; explicit_bounds=7 packed double;
                    time_unix_nano=3; attributes=9 }
  SummaryDataPoint { time_unix_nano=3; count=4; sum=5;
                    quantile_values=6 { quantile=1 double; value=2 double };
                    attributes=7 }
  KeyValue { key=1; AnyValue value=2 { string=1 bool=2 int=3 double=4 } }

Prometheus mapping follows the reference defaults: metric and label names
are stored AS-IS (no dot/dash rewriting — that is the opt-in
usePrometheusNaming mode); histograms expand to `<name>_bucket{le}` +
`<name>_sum` + `<name>_count`, summaries to `<name>{quantile}` + sum/count;
resource attributes become labels. Datapoints flagged NO_RECORDED_VALUE
ingest as staleness markers.

The port's copy of ``victoriametrics_tpu/ingest/otlp.py``, whole.
"""

from __future__ import annotations

import struct

from .parsers import Row
from .protowire import as_double, as_signed, iter_fields


def _fmt_num(v: float) -> str:
    """Prometheus-style number formatting for le/quantile labels: 1.0 -> "1"."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _parse_any_value(data: bytes) -> str:
    for f, wt, v in iter_fields(data):
        if f == 1 and wt == 2:
            return v.decode("utf-8", "replace")
        if f == 2 and wt == 0:
            return "true" if v else "false"
        if f == 3 and wt == 0:
            return str(as_signed(v))
        if f == 4 and wt == 1:
            return repr(as_double(v))
    return ""


def _parse_attributes(fields, attr_field: int) -> list:
    out = []
    for f, wt, v in fields:
        if f == attr_field and wt == 2:
            key = val = ""
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 2:
                    key = v2.decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    val = _parse_any_value(v2)
            if key and val:
                out.append((key, val))
    return out


def _packed_fixed64(data: bytes) -> list[int]:
    return [struct.unpack_from("<Q", data, i)[0]
            for i in range(0, len(data), 8)]


def _packed_double(data: bytes) -> list[float]:
    return [struct.unpack_from("<d", data, i)[0]
            for i in range(0, len(data), 8)]


def parse_otlp(body: bytes):
    """Yields Row objects from an ExportMetricsServiceRequest."""
    for f, wt, rm in iter_fields(body):
        if f != 1 or wt != 2:
            continue
        resource_labels: list = []
        scope_metrics = []
        for f2, w2, v2 in iter_fields(rm):
            if f2 == 1 and w2 == 2:  # Resource
                resource_labels = _parse_attributes(iter_fields(v2), 1)
            elif f2 == 2 and w2 == 2:  # ScopeMetrics
                scope_metrics.append(v2)
        for sm in scope_metrics:
            for f3, w3, metric in iter_fields(sm):
                if f3 == 2 and w3 == 2:
                    yield from _parse_metric(metric, resource_labels)


def _parse_metric(data: bytes, resource_labels: list):
    name = ""
    bodies = []
    for f, wt, v in iter_fields(data):
        if f == 1 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif f in (5, 7, 9, 11) and wt == 2:
            bodies.append((f, v))
    for kind, body in bodies:
        for f, wt, dp in iter_fields(body):
            if f != 1 or wt != 2:
                continue
            if kind in (5, 7):   # Gauge / Sum
                yield from _number_point(name, dp, resource_labels)
            elif kind == 9:      # Histogram
                yield from _histogram_point(name, dp, resource_labels)
            elif kind == 11:     # Summary
                yield from _summary_point(name, dp, resource_labels)


_FLAG_NO_RECORDED_VALUE = 1


def _dp_common(dp: bytes, attr_field: int, flags_field: int = 8):
    ts_ms = 0
    stale = False
    fields = list(iter_fields(dp))
    for f, wt, v in fields:
        if f == 3 and wt == 1:
            ts_ms = v // 1_000_000
        elif f == flags_field and wt == 0 and (v & _FLAG_NO_RECORDED_VALUE):
            stale = True
    attrs = _parse_attributes(fields, attr_field)
    return ts_ms, attrs, fields, stale


def _number_point(name: str, dp: bytes, resource_labels: list):
    ts_ms, attrs, fields, stale = _dp_common(dp, 7)
    value = None
    for f, wt, v in fields:
        if f == 4 and wt == 1:
            value = as_double(v)
        elif f == 6 and wt == 1:
            value = float(struct.unpack("<q", struct.pack("<Q", v))[0])
    if stale:
        from ..ops.decimal import STALE_NAN
        value = STALE_NAN
    if value is None:
        return
    yield Row([("__name__", name)] + resource_labels + attrs, ts_ms, value)


def _histogram_point(name: str, dp: bytes, resource_labels: list):
    ts_ms, attrs, fields, stale = _dp_common(dp, 9, flags_field=10)
    if stale:
        return
    count = 0
    total = None
    bucket_counts: list[int] = []
    bounds: list[float] = []
    for f, wt, v in fields:
        if f == 4 and wt == 1:
            count = v
        elif f == 5 and wt == 1:
            total = as_double(v)
        elif f == 6 and wt == 2:
            bucket_counts = _packed_fixed64(v)
        elif f == 7 and wt == 2:
            bounds = _packed_double(v)
    cum = 0
    for i, bc in enumerate(bucket_counts):
        cum += bc
        le = _fmt_num(bounds[i]) if i < len(bounds) else "+Inf"
        labels = [("__name__", f"{name}_bucket")] + resource_labels + \
            attrs + [("le", le)]
        yield Row(labels, ts_ms, float(cum))
    if total is not None:
        yield Row([("__name__", f"{name}_sum")] + resource_labels + attrs,
                  ts_ms, total)
    yield Row([("__name__", f"{name}_count")] + resource_labels + attrs,
              ts_ms, float(count))


def _summary_point(name: str, dp: bytes, resource_labels: list):
    ts_ms, attrs, fields, stale = _dp_common(dp, 7)
    if stale:
        return
    count = 0
    total = 0.0
    for f, wt, v in fields:
        if f == 4 and wt == 1:
            count = v
        elif f == 5 and wt == 1:
            total = as_double(v)
        elif f == 6 and wt == 2:
            q = val = None
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 1:
                    q = as_double(v2)
                elif f2 == 2 and w2 == 1:
                    val = as_double(v2)
            if q is not None and val is not None:
                yield Row([("__name__", name)] + resource_labels + attrs +
                          [("quantile", _fmt_num(q))], ts_ms, val)
    yield Row([("__name__", f"{name}_sum")] + resource_labels + attrs,
              ts_ms, total)
    yield Row([("__name__", f"{name}_count")] + resource_labels + attrs,
              ts_ms, float(count))
