"""Transform functions (reference app/vmselect/promql/transform.go:23-140,
113 functions; the heavily-used subset here, expanding over rounds).

A transform takes already-evaluated args (lists of Timeseries, floats, or
strings) plus the EvalConfig, and returns a list of Timeseries.

The port's copy of ``victoriametrics_tpu/query/transform_funcs.py``, whole.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..storage.metric_name import MetricName
from .types import EvalConfig, Timeseries, const_series, new_series

nan = np.nan


# -- helpers -----------------------------------------------------------------

def _map_values(series: list[Timeseries], fn, keep_name=False) -> list[Timeseries]:
    out = []
    for ts in series:
        with np.errstate(all="ignore"):
            vals = np.asarray(fn(ts.values), dtype=np.float64)
        mn = MetricName(ts.metric_name.metric_group if keep_name else b"",
                        list(ts.metric_name.labels))
        out.append(Timeseries(mn, vals))
    return out


def _elementwise(fn):
    def tf(ec, args):
        return _map_values(args[0], fn)
    return tf


def _scalar_arg(args, i, default=None) -> float:
    a = args[i] if i < len(args) else default
    if isinstance(a, list):
        if len(a) != 1:
            raise ValueError("expected scalar arg")
        return float(a[0].values[0])
    return float(a)


def _string_arg(args, i) -> str:
    if not isinstance(args[i], str):
        raise ValueError("expected string arg")
    return args[i]


# -- math --------------------------------------------------------------------

MATH = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
    "ln": np.log, "log2": np.log2, "log10": np.log10, "sqrt": np.sqrt,
    "sgn": np.sign, "acos": np.arccos, "acosh": np.arccosh,
    "asin": np.arcsin, "asinh": np.arcsinh, "atan": np.arctan,
    "atanh": np.arctanh, "cos": np.cos, "cosh": np.cosh, "sin": np.sin,
    "sinh": np.sinh, "tan": np.tan, "tanh": np.tanh,
    "deg": np.degrees, "rad": np.radians,
}


def _arg_values(args, i, default=None):
    """Per-point parameter: a 1-series arg yields its value ARRAY (so
    clamp_min(q, time()) etc vary per step); plain floats broadcast."""
    a = args[i] if i < len(args) else default
    if isinstance(a, list):
        if len(a) != 1:
            raise ValueError("expected scalar arg")
        return a[0].values
    return float(a)


def _vm_round(v: np.ndarray, nearest) -> np.ndarray:
    """transform.go:2337 transformRound, replicated float-for-float: add a
    signed half, subtract fmod, then TRUNCATE at the nearest's decimal
    precision. The truncation step is observable (e.g. round(0.28948, 0.01)
    = 0.28 because 0.29*100 = 28.999... truncates to 28), so np.round is not
    equivalent."""
    n = np.asarray(nearest, dtype=np.float64)
    # decimal.FromFloat(n) exponent -> p10 (per distinct nearest value)
    def p10_of(x):
        from ..ops.decimal import float_to_decimal
        if not np.isfinite(x) or x == 0:
            return 1.0
        _, e = float_to_decimal(np.array([x]))
        return 10.0 ** (-e)
    if n.ndim == 0:
        p10 = p10_of(float(n))
    else:
        p10 = np.array([p10_of(float(x)) for x in n])
    with np.errstate(all="ignore"):
        w = v + 0.5 * np.copysign(n, v)
        w = w - np.fmod(w, n)
        w = np.trunc(w * p10)
        out = w / p10
    return np.where(np.isnan(v), nan, out)


def tf_round(ec, args):
    nearest = _arg_values(args, 1, 1.0)
    return _map_values(args[0], lambda v: _vm_round(v, nearest),
                       keep_name=True)


def tf_clamp(ec, args):
    lo, hi = _arg_values(args, 1), _arg_values(args, 2)
    return _map_values(args[0], lambda v: np.clip(v, lo, hi), keep_name=True)


def tf_clamp_min(ec, args):
    lo = _arg_values(args, 1)
    return _map_values(args[0], lambda v: np.maximum(v, lo), keep_name=True)


def tf_clamp_max(ec, args):
    hi = _arg_values(args, 1)
    return _map_values(args[0], lambda v: np.minimum(v, hi), keep_name=True)


# -- time --------------------------------------------------------------------

def tf_time(ec, args):
    return [new_series(ec.timestamps() / 1e3)]


def tf_now(ec, args):
    from ..utils import fasttime
    return [const_series(ec, fasttime.unix_seconds())]


def tf_step(ec, args):
    return [const_series(ec, ec.step / 1e3)]


def tf_start(ec, args):
    return [const_series(ec, ec.start / 1e3)]


def tf_end(ec, args):
    return [const_series(ec, ec.end / 1e3)]


def _dt_transform(extract):
    def tf(ec, args):
        series = args[0] if args else [new_series(ec.timestamps() / 1e3)]
        import datetime

        def fn(v):
            out = np.full(v.size, nan)
            ok = ~np.isnan(v)
            for i in np.flatnonzero(ok):
                dt = datetime.datetime.fromtimestamp(
                    v[i], tz=datetime.timezone.utc)
                out[i] = extract(dt)
            return out
        return _map_values(series, fn)
    return tf


DT_FUNCS = {
    "minute": _dt_transform(lambda d: d.minute),
    "hour": _dt_transform(lambda d: d.hour),
    "day_of_month": _dt_transform(lambda d: d.day),
    "day_of_week": _dt_transform(lambda d: d.isoweekday() % 7),
    "day_of_year": _dt_transform(lambda d: d.timetuple().tm_yday),
    "days_in_month": _dt_transform(
        lambda d: __import__("calendar").monthrange(d.year, d.month)[1]),
    "month": _dt_transform(lambda d: d.month),
    "year": _dt_transform(lambda d: d.year),
}


# -- series shaping ------------------------------------------------------------

def tf_scalar(ec, args):
    if args and isinstance(args[0], str):
        # scalar("-12.34"): numeric strings become scalars (reference
        # transformScalar string fast path)
        try:
            return [const_series(ec, float(args[0]))]
        except ValueError:
            return [const_series(ec, nan)]
    series = args[0]
    if len(series) != 1:
        return [const_series(ec, nan)]
    return [new_series(series[0].values.copy())]


def tf_vector(ec, args):
    if isinstance(args[0], (int, float)):
        return [const_series(ec, float(args[0]))]
    return list(args[0])


def _is_scalar_series(series) -> bool:
    return (len(series) == 1 and not series[0].metric_name.metric_group
            and not series[0].metric_name.labels)


def tf_union(ec, args):
    series_args = [a for a in args if isinstance(a, list)]
    if series_args and all(_is_scalar_series(a) for a in series_args):
        # (v1, ..., vN) of scalars keeps every element — needed for
        # `q == (v1,...,vN)` lists (transform.go:1731)
        return [a[0] for a in series_args]
    seen = set()
    out = []
    for series in series_args:
        for ts in series:
            key = ts.metric_name.marshal()
            if key not in seen:
                seen.add(key)
                out.append(ts)
    return out


def tf_sort(ec, args, desc=False, by_last=False):
    import functools
    series = list(args[0])

    def cmp(x, y):
        a, b = x.values, y.values
        n = a.size - 1
        while n >= 0:
            if not math.isnan(a[n]):
                if math.isnan(b[n]):
                    return 1   # a after b ("not less")
                if a[n] != b[n]:
                    break
            elif not math.isnan(b[n]):
                return -1
            n -= 1
        if n < 0:
            return 0
        if desc:
            return -1 if b[n] < a[n] else 1
        return -1 if a[n] < b[n] else 1
    series.sort(key=functools.cmp_to_key(cmp))
    return series


_NAT_CHUNK = re.compile(r"[0-9]+|[^0-9]+")


def _natural_key(v: bytes):
    """Natural-order sort key matching lib/stringsutil LessNatural: decimal
    digit runs compare numerically and sort before non-digit chunks."""
    out = []
    for m in _NAT_CHUNK.finditer(v.decode("utf-8", "surrogateescape")):
        c = m.group(0)
        if c[0] in "0123456789":
            out.append((0, int(c), ""))
        else:
            out.append((1, 0, c))
    return out


def tf_sort_by_label(ec, args, desc=False, numeric=False):
    series = list(args[0])
    labels = [a for a in args[1:] if isinstance(a, str)]

    def key(ts):
        out = []
        for lab in labels:
            v = ts.metric_name.get_label(lab.encode()) or b""
            out.append(_natural_key(v) if numeric else v)
        return out
    series.sort(key=key, reverse=desc)
    return series


def tf_limit_offset(ec, args):
    limit = int(_scalar_arg(args, 0))
    offset = int(_scalar_arg(args, 1))
    # transform.go:2290: empty (all-NaN) series are dropped BEFORE the
    # offset is applied
    rows = [ts for ts in args[2] if not np.isnan(ts.values).all()]
    return rows[offset:offset + limit]


def tf_absent(ec, args):
    series = args[0]
    if not series:
        return [const_series(ec, 1.0)]
    m = np.vstack([ts.values for ts in series])
    absent = np.isnan(m).all(axis=0)
    return [new_series(np.where(absent, 1.0, nan))]


def tf_drop_common_labels(ec, args):
    series = [t.copy_shallow_labels() for ts in args for t in ts]
    if not series:
        return series
    common = dict(series[0].metric_name.labels)
    common[b"__name__"] = series[0].metric_name.metric_group
    for ts in series[1:]:
        d = dict(ts.metric_name.labels)
        d[b"__name__"] = ts.metric_name.metric_group
        for k in list(common):
            if d.get(k) != common[k]:
                del common[k]
    for ts in series:
        if b"__name__" in common:
            ts.metric_name.metric_group = b""
        ts.metric_name.labels = [
            (k, v) for k, v in ts.metric_name.labels if k not in common]
        ts.raw = None  # in-place name edit: memoized marshal is stale
    return series


# -- running / range over the output grid -------------------------------------

def _running(fn_acc):
    def tf(ec, args):
        out = []
        for ts in args[0]:
            v = ts.values
            ok = ~np.isnan(v)
            acc = fn_acc(np.where(ok, v, 0), ok)
            acc[~ok.cumsum().astype(bool)] = nan
            out.append(Timeseries(MetricName(b"", list(ts.metric_name.labels)),
                                  acc))
        return out
    return tf


def _racc_sum(v, ok):
    return np.cumsum(v)


def _racc_avg(v, ok):
    with np.errstate(all="ignore"):
        return np.cumsum(v) / np.maximum(np.cumsum(ok), 1)


def _racc_min(v, ok):
    x = np.where(ok, v, np.inf)
    return np.minimum.accumulate(x)


def _racc_max(v, ok):
    x = np.where(ok, v, -np.inf)
    return np.maximum.accumulate(x)


def _range_apply(stat):
    def tf(ec, args):
        out = []
        for ts in args[0]:
            with np.errstate(all="ignore"):
                s = stat(ts.values)
            out.append(Timeseries(MetricName(b"", list(ts.metric_name.labels)),
                                  np.full(ts.values.size, s)))
        return out
    return tf


def tf_range_quantile(ec, args):
    phi = _scalar_arg(args, 0)
    out = []
    for ts in args[1]:
        with np.errstate(all="ignore"):
            s = np.nanquantile(ts.values, min(max(phi, 0), 1)) \
                if not np.isnan(ts.values).all() else nan
        out.append(Timeseries(MetricName(b"", list(ts.metric_name.labels)),
                              np.full(ts.values.size, s)))
    return out


def tf_range_normalize(ec, args):
    """transform.go:1347 transformRangeNormalize: (v-min)/(max-min) per
    series; all-NaN series (infinite spread) dropped; KEEPS metric names
    (it's in transformFuncsKeepMetricName); a zero spread yields 0/0=NaN."""
    out = []
    for series in args:
        for ts in series:
            with np.errstate(all="ignore"):
                ok = ~np.isnan(ts.values)
                if not ok.any():
                    continue
                lo, hi = np.min(ts.values[ok]), np.max(ts.values[ok])
                v = (ts.values - lo) / (hi - lo)
            out.append(Timeseries(MetricName(ts.metric_name.metric_group,
                                             list(ts.metric_name.labels)), v))
    return out


# -- gap filling ----------------------------------------------------------------

def tf_interpolate(ec, args):
    out = []
    for ts in args[0]:
        v = ts.values.copy()
        ok = ~np.isnan(v)
        if ok.any() and not ok.all():
            idx = np.arange(v.size)
            filled = np.interp(idx, idx[ok], v[ok])
            # only interior gaps: leading/trailing NaNs stay NaN
            # (transform.go:1268 skips leading/trailing)
            first, last = idx[ok][0], idx[ok][-1]
            inside = (idx >= first) & (idx <= last)
            v = np.where(inside, filled, nan)
        out.append(Timeseries(ts.metric_name, v))
    return out


def tf_keep_last_value(ec, args):
    out = []
    for ts in args[0]:
        v = ts.values.copy()
        ok = ~np.isnan(v)
        if ok.any():
            last = np.maximum.accumulate(np.where(ok, np.arange(v.size), -1))
            filled = np.where(last >= 0, v[np.maximum(last, 0)], nan)
            v = filled
        out.append(Timeseries(ts.metric_name, v))
    return out


def tf_keep_next_value(ec, args):
    out = []
    for ts in args[0]:
        v = ts.values[::-1].copy()
        ok = ~np.isnan(v)
        if ok.any():
            last = np.maximum.accumulate(np.where(ok, np.arange(v.size), -1))
            v = np.where(last >= 0, v[np.maximum(last, 0)], nan)
        out.append(Timeseries(ts.metric_name, v[::-1]))
    return out


def tf_remove_resets(ec, args):
    from ..ops.rollup_np import remove_counter_resets

    def fn(v):
        ok = ~np.isnan(v)
        if not ok.any():
            return v
        filled = v[ok]
        fixed = remove_counter_resets(filled)
        out = v.copy()
        out[ok] = fixed
        return out
    return _map_values(args[0], fn)


# -- label manipulation ---------------------------------------------------------

def _get_label(mn: MetricName, key: bytes):
    if key == b"__name__":
        return mn.metric_group or None
    return mn.get_label(key)


def _set_label(mn: MetricName, key: bytes, value: bytes):
    if key == b"__name__":
        mn.metric_group = value
        return
    mn.labels = [(k, v) for k, v in mn.labels if k != key]
    if value:
        mn.labels.append((key, value))
        mn.sort_labels()


def tf_label_set(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    pairs = args[1:]
    for i in range(0, len(pairs) - 1, 2):
        k, v = _string_arg(pairs, i).encode(), _string_arg(pairs, i + 1).encode()
        for ts in series:
            _set_label(ts.metric_name, k, v)
    return series


def tf_label_del(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    keys = [a.encode() for a in args[1:] if isinstance(a, str)]
    for ts in series:
        for k in keys:
            _set_label(ts.metric_name, k, b"")
    return series


def tf_label_keep(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    keep = {a.encode() for a in args[1:] if isinstance(a, str)}
    for ts in series:
        if b"__name__" not in keep:
            ts.metric_name.metric_group = b""
        ts.metric_name.labels = [
            (k, v) for k, v in ts.metric_name.labels if k in keep]
    return series


def tf_label_copy(ec, args, move=False):
    series = [t.copy_shallow_labels() for t in args[0]]
    pairs = args[1:]
    for i in range(0, len(pairs) - 1, 2):
        src = _string_arg(pairs, i).encode()
        dst = _string_arg(pairs, i + 1).encode()
        for ts in series:
            v = _get_label(ts.metric_name, src)
            if v:
                _set_label(ts.metric_name, dst, v)
                if move and src != dst:
                    _set_label(ts.metric_name, src, b"")
    return series


def tf_label_replace(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    dst, repl, src, regex = (_string_arg(args, 1), _string_arg(args, 2),
                             _string_arg(args, 3), _string_arg(args, 4))
    try:
        rx = re.compile("(?:" + regex + ")\\Z")
    except re.error as e:
        raise ValueError(f"label_replace: bad regex: {e}")
    for ts in series:
        v = (_get_label(ts.metric_name, src.encode()) or b"").decode(
            "utf-8", "replace")
        m = rx.match(v)
        if m:
            # $1 / ${1} expand to the group, or "" when the group does not
            # exist (Go regexp.Expand semantics — no error)
            def _grp(gm):
                gi = gm.group(1) or gm.group(2)
                try:
                    return m.group(int(gi)) or ""
                except (IndexError, ValueError):
                    return ""
            new = re.sub(r"\$(?:\{(\w+)\}|(\d+))", _grp, repl)
            _set_label(ts.metric_name, dst.encode(), new.encode())
    return series


def tf_label_join(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    dst = _string_arg(args, 1).encode()
    sep = _string_arg(args, 2).encode()
    srcs = [a.encode() for a in args[3:] if isinstance(a, str)]
    for ts in series:
        parts = [(_get_label(ts.metric_name, s) or b"") for s in srcs]
        _set_label(ts.metric_name, dst, sep.join(parts))
    return series


def tf_label_value(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    key = _string_arg(args, 1).encode()
    out = []
    for ts in series:
        v = _get_label(ts.metric_name, key)
        try:
            x = float(v) if v is not None else nan
        except ValueError:
            x = nan
        out.append(Timeseries(ts.metric_name,
                              np.where(np.isnan(ts.values), nan, x)))
    return out


def tf_label_transform(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    key = _string_arg(args, 1).encode()
    regex = _string_arg(args, 2)
    repl = _string_arg(args, 3)
    rx = re.compile(regex)
    for ts in series:
        v = (ts.metric_name.get_label(key) or b"").decode("utf-8", "replace")
        _set_label(ts.metric_name, key,
                   rx.sub(repl.replace("$", "\\"), v).encode())
    return series


def tf_label_map(ec, args):
    series = [t.copy_shallow_labels() for t in args[0]]
    key = _string_arg(args, 1).encode()
    mapping = {}
    rest = args[2:]
    for i in range(0, len(rest) - 1, 2):
        mapping[_string_arg(rest, i).encode()] = _string_arg(rest, i + 1).encode()
    for ts in series:
        v = ts.metric_name.get_label(key) or b""
        if v in mapping:
            _set_label(ts.metric_name, key, mapping[v])
    return series


def _label_case(upper: bool):
    def tf(ec, args):
        series = [t.copy_shallow_labels() for t in args[0]]
        keys = [a.encode() for a in args[1:] if isinstance(a, str)]
        for ts in series:
            for k in keys:
                v = ts.metric_name.get_label(k)
                if v:
                    s = v.decode("utf-8", "replace")
                    _set_label(ts.metric_name, k,
                               (s.upper() if upper else s.lower()).encode())
        return series
    return tf


def tf_label_match(ec, args, negate=False):
    series = args[0]
    key = _string_arg(args, 1).encode()
    rx = re.compile("(?:" + _string_arg(args, 2) + ")\\Z")
    out = []
    for ts in series:
        v = (ts.metric_name.get_label(key) or b"").decode("utf-8", "replace")
        if bool(rx.match(v)) != negate:
            out.append(ts)
    return out


def tf_labels_equal(ec, args):
    series = args[0]
    keys = [a.encode() for a in args[1:] if isinstance(a, str)]
    out = []
    for ts in series:
        vals = {ts.metric_name.get_label(k) for k in keys}
        if len(vals) == 1:
            out.append(ts)
    return out


# -- histogram_quantile --------------------------------------------------------

def _group_buckets(series: list[Timeseries]):
    """Group bucket series by labels-minus-le; returns
    [(labels_key, MetricName_without_le, [(le, values)])]."""
    groups: dict[bytes, tuple[MetricName, list]] = {}
    for ts in series:
        le = ts.metric_name.get_label(b"le")
        if le is None:
            continue
        try:
            le_f = float(le)
        except ValueError:
            continue
        mn = MetricName(b"", [(k, v) for k, v in ts.metric_name.labels
                              if k != b"le"])
        key = mn.marshal()
        if key not in groups:
            groups[key] = (mn, [])
        groups[key][1].append((le_f, ts.values))
    return groups


def _merge_same_le(buckets):
    """transform.go:1151 mergeSameLE: buckets with identical numeric le are
    SUMMED (le="5" and le="5.0" are the same bucket from different scrapes)."""
    out = []
    for le, v in buckets:
        if out and out[-1][0] == le:
            out[-1] = (le, out[-1][1] + v)
        else:
            out.append((le, v))
    return out


def tf_histogram_quantile(ec, args):
    phis = _arg_values(args, 0)
    series = _vmrange_to_le(list(args[1]))
    bounds_label = args[2].encode() if len(args) > 2 and \
        isinstance(args[2], str) else None
    out = []
    for key, (mn, buckets) in _group_buckets(series).items():
        buckets.sort(key=lambda b: b[0])
        buckets = _merge_same_le(buckets)
        les = np.array([b[0] for b in buckets])
        m = np.vstack([b[1] for b in buckets])  # [B, T] cumulative counts
        with np.errstate(all="ignore"):
            vals = _hist_quantile_cols(phis, les, m)
        if bounds_label:
            # lower/upper bucket-edge bound series (prometheus issue 5706)
            lo = np.full(vals.shape, nan)
            hi = np.full(vals.shape, nan)
            fin = np.isfinite(vals)
            if fin.any():
                for j in np.flatnonzero(fin):
                    i = int(np.searchsorted(les, vals[j], side="left"))
                    lo[j] = les[i - 1] if i > 0 else 0.0
                    hi[j] = les[min(i, les.size - 1)]
            for tag, bvals in ((b"lower", lo), (b"upper", hi)):
                b = MetricName(mn.metric_group,
                               [(k, v) for k, v in mn.labels
                                if k != bounds_label] +
                               [(bounds_label, tag)])
                b.sort_labels()
                out.append(Timeseries(b, bvals))
        out.append(Timeseries(mn, vals))
    return out


def _hist_quantile_cols(phi, les: np.ndarray, m: np.ndarray) -> np.ndarray:
    T = m.shape[1]
    phi_arr = np.broadcast_to(np.asarray(phi, dtype=np.float64), (T,))
    out = np.full(T, nan)
    if not np.isfinite(les[-1]) and les.size < 2:
        return out
    for j in range(T):
        phi = float(phi_arr[j])
        counts = m[:, j]
        if np.isnan(counts).all():
            continue
        counts = np.nan_to_num(counts)
        # enforce monotonicity (float jitter)
        counts = np.maximum.accumulate(counts)
        total = counts[-1]
        if total == 0:
            continue
        if phi < 0:
            out[j] = -np.inf
            continue
        if phi > 1:
            out[j] = np.inf
            continue
        rank = phi * total
        idx = int(np.searchsorted(counts, rank, side="left"))
        idx = min(idx, les.size - 1)
        if not np.isfinite(les[idx]):
            # +Inf bucket: return the upper bound of the previous bucket
            out[j] = les[idx - 1] if idx > 0 else nan
            continue
        lo = les[idx - 1] if idx > 0 else 0.0
        c_lo = counts[idx - 1] if idx > 0 else 0.0
        c_hi = counts[idx]
        if c_hi <= c_lo:
            out[j] = les[idx]
            continue
        out[j] = lo + (les[idx] - lo) * (rank - c_lo) / (c_hi - c_lo)
    return out


def tf_histogram_avg(ec, args):
    """transform.go:812 transformHistogramAvg + :876 avgForLeTimeseries:
    vmrange buckets are converted to le= first; the +Inf bucket is SKIPPED
    entirely (it does not advance lePrev/vPrev); weights are adjacent
    cumulative diffs and a zero total weight yields NaN."""
    out = []
    series = _vmrange_to_le(list(args[0]))
    for key, (mn, buckets) in _group_buckets(series).items():
        buckets.sort(key=lambda b: b[0])
        buckets = _merge_same_le(buckets)
        fin = [(le, v) for le, v in buckets if np.isfinite(le)]
        if not fin:
            out.append(Timeseries(mn, np.full(
                buckets[0][1].size if buckets else 0, nan)))
            continue
        les = np.array([b[0] for b in fin])
        m = np.nan_to_num(np.vstack([b[1] for b in fin]))
        mids = (les + np.concatenate([[0.0], les[:-1]])) / 2
        d = np.diff(np.vstack([np.zeros(m.shape[1]), m]), axis=0)
        with np.errstate(all="ignore"):
            tot = d.sum(axis=0)
            avg = np.where(tot != 0, (d * mids[:, None]).sum(axis=0) / tot,
                           nan)
        out.append(Timeseries(mn, avg))
    return out


def tf_prometheus_buckets(ec, args):
    """vmrange buckets (histogram_over_time / histogram()) -> cumulative
    Prometheus le= buckets (transform.go:490)."""
    return _vmrange_to_le(list(args[0]))


def tf_buckets_limit(ec, args):
    """Reduce per-group bucket count by merging the buckets with the
    fewest hits, always keeping the first and last (transform.go:386)."""
    limit = int(_scalar_arg(args, 0))
    if limit <= 0:
        return []
    if limit < 3:
        limit = 3  # preserve first/last for min/max accuracy
    tss = _vmrange_to_le(list(args[1]))
    groups: dict[bytes, list] = {}
    for ts in tss:
        le_b = ts.metric_name.get_label(b"le")
        if not le_b:
            continue
        try:
            le = float(le_b)
        except ValueError:
            continue
        mn = MetricName(ts.metric_name.metric_group,
                        [(k, v) for k, v in ts.metric_name.labels
                         if k != b"le"])
        groups.setdefault(mn.marshal(), []).append([le, 0.0, ts])
    out = []
    for grp in groups.values():
        if len(grp) <= limit:
            out.extend(x[2] for x in grp)
            continue
        grp.sort(key=lambda x: x[0])
        prev = np.zeros(grp[0][2].values.size)
        for x in grp:
            vals = np.nan_to_num(x[2].values)
            x[1] = float((vals - prev).sum())
            prev = vals
        while len(grp) > limit:
            best = 1
            best_hits = grp[1][1] + grp[2][1]
            for i in range(1, len(grp) - 2):
                h = grp[i][1] + grp[i + 1][1]
                if h < best_hits:
                    best, best_hits = i, h
            grp[best + 1][1] += grp[best][1]
            del grp[best]
        out.extend(x[2] for x in grp)
    return out


# -- misc ----------------------------------------------------------------------

def tf_pi(ec, args):
    return [const_series(ec, math.pi)]


def tf_e(ec, args):
    return [const_series(ec, math.e)]


def _go_rand_series(ec, args, draw_attr):
    """Seeded rand draws replicate Go's math/rand stream bit-for-bit
    (transform.go:2653 newTransformRand + gorand.py); unseeded calls are
    time-seeded like the reference and just use numpy."""
    if args:
        from .gorand import GoRand
        r = GoRand(int(_scalar_arg(args, 0, 0)))
        draw = getattr(r, draw_attr)
        return [new_series(np.array([draw() for _ in range(ec.n_points)]))]
    rng = np.random.default_rng()
    fallback = {"float64": rng.random,
                "norm_float64": rng.standard_normal,
                "exp_float64": lambda n: rng.exponential(size=n)}
    return [new_series(np.asarray(fallback[draw_attr](ec.n_points),
                                  dtype=np.float64))]


def tf_rand(ec, args):
    return _go_rand_series(ec, args, "float64")


def tf_rand_normal(ec, args):
    return _go_rand_series(ec, args, "norm_float64")


def tf_rand_exponential(ec, args):
    return _go_rand_series(ec, args, "exp_float64")


def tf_smooth_exponential(ec, args):
    sf = min(max(_scalar_arg(args, 1), 0.0), 1.0)
    out = []
    for ts in args[0]:
        v = ts.values
        acc = v.copy()
        prev = nan
        for i in range(v.size):
            if np.isnan(v[i]):
                acc[i] = prev
            elif np.isnan(prev):
                acc[i] = v[i]
                prev = v[i]
            else:
                prev = sf * v[i] + (1 - sf) * prev
                acc[i] = prev
        out.append(Timeseries(MetricName(b"", list(ts.metric_name.labels)), acc))
    return out


def tf_bitmap_and(ec, args):
    mask = int(_scalar_arg(args, 1))
    return _map_values(args[0], lambda v: np.where(
        np.isnan(v), nan, (v.astype(np.int64) & mask).astype(np.float64)))


def tf_bitmap_or(ec, args):
    mask = int(_scalar_arg(args, 1))
    return _map_values(args[0], lambda v: np.where(
        np.isnan(v), nan, (v.astype(np.int64) | mask).astype(np.float64)))


def tf_bitmap_xor(ec, args):
    mask = int(_scalar_arg(args, 1))
    return _map_values(args[0], lambda v: np.where(
        np.isnan(v), nan, (v.astype(np.int64) ^ mask).astype(np.float64)))


TRANSFORM_FUNCS: dict = {}
TRANSFORM_FUNCS.update({name: _elementwise(fn) for name, fn in MATH.items()})
TRANSFORM_FUNCS.update(DT_FUNCS)
TRANSFORM_FUNCS.update({
    "round": tf_round, "clamp": tf_clamp, "clamp_min": tf_clamp_min,
    "clamp_max": tf_clamp_max,
    "time": tf_time, "now": tf_now, "step": tf_step, "start": tf_start,
    "end": tf_end, "pi": tf_pi, "e": tf_e,
    "rand": tf_rand, "rand_normal": tf_rand_normal,
    "rand_exponential": tf_rand_exponential,
    "scalar": tf_scalar, "vector": tf_vector, "union": tf_union,
    "sort": lambda ec, a: tf_sort(ec, a),
    "sort_desc": lambda ec, a: tf_sort(ec, a, desc=True),
    "sort_by_label": lambda ec, a: tf_sort_by_label(ec, a),
    "sort_by_label_desc": lambda ec, a: tf_sort_by_label(ec, a, desc=True),
    "sort_by_label_numeric": lambda ec, a: tf_sort_by_label(ec, a, numeric=True),
    "sort_by_label_numeric_desc":
        lambda ec, a: tf_sort_by_label(ec, a, desc=True, numeric=True),
    "limit_offset": tf_limit_offset, "absent": tf_absent,
    "drop_common_labels": tf_drop_common_labels,
    "running_sum": _running(_racc_sum), "running_avg": _running(_racc_avg),
    "running_min": _running(_racc_min), "running_max": _running(_racc_max),
    "range_sum": _range_apply(np.nansum), "range_avg": _range_apply(np.nanmean),
    "range_min": _range_apply(np.nanmin), "range_max": _range_apply(np.nanmax),
    "range_first": _range_apply(
        lambda v: v[np.flatnonzero(~np.isnan(v))[0]]
        if (~np.isnan(v)).any() else nan),
    "range_last": _range_apply(
        lambda v: v[np.flatnonzero(~np.isnan(v))[-1]]
        if (~np.isnan(v)).any() else nan),
    "range_stddev": _range_apply(np.nanstd),
    "range_stdvar": _range_apply(np.nanvar),
    "range_median": _range_apply(np.nanmedian),
    "range_quantile": tf_range_quantile,
    "range_normalize": tf_range_normalize,
    "interpolate": tf_interpolate,
    "keep_last_value": tf_keep_last_value,
    "keep_next_value": tf_keep_next_value,
    "remove_resets": tf_remove_resets,
    "label_set": tf_label_set, "label_del": tf_label_del,
    "label_keep": tf_label_keep,
    "label_copy": lambda ec, a: tf_label_copy(ec, a),
    "label_move": lambda ec, a: tf_label_copy(ec, a, move=True),
    "label_replace": tf_label_replace, "label_join": tf_label_join,
    "label_value": tf_label_value, "label_transform": tf_label_transform,
    "label_map": tf_label_map,
    "label_lowercase": _label_case(False),
    "label_uppercase": _label_case(True),
    "label_match": lambda ec, a: tf_label_match(ec, a),
    "label_mismatch": lambda ec, a: tf_label_match(ec, a, negate=True),
    "labels_equal": tf_labels_equal,
    "histogram_quantile": tf_histogram_quantile,
    "histogram_avg": tf_histogram_avg,
    "prometheus_buckets": tf_prometheus_buckets,
    "buckets_limit": tf_buckets_limit,
    "smooth_exponential": tf_smooth_exponential,
    "bitmap_and": tf_bitmap_and, "bitmap_or": tf_bitmap_or,
    "bitmap_xor": tf_bitmap_xor,
    "sgn": _elementwise(np.sign),
})

# args that must NOT be auto-evaluated to series (string positions are
# detected at eval time via StringExpr)


# -- vmrange histograms + round-2 parity tail ---------------------------------

def _vmrange_to_le(series: list[Timeseries]) -> list[Timeseries]:
    """Convert VM-native vmrange buckets into cumulative Prometheus le=
    buckets (transform.go:494 vmrangeBucketsToLE); le-labeled series pass
    through unchanged."""
    out = []
    groups: dict[bytes, tuple[MetricName, list]] = {}
    for ts in series:
        vr = ts.metric_name.get_label(b"vmrange")
        if not vr:
            if ts.metric_name.get_label(b"le"):
                out.append(ts)
            continue
        sep = vr.find(b"...")
        if sep < 0:
            continue
        try:
            start = float(vr[:sep])
            end = float(vr[sep + 3:])
        except ValueError:
            continue
        mn = MetricName(ts.metric_name.metric_group,
                        [(k, v) for k, v in ts.metric_name.labels
                         if k not in (b"le", b"vmrange")])
        key = mn.marshal()
        if key not in groups:
            groups[key] = (mn, [])
        groups[key][1].append((start, end, vr[:sep], vr[sep + 3:], ts))
    for key, (mn, xss) in groups.items():
        xss.sort(key=lambda x: x[1])
        T = xss[0][4].values.size

        def bucket(le_bytes, vals):
            b = MetricName(mn.metric_group,
                           list(mn.labels) + [(b"le", le_bytes)])
            b.sort_labels()
            return Timeseries(b, vals)

        new: list[tuple[float, bytes, np.ndarray]] = []
        seen_le: dict[bytes, np.ndarray] = {}
        prev_end = 0.0  # reference xsPrev zero-value: start==0 fills nothing
        prev_end_s = None
        nonzero = [x for x in xss
                   if np.nansum(np.nan_to_num(x[4].values)) > 0]
        for start, end, start_s, end_s, ts in nonzero:
            if start != prev_end and start_s not in seen_le:
                z = np.zeros(T)
                seen_le[start_s] = z
                new.append((start, start_s, z))
            vals = ts.values.copy()
            prev = seen_le.get(end_s)
            if prev is not None:
                # duplicate end: merge when non-overlapping, else DROP the
                # later bucket (transform.go:598 discards the merge result;
                # an overlapping duplicate like 0...0.25 over 0...0.2 +
                # 0.2...0.25 must not be double-counted)
                from .binary_op import merge_values_non_overlapping
                merge_values_non_overlapping(prev, vals)
            else:
                seen_le[end_s] = vals
                new.append((end, end_s, vals))
            prev_end, prev_end_s = end, end_s
        if new and prev_end_s is not None and np.isfinite(prev_end):
            new.append((np.inf, b"+Inf", np.zeros(T)))
        if not new:
            continue
        # cumulative counts across ascending le: NaN and non-positive points
        # contribute nothing (transform.go:616)
        acc = np.zeros(T)
        for le, le_s, vals in new:
            acc = acc + np.where(np.isnan(vals) | (vals <= 0), 0.0, vals)
            out.append(bucket(le_s, acc.copy()))
    return out


def _le_share(le_req: float, les: np.ndarray, counts: np.ndarray,
              j: int) -> tuple[float, float, float]:
    """(q, lower, upper) share of counts at or below le_req
    (transform.go:661)."""
    if np.isnan(le_req) or les.size == 0:
        return nan, nan, nan
    if le_req < 0:
        return 0.0, 0.0, 0.0
    if np.isinf(le_req):
        return 1.0, 1.0, 1.0
    v_prev = 0.0
    le_prev = 0.0
    v_last = counts[-1, j]
    if v_last == 0 or np.isnan(v_last):
        return nan, nan, nan
    for b in range(les.size):
        v = counts[b, j]
        le = les[b]
        if le_req >= le:
            v_prev, le_prev = v, le
            continue
        lower = v_prev / v_last
        if np.isinf(le):
            return lower, lower, 1.0
        if le_prev == le_req:
            return lower, lower, lower
        upper = v / v_last
        q = lower + (v - v_prev) / v_last * (le_req - le_prev) / (le - le_prev)
        return q, lower, upper
    return 1.0, 1.0, 1.0


def _grouped_le_matrix(series):
    """[(MetricName-without-le, les asc, counts [B, T] monotone)]"""
    out = []
    for key, (mn, buckets) in _group_buckets(_vmrange_to_le(series)).items():
        buckets.sort(key=lambda b: b[0])
        les = np.array([b[0] for b in buckets])
        m = np.nan_to_num(np.vstack([b[1] for b in buckets]))
        m = np.maximum.accumulate(m, axis=0)  # fix broken buckets
        out.append((mn, les, m))
    return out


def tf_histogram_share(ec, args):
    le_req = _arg_values(args, 0)
    bounds_label = args[2].encode() if len(args) > 2 and \
        isinstance(args[2], str) else None
    out = []
    for mn, les, m in _grouped_le_matrix(args[1]):
        T = m.shape[1]
        le_arr = np.broadcast_to(np.asarray(le_req, dtype=np.float64),
                                 (T,))
        q = np.full(T, nan)
        lo = np.full(T, nan)
        hi = np.full(T, nan)
        for j in range(T):
            q[j], lo[j], hi[j] = _le_share(float(le_arr[j]), les, m, j)
        out.append(Timeseries(mn, q))
        if bounds_label:
            for tag, vals in ((b"lower", lo), (b"upper", hi)):
                b = MetricName(mn.metric_group,
                               [(k, v) for k, v in mn.labels
                                if k != bounds_label] +
                               [(bounds_label, tag)])
                b.sort_labels()
                out.append(Timeseries(b, vals))
    return out


def tf_histogram_fraction(ec, args):
    lower, upper = _arg_values(args, 0), _arg_values(args, 1)
    if np.isscalar(lower) and np.isscalar(upper) and lower >= upper:
        raise ValueError("histogram_fraction: lower le must be < upper le")
    out = []
    for mn, les, m in _grouped_le_matrix(args[2]):
        T = m.shape[1]
        lo_arr = np.broadcast_to(np.asarray(lower, dtype=np.float64), (T,))
        up_arr = np.broadcast_to(np.asarray(upper, dtype=np.float64), (T,))
        vals = np.full(T, nan)
        for j in range(T):
            up, _, _ = _le_share(float(up_arr[j]), les, m, j)
            dn, _, _ = _le_share(float(lo_arr[j]), les, m, j)
            vals[j] = up - dn
        out.append(Timeseries(mn, vals))
    return out


def _hist_stdvar_cols(les: np.ndarray, m: np.ndarray) -> np.ndarray:
    """stdvar over le-bucket midpoints (transform.go:900)."""
    T = m.shape[1]
    out = np.full(T, nan)
    for j in range(T):
        le_prev = v_prev = 0.0
        s = s2 = wtot = 0.0
        for b in range(les.size):
            if np.isinf(les[b]):
                continue
            n = (les[b] + le_prev) / 2
            w = m[b, j] - v_prev
            s += n * w
            s2 += n * n * w
            wtot += w
            le_prev, v_prev = les[b], m[b, j]
        if wtot == 0:
            continue
        avg = s / wtot
        out[j] = max(s2 / wtot - avg * avg, 0.0)
    return out


def tf_histogram_stdvar(ec, args):
    return [Timeseries(mn, _hist_stdvar_cols(les, m))
            for mn, les, m in _grouped_le_matrix(args[0])]


def tf_histogram_stddev(ec, args):
    return [Timeseries(mn, np.sqrt(_hist_stdvar_cols(les, m)))
            for mn, les, m in _grouped_le_matrix(args[0])]


def tf_histogram_quantiles(ec, args):
    dst_label = _string_arg(args, 0).encode()
    phis = [_scalar_arg(args, i) for i in range(1, len(args) - 1)]
    series = args[-1]
    out = []
    for phi in phis:
        rows = tf_histogram_quantile(ec, [phi, list(series)])
        for ts in rows:
            mn = MetricName(ts.metric_name.metric_group,
                            [(k, v) for k, v in ts.metric_name.labels
                             if k != dst_label] +
                            [(dst_label, repr(phi).encode())])
            mn.sort_labels()
            out.append(Timeseries(mn, ts.values))
    return out


def tf_drop_empty_series(ec, args):
    return [ts for ts in args[0] if not np.isnan(ts.values).all()]


def tf_label_graphite_group(ec, args):
    group_ids = [int(_scalar_arg(args, i)) for i in range(1, len(args))]
    out = []
    for ts in args[0]:
        groups = ts.metric_name.metric_group.split(b".")
        parts = [groups[g] if 0 <= g < len(groups) else b""
                 for g in group_ids]
        mn = MetricName(b".".join(parts), list(ts.metric_name.labels))
        out.append(Timeseries(mn, ts.values))
    return out


def tf_range_zscore(ec, args):
    out = []
    with np.errstate(all="ignore"):
        for ts in args[0]:
            sd = np.nanstd(ts.values)
            out.append(Timeseries(ts.metric_name,
                                  (ts.values - np.nanmean(ts.values)) / sd))
    return out


def tf_range_trim_zscore(ec, args):
    z = abs(_scalar_arg(args, 0))
    out = []
    with np.errstate(all="ignore"):
        for ts in args[1]:
            sd = np.nanstd(ts.values)
            avg = np.nanmean(ts.values)
            vals = np.where(np.abs(ts.values - avg) / sd > z, nan, ts.values)
            out.append(Timeseries(ts.metric_name, vals))
    return out


def tf_range_trim_outliers(ec, args):
    k = _scalar_arg(args, 0)
    out = []
    with np.errstate(all="ignore"):
        for ts in args[1]:
            med = np.nanmedian(ts.values)
            mad = np.nanmedian(np.abs(ts.values - med))
            vals = np.where(np.abs(ts.values - med) > k * mad, nan,
                            ts.values)
            out.append(Timeseries(ts.metric_name, vals))
    return out


def tf_range_trim_spikes(ec, args):
    phi = _scalar_arg(args, 0) / 2.0
    out = []
    with np.errstate(all="ignore"):
        for ts in args[1]:
            ok = ts.values[~np.isnan(ts.values)]
            if ok.size == 0:
                out.append(ts)
                continue
            v_min, v_max = np.quantile(ok, [phi, 1 - phi])
            vals = np.where((ts.values > v_max) | (ts.values < v_min), nan,
                            ts.values)
            out.append(Timeseries(ts.metric_name, vals))
    return out


def tf_range_mad(ec, args):
    out = []
    with np.errstate(all="ignore"):
        for ts in args[0]:
            med = np.nanmedian(ts.values)
            mad = np.nanmedian(np.abs(ts.values - med))
            out.append(Timeseries(ts.metric_name,
                                  np.full(ts.values.size, mad)))
    return out


def tf_range_linear_regression(ec, args):
    grid = None
    out = []
    for ts in args[0]:
        if grid is None:
            grid = ec.timestamps()
        t_s = (grid - grid[0]) / 1e3
        ok = ~np.isnan(ts.values)
        if ok.sum() < 1:
            out.append(ts)
            continue
        if ok.sum() == 1:
            out.append(Timeseries(ts.metric_name,
                                  np.full(grid.size, ts.values[ok][0])))
            continue
        k, v0 = np.polyfit(t_s[ok], ts.values[ok], 1)
        out.append(Timeseries(ts.metric_name, v0 + k * t_s))
    return out


def tf_timezone_offset(ec, args):
    import zoneinfo
    import datetime as _dt
    tz_name = _string_arg(args, 0)
    try:
        tz = zoneinfo.ZoneInfo(tz_name)
    except (zoneinfo.ZoneInfoNotFoundError, ValueError) as e:
        raise ValueError(f"cannot load timezone {tz_name!r}: {e}")
    grid = ec.timestamps()
    vals = np.array([
        _dt.datetime.fromtimestamp(t / 1e3, tz).utcoffset().total_seconds()
        for t in grid])
    return [Timeseries(MetricName(b""), vals)]


TRANSFORM_FUNCS.update({
    "drop_empty_series": tf_drop_empty_series,
    "histogram_share": tf_histogram_share,
    "histogram_fraction": tf_histogram_fraction,
    "histogram_stddev": tf_histogram_stddev,
    "histogram_stdvar": tf_histogram_stdvar,
    "histogram_quantiles": tf_histogram_quantiles,
    "label_graphite_group": tf_label_graphite_group,
    "range_zscore": tf_range_zscore,
    "range_trim_zscore": tf_range_trim_zscore,
    "range_trim_outliers": tf_range_trim_outliers,
    "range_trim_spikes": tf_range_trim_spikes,
    "range_mad": tf_range_mad,
    "range_linear_regression": tf_range_linear_regression,
    "timezone_offset": tf_timezone_offset,
})
