"""Graphite render function library (reference
app/vmselect/graphite/functions.json — 151 entries — evaluated by
app/vmselect/graphite/eval.go and transform.go).

Together with the core functions defined in graphite_api.py this covers
ALL 151 reference entries (the combined dispatch table _G_FUNCS is
asserted against functions.json in tests/test_graphite_funcs.py).
Everything is vectorized numpy over the aligned render grid; functions
receive (api, args, grid, step, tenant) and return GraphiteSeries lists.
register() installs them into the dispatch table and backs the
/functions introspection endpoint.

The port's copy of ``victoriametrics_tpu/httpapi/graphite_funcs.py``, whole.
"""

from __future__ import annotations

import math
import re

import numpy as np

_REL_RE = re.compile(r"^-?(\d+)(ms|s|min|h|d|w|mon|y)$")
_UNIT_S = {"ms": 0.001, "s": 1, "min": 60, "h": 3600, "d": 86400,
           "w": 7 * 86400, "mon": 30 * 86400, "y": 365 * 86400}


def _interval_s(text, default=60):
    m = _REL_RE.match(text if text.startswith("-") else "-" + text)
    if not m:
        try:
            return float(text)
        except ValueError:
            return default
    return int(m.group(1)) * _UNIT_S[m.group(2)]


# aggregation reducers shared by aggregate/groupBy*/moving*/sortBy/filter.
# axis=0 reduces ACROSS series (one value per timestamp), axis=1 reduces
# along time (one value per series/window).
def _r_last(m, axis):
    if axis == 0:
        # last non-null series wins at each timestamp
        out = m[-1].copy()
        for i in range(m.shape[0] - 2, -1, -1):
            out = np.where(np.isnan(out), m[i], out)
        return out
    out = np.full(m.shape[0], np.nan)
    for i in range(m.shape[0]):
        ok = ~np.isnan(m[i])
        if ok.any():
            out[i] = m[i][ok][-1]
    return out


def _r_first(m, axis):
    if axis == 0:
        out = m[0].copy()
        for i in range(1, m.shape[0]):
            out = np.where(np.isnan(out), m[i], out)
        return out
    out = np.full(m.shape[0], np.nan)
    for i in range(m.shape[0]):
        ok = ~np.isnan(m[i])
        if ok.any():
            out[i] = m[i][ok][0]
    return out


_REDUCERS = {
    "sum": np.nansum, "total": np.nansum,
    "avg": np.nanmean, "average": np.nanmean,
    # avg_zero: nulls count as zero (divide by the TOTAL series count)
    "avg_zero": lambda m, axis: np.mean(np.where(np.isnan(m), 0.0, m),
                                        axis=axis),
    "min": np.nanmin, "max": np.nanmax,
    "median": np.nanmedian,
    "diff": lambda m, axis: m[0] - np.nansum(np.where(
        np.isnan(m[1:]), 0, m[1:]), axis=0) if axis == 0 else
        np.where(np.isnan(m[:, :1]), np.nan, 0).ravel() + m[:, 0] -
        np.nansum(np.where(np.isnan(m[:, 1:]), 0, m[:, 1:]), axis=1),
    "stddev": np.nanstd, "dev": np.nanstd,
    "range": lambda m, axis: np.nanmax(m, axis=axis) - np.nanmin(m, axis=axis),
    "rangeOf": lambda m, axis: np.nanmax(m, axis=axis) - np.nanmin(m, axis=axis),
    "multiply": lambda m, axis: np.nanprod(
        np.where(np.isnan(m), np.nan, m), axis=axis),
    "count": lambda m, axis: np.sum(~np.isnan(m), axis=axis).astype(float),
    "last": _r_last, "current": _r_last,
    "first": _r_first,
}


def _pow_reduce(m, axis=0):
    out = m[0].copy()
    for i in range(1, m.shape[0]):
        out = np.power(out, m[i])
    return out


_REDUCERS["pow"] = _pow_reduce


def _reduce(m, agg, axis=0):
    red = _REDUCERS.get(agg, np.nanmean)
    with np.errstate(all="ignore"):
        out = red(m, axis=axis)
    if axis == 0:
        return np.where(np.isnan(m).all(axis=0), np.nan, out)
    return out


def _series_stat(s, agg):
    """One scalar per series (for sortBy/filter/highest/lowest)."""
    v = s.values
    ok = ~np.isnan(v)
    if not ok.any():
        return np.nan
    with np.errstate(all="ignore"):
        if agg in ("last", "current"):
            return float(v[ok][-1])
        if agg == "first":
            return float(v[ok][0])
        if agg in ("max", "maximum"):
            return float(np.nanmax(v))
        if agg in ("min", "minimum"):
            return float(np.nanmin(v))
        if agg in ("sum", "total"):
            return float(np.nansum(v))
        if agg in ("stddev", "dev"):
            return float(np.nanstd(v))
        if agg == "median":
            return float(np.nanmedian(v))
        if agg == "count":
            return float(ok.sum())
        if agg == "range":
            return float(np.nanmax(v) - np.nanmin(v))
    return float(np.nanmean(v))


def register(G, H):
    """Install functions into dispatch table G using helper namespace H
    (the graphite_api module)."""
    GraphiteSeries = H.GraphiteSeries
    _series_args = H._series_args
    _scalars = H._scalars
    _strings = H._strings

    def series_of(api, node, grid, step, tenant):
        return _series_args(api, [node], grid, step, tenant)

    def mk(name, s, vals, grid):
        return GraphiteSeries(name, {"name": name}, grid, vals)

    def keep(s, name, grid, vals=None):
        return GraphiteSeries(name, s.tags, grid,
                              s.values if vals is None else vals,
                              s.path_expr)

    # ---- generic combiners ------------------------------------------------
    def f_aggregate(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        agg = (_strings(args) or ["average"])[0]
        agg = agg[:-6] if agg.endswith("Series") else agg
        if not series:
            return []
        m = np.vstack([s.values for s in series])
        vals = _reduce(m, agg, axis=0)
        label = f'{agg}Series({",".join(s.path_expr or s.name for s in series)})'
        return [mk(label, None, vals, grid)]

    def combine(agg, label):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            if not series:
                return []
            m = np.vstack([s.values for s in series])
            vals = _reduce(m, agg, axis=0)
            name = label.format(",".join(s.path_expr or s.name
                                         for s in series))
            return [mk(name, None, vals, grid)]
        return fn

    G["aggregate"] = f_aggregate
    G["multiplySeries"] = combine("multiply", "multiplySeries({})")
    G["diffSeries"] = combine("diff", "diffSeries({})")
    G["stddevSeries"] = combine("stddev", "stddevSeries({})")
    G["rangeOfSeries"] = combine("range", "rangeOfSeries({})")
    G["countSeries"] = combine("count", "countSeries({})")
    G["medianSeries"] = combine("median", "medianSeries({})")

    def f_group(api, args, grid, step, tenant):
        return _series_args(api, args, grid, step, tenant)
    G["group"] = f_group

    def f_percentile_of_series(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = (_scalars(args) or [50])[0]
        if not series:
            return []
        m = np.vstack([s.values for s in series])
        with np.errstate(all="ignore"):
            vals = np.nanpercentile(m, n, axis=0)
        name = f"percentileOfSeries({series[0].path_expr or series[0].name},{n:g})"
        return [mk(name, None, vals, grid)]
    G["percentileOfSeries"] = f_percentile_of_series

    def f_weighted_average(api, args, grid, step, tenant):
        # weightedAverage(seriesAvg, seriesWeight, *nodes)
        src = [a for a in args if a.kind in ("path", "func")]
        if len(src) < 2:
            return []
        avg_s = series_of(api, src[0], grid, step, tenant)
        w_s = series_of(api, src[1], grid, step, tenant)
        nodes = [int(v) for v in _scalars(args)]

        def key(s):
            segs = s.name.split(".")
            return ".".join(segs[n] for n in nodes
                            if -len(segs) <= n < len(segs))
        wmap = {key(s): s for s in w_s}
        num = np.zeros(grid.size)
        den = np.zeros(grid.size)
        for s in avg_s:
            w = wmap.get(key(s))
            if w is None:
                continue
            prod = s.values * w.values
            ok = ~np.isnan(prod)
            num[ok] += prod[ok]
            ok2 = ~np.isnan(w.values)
            den[ok2] += w.values[ok2]
        with np.errstate(all="ignore"):
            vals = np.where(den != 0, num / den, np.nan)
        return [mk("weightedAverage", None, vals, grid)]
    G["weightedAverage"] = f_weighted_average

    # ---- wildcards / nodes ------------------------------------------------
    def with_wildcards(agg_from_args):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            agg, positions = agg_from_args(args)
            groups = {}
            for s in series:
                segs = s.name.split(".")
                name = ".".join(seg for i, seg in enumerate(segs)
                                if i not in positions)
                groups.setdefault(name, []).append(s)
            out = []
            for name, members in groups.items():
                m = np.vstack([s.values for s in members])
                out.append(mk(name, None, _reduce(m, agg, axis=0), grid))
            return out
        return fn

    G["aggregateWithWildcards"] = with_wildcards(
        lambda args: ((_strings(args) or ["average"])[0],
                      {int(v) for v in _scalars(args)}))
    G["sumSeriesWithWildcards"] = with_wildcards(
        lambda args: ("sum", {int(v) for v in _scalars(args)}))
    G["averageSeriesWithWildcards"] = with_wildcards(
        lambda args: ("average", {int(v) for v in _scalars(args)}))
    G["multiplySeriesWithWildcards"] = with_wildcards(
        lambda args: ("multiply", {int(v) for v in _scalars(args)}))

    def f_group_by_nodes(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        agg = (_strings(args) or ["average"])[0]
        nodes = [int(v) for v in _scalars(args)]
        groups = {}
        for s in series:
            segs = s.name.split(".")
            key = ".".join(segs[n] for n in nodes
                           if -len(segs) <= n < len(segs))
            groups.setdefault(key, []).append(s)
        out = []
        for key, members in sorted(groups.items()):
            m = np.vstack([s.values for s in members])
            out.append(mk(key, None, _reduce(m, agg, axis=0), grid))
        return out
    G["groupByNodes"] = f_group_by_nodes

    def f_group_by_tags(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        agg = (_strings(args) or ["average"])[0]
        tags = _strings(args)[1:]
        groups = {}
        for s in series:
            key = ";".join(f"{t}={s.tags.get(t, '')}" for t in tags)
            groups.setdefault(key, []).append(s)
        out = []
        for key, members in sorted(groups.items()):
            m = np.vstack([s.values for s in members])
            name = f"{agg}Series({key})" if key else f"{agg}Series()"
            g = GraphiteSeries(name, dict(
                kv.split("=", 1) for kv in key.split(";") if "=" in kv),
                grid, _reduce(m, agg, axis=0))
            out.append(g)
        return out
    G["groupByTags"] = f_group_by_tags

    def f_apply_by_node(api, args, grid, step, tenant):
        # applyByNode(series, node, templateFunc, [newName]) — evaluate the
        # template per distinct node prefix
        src = [a for a in args if a.kind in ("path", "func")]
        nodes = [int(v) for v in _scalars(args)]
        strs = _strings(args)
        if not src or not nodes or not strs:
            return []
        series = series_of(api, src[0], grid, step, tenant)
        template = strs[0]
        prefixes = []
        for s in series:
            p = ".".join(s.name.split(".")[:nodes[0] + 1])
            if p not in prefixes:
                prefixes.append(p)
        out = []
        for p in prefixes:
            target = template.replace("%", p)
            node = H._parse_target(target)
            out.extend(api._eval(node, grid, step, tenant))
        return out
    G["applyByNode"] = f_apply_by_node

    # ---- alias family -----------------------------------------------------
    def f_alias_sub(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        if len(strs) < 2:
            return series
        rx = re.compile(strs[0])
        return [keep(s, rx.sub(strs[1], s.name), grid) for s in series]
    G["aliasSub"] = f_alias_sub

    def f_alias_by_metric(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        return [keep(s, s.name.split(".")[-1].split(",")[0], grid)
                for s in series]
    G["aliasByMetric"] = f_alias_by_metric

    # ---- per-point transforms --------------------------------------------
    def per_point(name_fmt, fn_vals, n_scalars=0, defaults=()):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            ks = list(_scalars(args)) + list(defaults)[len(_scalars(args)):]
            out = []
            for s in series:
                with np.errstate(all="ignore"):
                    vals = fn_vals(s.values, *ks[:n_scalars])
                nm = name_fmt.format(s.name, *[f"{k:g}" for k in ks[:n_scalars]])
                out.append(keep(s, nm, grid, vals))
            return out
        return fn

    G["invert"] = per_point("invert({0})",
                            lambda v: np.where(v != 0, 1.0 / v, np.nan))
    G["logarithm"] = per_point(
        "log({0},{1})",
        lambda v, base=10: np.where(v > 0, np.log(v) / np.log(base), np.nan),
        1, (10,))
    G["log"] = G["logarithm"]
    G["logit"] = per_point(
        "logit({0})", lambda v: np.where((v > 0) & (v < 1),
                                         np.log(v / (1 - v)), np.nan))
    G["pow"] = per_point("pow({0},{1})", lambda v, p=1: np.power(v, p),
                         1, (1,))
    G["squareRoot"] = per_point(
        "squareRoot({0})", lambda v: np.where(v >= 0, np.sqrt(v), np.nan))
    G["exp"] = per_point("exp({0})", np.exp)
    G["sigmoid"] = per_point("sigmoid({0})", lambda v: 1 / (1 + np.exp(-v)))
    G["sin"] = per_point("sin({0})", np.sin)
    G["absolute"] = per_point("absolute({0})", np.abs)
    G["add"] = per_point("add({0},{1})", lambda v, k=0: v + k, 1, (0,))
    G["round"] = per_point(
        "round({0})", lambda v, p=0: np.round(v, int(p)), 1, (0,))
    G["minMax"] = per_point(
        "minMax({0})",
        lambda v: np.where(np.nanmax(v) > np.nanmin(v),
                           (v - np.nanmin(v)) /
                           (np.nanmax(v) - np.nanmin(v)), 0.0))
    G["offsetToZero"] = per_point("offsetToZero({0})",
                                  lambda v: v - np.nanmin(v))

    def f_transform_null(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        dflt = (_scalars(args) or [0])[0]
        return [keep(s, f"transformNull({s.name},{dflt:g})", grid,
                     np.where(np.isnan(s.values), dflt, s.values))
                for s in series]
    G["transformNull"] = f_transform_null

    def f_is_non_null(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        return [keep(s, f"isNonNull({s.name})", grid,
                     (~np.isnan(s.values)).astype(float))
                for s in series]
    G["isNonNull"] = f_is_non_null

    def f_interpolate(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        out = []
        for s in series:
            v = s.values.copy()
            ok = ~np.isnan(v)
            if ok.sum() >= 2:
                idx = np.arange(v.size)
                v[~ok] = np.interp(idx[~ok], idx[ok], v[ok])
                # graphite leaves leading/trailing gaps untouched
                first, last = idx[ok][0], idx[ok][-1]
                v[:first] = np.nan
                v[last + 1:] = np.nan
            out.append(keep(s, f"interpolate({s.name})", grid, v))
        return out
    G["interpolate"] = f_interpolate

    def f_changed(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        out = []
        for s in series:
            v = s.values
            prev = np.concatenate([[np.nan], v[:-1]])
            chg = ((~np.isnan(v)) & (~np.isnan(prev)) &
                   (v != prev)).astype(float)
            out.append(keep(s, f"changed({s.name})", grid, chg))
        return out
    G["changed"] = f_changed

    def f_integral(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        out = []
        for s in series:
            vals = np.nancumsum(s.values)
            vals[np.isnan(s.values)] = np.nan
            out.append(keep(s, f"integral({s.name})", grid, vals))
        return out
    G["integral"] = f_integral

    def f_integral_by_interval(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        iv = _interval_s((_strings(args) or ["1h"])[0]) * 1000
        out = []
        for s in series:
            bucket = (grid - grid[0]) // int(iv)
            vals = np.empty(grid.size)
            acc = 0.0
            cur = -1
            for i in range(grid.size):
                if bucket[i] != cur:
                    cur = bucket[i]
                    acc = 0.0
                x = s.values[i]
                if not math.isnan(x):
                    acc += x
                vals[i] = acc
            out.append(keep(s, f"integralByInterval({s.name})", grid, vals))
        return out
    G["integralByInterval"] = f_integral_by_interval

    def f_scale_to_seconds(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        secs = (_scalars(args) or [1])[0]
        k = secs / (step / 1000.0)
        return [keep(s, f"scaleToSeconds({s.name},{secs:g})", grid,
                     s.values * k) for s in series]
    G["scaleToSeconds"] = f_scale_to_seconds

    def f_delay(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = int((_scalars(args) or [1])[0])
        out = []
        for s in series:
            v = np.full(grid.size, np.nan)
            if n >= 0:
                v[n:] = s.values[:grid.size - n] if n < grid.size else []
            else:
                v[:n] = s.values[-n:]
            out.append(keep(s, f"delay({s.name},{n})", grid, v))
        return out
    G["delay"] = f_delay

    def f_time_shift(api, args, grid, step, tenant):
        # re-evaluate the inner expression over a shifted grid
        src = [a for a in args if a.kind in ("path", "func")]
        strs = _strings(args)
        if not src or not strs:
            return []
        shift_s = _interval_s(strs[0])
        if not strs[0].startswith(("+", "-")):
            shift_s = abs(shift_s)
        if not strs[0].startswith("+"):
            shift_s = -abs(shift_s)
        shift = int(shift_s * 1000)
        sgrid = grid + shift
        inner = series_of(api, src[0], sgrid, step, tenant)
        return [GraphiteSeries(f'timeShift({s.name},"{strs[0]}")', s.tags,
                               grid, s.values, s.path_expr) for s in inner]
    G["timeShift"] = f_time_shift

    def f_time_slice(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        now = int(grid[-1])
        start = H.parse_graphite_time(strs[0], grid[0]) if strs else grid[0]
        end = H.parse_graphite_time(strs[1], now) if len(strs) > 1 else now
        out = []
        for s in series:
            v = np.where((grid >= start) & (grid <= end), s.values, np.nan)
            out.append(keep(s, f"timeSlice({s.name})", grid, v))
        return out
    G["timeSlice"] = f_time_slice

    # ---- moving windows ---------------------------------------------------
    def moving(agg_default, label):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            strs = _strings(args)
            nums = _scalars(args)
            agg = agg_default
            if label == "movingWindow" and len(strs) > 1:
                agg = strs[1]
            if strs:
                win = max(int(_interval_s(strs[0]) * 1000 // step), 1)
                wtxt = f'"{strs[0]}"'
            else:
                win = max(int(nums[0]) if nums else 5, 1)
                wtxt = str(win)
            red = _REDUCERS.get(agg, np.nanmean)
            out = []
            for s in series:
                v = s.values
                sw = np.lib.stride_tricks.sliding_window_view(
                    np.concatenate([np.full(win - 1, np.nan), v]), win)
                with np.errstate(all="ignore"):
                    if agg in ("last", "current", "first"):
                        vals = red(sw, axis=1)
                    else:
                        vals = red(sw, axis=1)
                    vals = np.where(np.isnan(sw).all(axis=1), np.nan, vals)
                out.append(keep(s, f"{label}({s.name},{wtxt})", grid, vals))
            return out
        return fn

    G["movingAverage"] = moving("average", "movingAverage")
    G["movingMedian"] = moving("median", "movingMedian")
    G["movingMin"] = moving("min", "movingMin")
    G["movingMax"] = moving("max", "movingMax")
    G["movingSum"] = moving("sum", "movingSum")
    G["movingWindow"] = moving("average", "movingWindow")

    def f_ema(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        nums = _scalars(args)
        if strs:
            win = max(int(_interval_s(strs[0]) * 1000 // step), 1)
        else:
            win = max(int(nums[0]) if nums else 10, 1)
        alpha = 2.0 / (win + 1)
        out = []
        for s in series:
            v = s.values
            vals = np.full(v.size, np.nan)
            ema = np.nan
            for i in range(v.size):
                x = v[i]
                if math.isnan(x):
                    vals[i] = ema
                    continue
                ema = x if math.isnan(ema) else alpha * x + (1 - alpha) * ema
                vals[i] = ema
            out.append(keep(s, f"exponentialMovingAverage({s.name},{win})",
                            grid, vals))
        return out
    G["exponentialMovingAverage"] = f_ema

    # ---- filters ----------------------------------------------------------
    def thresh_filter(stat, cmp, label):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            n = (_scalars(args) or [0])[0]
            return [s for s in series
                    if cmp(_series_stat(s, stat), n)]
        return fn

    def _gt(a, b):
        return not math.isnan(a) and a > b

    def _lt(a, b):
        return not math.isnan(a) and a < b

    G["maximumAbove"] = thresh_filter("max", _gt, "maximumAbove")
    G["maximumBelow"] = thresh_filter("max", _lt, "maximumBelow")
    G["minimumAbove"] = thresh_filter("min", _gt, "minimumAbove")
    G["minimumBelow"] = thresh_filter("min", _lt, "minimumBelow")
    G["averageAbove"] = thresh_filter("average", _gt, "averageAbove")
    G["averageBelow"] = thresh_filter("average", _lt, "averageBelow")
    G["currentAbove"] = thresh_filter("last", _gt, "currentAbove")
    G["currentBelow"] = thresh_filter("last", _lt, "currentBelow")

    def f_filter_series(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        nums = _scalars(args)
        if len(strs) < 2 or not nums:
            return series
        stat, op, n = strs[0], strs[1], nums[0]
        ops = {">": lambda a: a > n, ">=": lambda a: a >= n,
               "<": lambda a: a < n, "<=": lambda a: a <= n,
               "=": lambda a: a == n, "!=": lambda a: a != n}
        f = ops.get(op)
        if f is None:
            raise ValueError(f"unsupported filterSeries op {op!r}")
        return [s for s in series
                if not math.isnan(_series_stat(s, stat))
                and f(_series_stat(s, stat))]
    G["filterSeries"] = f_filter_series

    def top_bottom(best, stat_default):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            nums = _scalars(args)
            strs = _strings(args)
            n = int(nums[0]) if nums else 1
            stat = strs[0] if strs else stat_default
            scored = [(s, _series_stat(s, stat)) for s in series]
            scored = [(s, x) for s, x in scored if not math.isnan(x)]
            scored.sort(key=lambda sx: sx[1], reverse=best)
            return [s for s, _ in scored[:n]]
        return fn

    G["highest"] = top_bottom(True, "average")
    G["lowest"] = top_bottom(False, "average")
    G["highestAverage"] = top_bottom(True, "average")
    G["lowestAverage"] = top_bottom(False, "average")
    G["highestCurrent"] = top_bottom(True, "last")
    G["lowestCurrent"] = top_bottom(False, "last")
    G["highestMax"] = top_bottom(True, "max")

    def f_limit(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = int((_scalars(args) or [1])[0])
        return series[:n]
    G["limit"] = f_limit

    def remove_value(cmp, label):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            n = (_scalars(args) or [0])[0]
            out = []
            for s in series:
                v = np.where(cmp(s.values, n), np.nan, s.values)
                out.append(keep(s, f"{label}({s.name},{n:g})", grid, v))
            return out
        return fn

    G["removeAboveValue"] = remove_value(lambda v, n: v > n,
                                         "removeAboveValue")
    G["removeBelowValue"] = remove_value(lambda v, n: v < n,
                                         "removeBelowValue")

    def remove_pct(above):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            n = (_scalars(args) or [50])[0]
            out = []
            for s in series:
                with np.errstate(all="ignore"):
                    p = np.nanpercentile(s.values, n) \
                        if not np.isnan(s.values).all() else np.nan
                v = np.where(s.values > p, np.nan, s.values) if above \
                    else np.where(s.values < p, np.nan, s.values)
                label = "removeAbovePercentile" if above \
                    else "removeBelowPercentile"
                out.append(keep(s, f"{label}({s.name},{n:g})", grid, v))
            return out
        return fn

    G["removeAbovePercentile"] = remove_pct(True)
    G["removeBelowPercentile"] = remove_pct(False)

    def f_remove_empty(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        nums = _scalars(args)
        xff = nums[0] if nums else 0.0
        out = []
        for s in series:
            ok = ~np.isnan(s.values)
            frac = ok.mean() if s.values.size else 0.0
            if ok.any() and (xff <= 0 or frac >= xff):
                out.append(s)
        return out
    G["removeEmptySeries"] = f_remove_empty

    def f_grep(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        rx = re.compile((_strings(args) or [""])[0])
        return [s for s in series if rx.search(s.name)]
    G["grep"] = f_grep

    def f_exclude(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        rx = re.compile((_strings(args) or [""])[0])
        return [s for s in series if not rx.search(s.name)]
    G["exclude"] = f_exclude

    def f_unique(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        seen = set()
        out = []
        for s in series:
            if s.name not in seen:
                seen.add(s.name)
                out.append(s)
        return out
    G["unique"] = f_unique

    def f_average_outside_percentile(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = (_scalars(args) or [95])[0]
        n = max(n, 100 - n)
        avgs = [_series_stat(s, "average") for s in series]
        if not avgs:
            return []
        lo_t = np.nanpercentile(avgs, 100 - n)
        hi_t = np.nanpercentile(avgs, n)
        return [s for s, a in zip(series, avgs)
                if not math.isnan(a) and (a < lo_t or a > hi_t)]
    G["averageOutsidePercentile"] = f_average_outside_percentile

    def f_most_deviant(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = int((_scalars(args) or [1])[0])
        scored = [(s, _series_stat(s, "stddev")) for s in series]
        scored = [(s, x) for s, x in scored if not math.isnan(x)]
        scored.sort(key=lambda sx: sx[1], reverse=True)
        return [s for s, _ in scored[:n]]
    G["mostDeviant"] = f_most_deviant

    def f_use_series_above(api, args, grid, step, tenant):
        # useSeriesAbove(series, value, search, replace)
        series = _series_args(api, args, grid, step, tenant)
        nums = _scalars(args)
        strs = _strings(args)
        if not nums or len(strs) < 2:
            return []
        n, search, repl = nums[0], strs[0], strs[1]
        out = []
        for s in series:
            if _gt(_series_stat(s, "max"), n):
                target = s.name.replace(search, repl)
                node = H._parse_target(target)
                out.extend(api._eval(node, grid, step, tenant))
        return out
    G["useSeriesAbove"] = f_use_series_above

    # ---- sorting ----------------------------------------------------------
    def f_sort_by(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        stat = strs[0] if strs else "average"
        rev = bool(args and args[-1].kind == "bool" and args[-1].value) \
            if hasattr(args[-1] if args else None, "kind") else False
        rev = any(getattr(a, "kind", "") == "bool" and a.value for a in args)
        series.sort(key=lambda s: (math.isnan(_series_stat(s, stat)),
                                   _series_stat(s, stat)), reverse=rev)
        return series
    G["sortBy"] = f_sort_by

    def sort_by_stat(stat, rev):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            series.sort(key=lambda s: (math.isnan(_series_stat(s, stat)),
                                       _series_stat(s, stat)), reverse=rev)
            return series
        return fn

    G["sortByTotal"] = sort_by_stat("sum", True)
    G["sortByMaxima"] = sort_by_stat("max", True)
    G["sortByMinima"] = sort_by_stat("min", False)

    def f_sort_by_name(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        natural = any(getattr(a, "kind", "") == "bool" and a.value
                      for a in args)

        def natkey(s):
            return [int(t) if t.isdigit() else t
                    for t in re.split(r"(\d+)", s.name)]
        series.sort(key=natkey if natural else (lambda s: s.name))
        return series
    G["sortByName"] = f_sort_by_name

    # ---- division / percent ----------------------------------------------
    def f_divide_series(api, args, grid, step, tenant):
        src = [a for a in args if a.kind in ("path", "func")]
        if len(src) < 2:
            return []
        dividends = series_of(api, src[0], grid, step, tenant)
        divisors = series_of(api, src[1], grid, step, tenant)
        if len(divisors) != 1:
            raise ValueError("divideSeries needs exactly one divisor series")
        d = divisors[0].values
        out = []
        with np.errstate(all="ignore"):
            for s in dividends:
                vals = np.where(d != 0, s.values / d, np.nan)
                out.append(keep(
                    s, f"divideSeries({s.name},{divisors[0].name})", grid,
                    vals))
        return out
    G["divideSeries"] = f_divide_series

    def series_lists(op, label):
        def fn(api, args, grid, step, tenant):
            src = [a for a in args if a.kind in ("path", "func")]
            if len(src) < 2:
                return []
            a_s = series_of(api, src[0], grid, step, tenant)
            b_s = series_of(api, src[1], grid, step, tenant)
            if len(a_s) != len(b_s):
                raise ValueError(f"{label}: series list lengths differ "
                                 f"({len(a_s)} vs {len(b_s)})")
            out = []
            with np.errstate(all="ignore"):
                for x, y in zip(a_s, b_s):
                    out.append(keep(x, f"{label}({x.name},{y.name})", grid,
                                    op(x.values, y.values)))
            return out
        return fn

    G["divideSeriesLists"] = series_lists(
        lambda a, b: np.where(b != 0, a / b, np.nan), "divideSeriesLists")
    G["multiplySeriesLists"] = series_lists(
        lambda a, b: a * b, "multiplySeriesLists")
    G["sumSeriesLists"] = series_lists(lambda a, b: a + b, "sumSeriesLists")
    G["diffSeriesLists"] = series_lists(lambda a, b: a - b,
                                        "diffSeriesLists")

    def f_as_percent(api, args, grid, step, tenant):
        src = [a for a in args if a.kind in ("path", "func")]
        series = series_of(api, src[0], grid, step, tenant) if src else []
        nums = _scalars(args)
        out = []
        with np.errstate(all="ignore"):
            if nums:
                total = np.full(grid.size, float(nums[0]))
            elif len(src) > 1:
                ts = series_of(api, src[1], grid, step, tenant)
                total = np.nansum(np.vstack([t.values for t in ts]), axis=0) \
                    if ts else np.full(grid.size, np.nan)
            else:
                total = np.nansum(np.vstack([s.values for s in series]),
                                  axis=0) if series else None
            for s in series:
                vals = np.where(total != 0, s.values / total * 100.0, np.nan)
                out.append(keep(s, f"asPercent({s.name})", grid, vals))
        return out
    G["asPercent"] = f_as_percent
    G["pct"] = f_as_percent

    # ---- stats ------------------------------------------------------------
    def f_n_percentile(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = (_scalars(args) or [50])[0]
        out = []
        for s in series:
            with np.errstate(all="ignore"):
                p = np.nanpercentile(s.values, n) \
                    if not np.isnan(s.values).all() else np.nan
            out.append(keep(s, f"nPercentile({s.name},{n:g})", grid,
                            np.full(grid.size, p)))
        return out
    G["nPercentile"] = f_n_percentile

    def f_stdev(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = int((_scalars(args) or [5])[0])
        out = []
        for s in series:
            sw = np.lib.stride_tricks.sliding_window_view(
                np.concatenate([np.full(n - 1, np.nan), s.values]), n)
            with np.errstate(all="ignore"):
                vals = np.nanstd(sw, axis=1)
            vals = np.where(np.isnan(sw).all(axis=1), np.nan, vals)
            out.append(keep(s, f"stdev({s.name},{n})", grid, vals))
        return out
    G["stdev"] = f_stdev

    def f_linear_regression(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        out = []
        t = (grid - grid[0]) / 1000.0
        for s in series:
            ok = ~np.isnan(s.values)
            if ok.sum() >= 2:
                k, b = np.polyfit(t[ok], s.values[ok], 1)
                vals = k * t + b
            else:
                vals = np.full(grid.size, np.nan)
            out.append(keep(s, f"linearRegression({s.name})", grid, vals))
        return out
    G["linearRegression"] = f_linear_regression

    def f_aggregate_line(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        agg = (_strings(args) or ["average"])[0]
        out = []
        for s in series:
            x = _series_stat(s, agg)
            out.append(keep(s, f"aggregateLine({s.name},{x:g})", grid,
                            np.full(grid.size, x)))
        return out
    G["aggregateLine"] = f_aggregate_line

    # ---- constants / synthetic -------------------------------------------
    def f_constant_line(api, args, grid, step, tenant):
        n = (_scalars(args) or [0])[0]
        return [GraphiteSeries(f"{n:g}", {"name": f"{n:g}"}, grid,
                               np.full(grid.size, float(n)))]
    G["constantLine"] = f_constant_line

    def f_threshold(api, args, grid, step, tenant):
        n = (_scalars(args) or [0])[0]
        strs = _strings(args)
        name = strs[0] if strs else f"{n:g}"
        return [GraphiteSeries(name, {"name": name}, grid,
                               np.full(grid.size, float(n)))]
    G["threshold"] = f_threshold

    def f_identity(api, args, grid, step, tenant):
        name = (_strings(args) or ["identity"])[0]
        return [GraphiteSeries(name, {"name": name}, grid,
                               grid.astype(float) / 1000.0)]
    G["identity"] = f_identity

    def f_time(api, args, grid, step, tenant):
        name = (_strings(args) or ["time"])[0]
        return [GraphiteSeries(name, {"name": name}, grid,
                               grid.astype(float) / 1000.0)]
    G["time"] = f_time
    G["timeFunction"] = f_time

    def f_sin_function(api, args, grid, step, tenant):
        strs = _strings(args)
        nums = _scalars(args)
        name = strs[0] if strs else "sinFunction"
        amp = nums[0] if nums else 1.0
        return [GraphiteSeries(name, {"name": name}, grid,
                               amp * np.sin(grid / 1000.0))]
    G["sinFunction"] = f_sin_function

    def f_random_walk(api, args, grid, step, tenant):
        strs = _strings(args)
        name = strs[0] if strs else "randomWalk"
        rng = np.random.default_rng(abs(hash(name)) % (2**32))
        vals = np.cumsum(rng.uniform(-0.5, 0.5, grid.size))
        return [GraphiteSeries(name, {"name": name}, grid, vals)]
    G["randomWalk"] = f_random_walk
    G["randomWalkFunction"] = f_random_walk

    def f_events(api, args, grid, step, tenant):
        return []
    G["events"] = f_events

    def f_fallback(api, args, grid, step, tenant):
        src = [a for a in args if a.kind in ("path", "func")]
        for a in src:
            series = series_of(api, a, grid, step, tenant)
            if series:
                return series
        return []
    G["fallbackSeries"] = f_fallback

    def f_substr(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        nums = [int(v) for v in _scalars(args)]
        start = nums[0] if nums else 0
        stop = nums[1] if len(nums) > 1 else 0
        out = []
        for s in series:
            base = s.name.split("(")[-1].split(")")[0]
            segs = base.split(".")
            sl = segs[start:stop] if stop else segs[start:]
            out.append(keep(s, ".".join(sl), grid))
        return out
    G["substr"] = f_substr

    def f_hitcount(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        iv = int(_interval_s((_strings(args) or ["1min"])[0]) * 1000)
        win = max(iv // step, 1)
        out = []
        for s in series:
            vals = np.full(grid.size, np.nan)
            for i in range(0, grid.size, win):
                w = s.values[i:i + win]
                if not np.isnan(w).all():
                    vals[i:i + win] = np.nansum(w) * (step / 1000.0)
            out.append(keep(s, f"hitcount({s.name})", grid, vals))
        return out
    G["hitcount"] = f_hitcount

    def f_smart_summarize(api, args, grid, step, tenant):
        return G["summarize"](api, args, grid, step, tenant)
    G["smartSummarize"] = f_smart_summarize

    def f_cumulative(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        return [keep(s, f"cumulative({s.name})", grid) for s in series]
    G["cumulative"] = f_cumulative

    def f_consolidate_by(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        how = (_strings(args) or ["avg"])[0]
        return [keep(s, f'consolidateBy({s.name},"{how}")', grid)
                for s in series]
    G["consolidateBy"] = f_consolidate_by

    def f_set_xff(api, args, grid, step, tenant):
        return _series_args(api, args, grid, step, tenant)
    G["setXFilesFactor"] = f_set_xff
    G["xFilesFactor"] = f_set_xff

    def f_aggregate_series_lists(api, args, grid, step, tenant):
        src = [a for a in args if a.kind in ("path", "func")]
        agg = (_strings(args) or ["sum"])[0]
        if len(src) < 2:
            return []
        a_s = series_of(api, src[0], grid, step, tenant)
        b_s = series_of(api, src[1], grid, step, tenant)
        if len(a_s) != len(b_s):
            raise ValueError("aggregateSeriesLists: lengths differ")
        out = []
        for x, y in zip(a_s, b_s):
            m = np.vstack([x.values, y.values])
            out.append(keep(x, f"{agg}Series({x.name},{y.name})", grid,
                            _reduce(m, agg, axis=0)))
        return out
    G["aggregateSeriesLists"] = f_aggregate_series_lists

    G["powSeries"] = combine("pow", "powSeries({})")

    def f_remove_between_percentile(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        n = (_scalars(args) or [30])[0]
        n = max(n, 100 - n)
        if not series:
            return []
        m = np.vstack([s.values for s in series])
        with np.errstate(all="ignore"):
            lo_b = np.nanpercentile(m, 100 - n, axis=0)
            hi_b = np.nanpercentile(m, n, axis=0)
        out = []
        for s in series:
            v = s.values
            ok = ~np.isnan(v)
            if (ok & ((v < lo_b) | (v > hi_b))).any():
                out.append(s)
        return out
    G["removeBetweenPercentile"] = f_remove_between_percentile

    def f_time_stack(api, args, grid, step, tenant):
        src = [a for a in args if a.kind in ("path", "func")]
        strs = _strings(args)
        nums = [int(v) for v in _scalars(args)]
        if not src:
            return []
        unit = _interval_s(strs[0]) if strs else 86400
        start = nums[0] if nums else 0
        end = nums[1] if len(nums) > 1 else 7
        out = []
        for k in range(start, end):
            shift = int(-k * unit * 1000)
            sgrid = grid + shift
            for s in series_of(api, src[0], sgrid, step, tenant):
                out.append(GraphiteSeries(
                    f"timeShift({s.name},{-k})", s.tags, grid, s.values,
                    s.path_expr))
        return out
    G["timeStack"] = f_time_stack

    def f_map_series(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        nums = [int(v) for v in _scalars(args)]
        node = nums[0] if nums else 0
        groups = {}
        for s in series:
            segs = s.name.split(".")
            key = segs[node] if -len(segs) <= node < len(segs) else ""
            groups.setdefault(key, []).append(s)
        # mapSeries returns the series tagged by group; reduceSeries
        # consumes the grouping via name structure
        out = []
        for key in sorted(groups):
            out.extend(groups[key])
        return out
    G["map"] = f_map_series
    G["mapSeries"] = f_map_series

    def f_reduce_series(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        nums = [int(v) for v in _scalars(args)]
        if not strs:
            return series
        fn_name = strs[0]
        red_node = nums[0] if nums else 1
        matchers = strs[1:]
        groups = {}
        for s in series:
            segs = s.name.split(".")
            key = ".".join(seg for i, seg in enumerate(segs)
                           if i != red_node or i >= len(segs))
            groups.setdefault(key, []).append(s)
        red = G.get(fn_name) or G.get(fn_name + "Series")
        out = []
        for key, members in sorted(groups.items()):
            if matchers:
                ordered = []
                for want in matchers:
                    for s in members:
                        segs = s.name.split(".")
                        if red_node < len(segs) and segs[red_node] == want:
                            ordered.append(s)
                members = ordered
            m = np.vstack([s.values for s in members]) if members else None
            if m is None:
                continue
            agg = fn_name[:-6] if fn_name.endswith("Series") else fn_name
            if agg == "asPercent" and len(members) == 2:
                with np.errstate(all="ignore"):
                    vals = np.where(members[1].values != 0,
                                    members[0].values / members[1].values
                                    * 100.0, np.nan)
            elif agg == "divide" and len(members) == 2:
                with np.errstate(all="ignore"):
                    vals = np.where(members[1].values != 0,
                                    members[0].values / members[1].values,
                                    np.nan)
            elif agg == "diff":
                vals = _reduce(m, "diff", axis=0)
            else:
                vals = _reduce(m, agg, axis=0)
            out.append(mk(key, None, vals, grid))
        return out
    G["reduce"] = f_reduce_series
    G["reduceSeries"] = f_reduce_series

    def f_alias_query(api, args, grid, step, tenant):
        # aliasQuery(series, search, replace, newName): run a query derived
        # from each series name, use its last value in the new name
        series = _series_args(api, args, grid, step, tenant)
        strs = _strings(args)
        if len(strs) < 3:
            return series
        rx = re.compile(strs[0])
        out = []
        for s in series:
            target = rx.sub(strs[1].replace("\\\\", "\\"), s.name)
            node = H._parse_target(target)
            got = api._eval(node, grid, step, tenant)
            last = np.nan
            if got:
                ok = ~np.isnan(got[0].values)
                if ok.any():
                    last = float(got[0].values[ok][-1])
            out.append(keep(s, strs[2].replace("%d", f"{last:g}")
                            .replace("%g", f"{last:g}"), grid))
        return out
    G["aliasQuery"] = f_alias_query

    # ---- holt-winters -----------------------------------------------------
    def _hw_params(args):
        strs = _strings(args)
        boot = _interval_s(strs[0]) if strs else 7 * 86400
        season = _interval_s(strs[1]) if len(strs) > 1 else 86400
        return boot, season

    def _hw_series(api, args, grid, step, tenant):
        """Evaluate the inner expr over (grid extended by the bootstrap
        interval) and run the graphite holtWintersAnalysis recurrence
        (additive triple exponential smoothing, alpha=.1 beta=.0035
        gamma=.1); returns (series, forecasts, deviations, n_boot)."""
        src = [a for a in args if a.kind in ("path", "func")]
        if not src:
            return [], [], [], 0
        boot_s, season_s = _hw_params(args)
        n_boot = min(int(boot_s * 1000 // step), 200_000 // max(1, 1))
        egrid = np.arange(grid[0] - n_boot * step, grid[-1] + 1, step,
                          dtype=np.int64)
        n_boot = egrid.size - grid.size
        season_len = max(int(season_s * 1000 // step), 1)
        series = series_of(api, src[0], egrid, step, tenant)
        forecasts, deviations = [], []
        for s in series:
            v = s.values
            n = v.size
            pred = np.full(n, np.nan)
            dev = np.full(n, np.nan)
            intercept = slope = 0.0
            seasonal = np.zeros(season_len)
            sdev = np.zeros(season_len)
            alpha, beta, gamma = 0.1, 0.0035, 0.1
            started = False
            for i in range(n):
                x = v[i]
                si = i % season_len
                if math.isnan(x):
                    pred[i] = intercept + slope + seasonal[si]
                    dev[i] = sdev[si]
                    continue
                if not started:
                    intercept, slope = x, 0.0
                    started = True
                p = intercept + slope + seasonal[si]
                pred[i] = p
                new_i = alpha * (x - seasonal[si]) + \
                    (1 - alpha) * (intercept + slope)
                slope = beta * (new_i - intercept) + (1 - beta) * slope
                intercept = new_i
                seasonal[si] = gamma * (x - intercept) + \
                    (1 - gamma) * seasonal[si]
                sdev[si] = gamma * abs(x - p) + (1 - gamma) * sdev[si]
                dev[i] = sdev[si]
            forecasts.append(pred)
            deviations.append(dev)
        return series, forecasts, deviations, n_boot

    def f_hw_forecast(api, args, grid, step, tenant):
        series, fc, _, nb = _hw_series(api, args, grid, step, tenant)
        return [GraphiteSeries(f"holtWintersForecast({s.name})", s.tags,
                               grid, p[nb:], s.path_expr)
                for s, p in zip(series, fc)]
    G["holtWintersForecast"] = f_hw_forecast

    def f_hw_bands(api, args, grid, step, tenant):
        series, fc, dv, nb = _hw_series(api, args, grid, step, tenant)
        delta = 3.0
        out = []
        for s, p, d in zip(series, fc, dv):
            out.append(GraphiteSeries(
                f"holtWintersConfidenceUpper({s.name})", s.tags, grid,
                p[nb:] + delta * d[nb:], s.path_expr))
            out.append(GraphiteSeries(
                f"holtWintersConfidenceLower({s.name})", s.tags, grid,
                p[nb:] - delta * d[nb:], s.path_expr))
        return out
    G["holtWintersConfidenceBands"] = f_hw_bands
    G["holtWintersConfidenceArea"] = f_hw_bands

    def f_hw_aberration(api, args, grid, step, tenant):
        series, fc, dv, nb = _hw_series(api, args, grid, step, tenant)
        delta = 3.0
        out = []
        for s, p, d in zip(series, fc, dv):
            actual = s.values[nb:]
            upper = p[nb:] + delta * d[nb:]
            lower = p[nb:] - delta * d[nb:]
            ab = np.where(actual > upper, actual - upper,
                          np.where(actual < lower, actual - lower, 0.0))
            out.append(GraphiteSeries(
                f"holtWintersAberration({s.name})", s.tags, grid, ab,
                s.path_expr))
        return out
    G["holtWintersAberration"] = f_hw_aberration

    # display no-ops: rendering hints the JSON API carries through untouched
    def noop(api, args, grid, step, tenant):
        return _series_args(api, args, grid, step, tenant)
    for name in ("alpha", "color", "dashed", "drawAsInfinite", "lineWidth",
                 "secondYAxis", "stacked", "legendValue", "cactiStyle",
                 "areaBetween", "verticalLine"):
        G[name] = noop

    return G
