"""Graphite query API (reference app/vmselect/graphite/: metrics_api.go,
tags_api.go, render_api.go + transform functions in functions.go).

Implements the surface Grafana's Graphite datasource uses:
  /metrics/find         hierarchical browsing with * globs
  /metrics/expand
  /render               target expressions with the common function set
  /tags /tags/<name> /tags/autoComplete/{tags,values} /tags/findSeries

Graphite metrics are series whose __name__ is the dotted path (the
graphite ingest listener produces exactly that; `;tag=value` suffixes
become labels).

The port's copy of ``victoriametrics_tpu/httpapi/graphite_api.py``, whole;
vmsingle registers it over its ``Storage`` and vmselect over its
``ClusterStorage``.
"""

from __future__ import annotations

import math
import re
import time

import numpy as np

from ..storage.tag_filters import TagFilter
from ..utils import fasttime
from .server import HTTPServer, Request, Response


# -- time parsing (graphite from/until) --------------------------------------

_REL_RE = re.compile(r"^-(\d+)(s|min|h|d|w|mon|y)$")
_UNIT_S = {"s": 1, "min": 60, "h": 3600, "d": 86400, "w": 7 * 86400,
           "mon": 30 * 86400, "y": 365 * 86400}


def parse_graphite_time(s: str, default_ms: int) -> int:
    if not s:
        return default_ms
    s = s.strip()
    if s == "now":
        return fasttime.unix_ms()
    m = _REL_RE.match(s)
    if m:
        return fasttime.unix_ms() - \
            int(m.group(1)) * _UNIT_S[m.group(2)] * 1000
    try:
        v = float(s)
        # heuristic: epoch seconds vs ms like the reference
        return int(v * 1000) if v < 1e12 else int(v)
    except ValueError:
        raise ValueError(f"cannot parse graphite time {s!r}")


# -- target expression parser -------------------------------------------------

class _GNode:
    """func call | path glob | string | number"""

    def __init__(self, kind, value, args=None):
        self.kind = kind
        self.value = value
        self.args = args or []


def _parse_target(s: str) -> _GNode:
    pos = 0

    def parse_expr():
        nonlocal pos
        while pos < len(s) and s[pos].isspace():
            pos += 1
        c = s[pos]
        if c in "\"'":
            end = s.index(c, pos + 1)
            node = _GNode("str", s[pos + 1:end])
            pos = end + 1
            return node
        if c.isdigit() or c == "-" or c == ".":
            m = re.match(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?", s[pos:])
            if m:
                node = _GNode("num", float(m.group(0)))
                pos += m.end()
                return node
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*\(", s[pos:])
        if m:
            name = m.group(0)[:-1]
            pos += m.end()
            args = []
            while True:
                while pos < len(s) and s[pos].isspace():
                    pos += 1
                if s[pos] == ")":
                    pos += 1
                    break
                args.append(parse_expr())
                while pos < len(s) and s[pos].isspace():
                    pos += 1
                if pos < len(s) and s[pos] == ",":
                    pos += 1
            return _GNode("func", name, args)
        m = re.match(r"(?:true|false)(?=[,)\s]|$)", s[pos:])
        if m:
            node = _GNode("bool", m.group(0) == "true")
            pos += m.end()
            return node
        m = re.match(r"[^,()\s]+", s[pos:])
        if not m:
            raise ValueError(f"cannot parse target at {pos}: {s!r}")
        node = _GNode("path", m.group(0))
        pos += m.end()
        return node

    node = parse_expr()
    while pos < len(s) and s[pos].isspace():
        pos += 1
    if pos != len(s):
        raise ValueError(f"trailing garbage in target: {s[pos:]!r}")
    return node


def _glob_to_regex(glob: str) -> str:
    """Graphite glob -> regex over the full dotted name: * does not cross
    dots; {a,b} alternation; [] classes pass through."""
    out = []
    i = 0
    while i < len(glob):
        c = glob[i]
        if c == "*":
            out.append(r"[^.]*")
        elif c == "?":
            out.append(r"[^.]")
        elif c == "{":
            j = glob.index("}", i)
            alts = glob[i + 1:j].split(",")
            out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
            i = j
        elif c == "[":
            j = glob.index("]", i)
            out.append(glob[i:j + 1])
            i = j
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


class GraphiteSeries:
    __slots__ = ("name", "tags", "timestamps", "values", "path_expr")

    def __init__(self, name, tags, timestamps, values, path_expr=""):
        self.name = name
        self.tags = tags
        self.timestamps = timestamps  # ms grid
        self.values = values
        self.path_expr = path_expr


class GraphiteAPI:
    def __init__(self, storage, default_step_ms: int = 60_000):
        self.storage = storage
        self.step_ms = default_step_ms

    def register(self, srv: HTTPServer):
        r = srv.route
        r("/metrics/find", self.h_find)
        r("/metrics/find/", self.h_find)
        r("/metrics/expand", self.h_expand)
        r("/render", self.h_render)
        r("/render/", self.h_render)
        r("/tags/autoComplete/tags", self.h_ac_tags)
        r("/tags/autoComplete/values", self.h_ac_values)
        r("/tags/findSeries", self.h_find_series)
        r("/tags", self.h_tags)
        r("/tags/", self.h_tag_values)
        r("/functions", self.h_functions)
        r("/functions/", self.h_functions)

    def h_functions(self, req: Request) -> Response:
        """Introspection: the render functions this server implements
        (reference graphiteFunctions handler, render_api.go)."""
        out = {name: {"name": name, "function": f"{name}(seriesList)",
                      "description": "", "module": "graphite.render",
                      "group": "", "params": []}
               for name in sorted(_G_FUNCS)}
        return Response.json(out)

    # -- metrics api ---------------------------------------------------------

    def _names(self, tenant=(0, 0)) -> list[str]:
        return self.storage.label_values("__name__", tenant=tenant)

    def _find_nodes(self, query: str, tenant=(0, 0)):
        """(text, full_path, is_leaf) nodes one level below the glob."""
        # the common tree-expansion shape ("*" / "prefix.*") pushes down
        # to the storage's path-suffix index (tagValueSuffixes — on a
        # cluster that is one fanned-out RPC instead of pulling every
        # metric name)
        sfx_fn = getattr(self.storage, "tag_value_suffixes", None)
        m = re.fullmatch(r"((?:[^*?,{}\[\]]+\.)?)\*", query)
        if sfx_fn is not None and m:
            prefix = m.group(1)
            merged: dict[str, list] = {}
            for s in sfx_fn("__name__", prefix, ".", tenant=tenant):
                kids = s.endswith(".")
                text = s[:-1] if kids else s
                if not text:
                    continue
                e = merged.setdefault(text, [False, False])
                if kids:
                    e[1] = True
                else:
                    e[0] = True
            return [(text, prefix + text, leaf, kids)
                    for text, (leaf, kids) in sorted(merged.items())]
        depth = query.count(".") + 1
        rx = re.compile("^" + _glob_to_regex(query))
        # path -> [is_leaf, has_children]: a path can be both a metric and
        # a branch; Grafana needs expandable=1 whenever children exist
        nodes: dict[str, list] = {}
        for name in self._names(tenant):
            segs = name.split(".")
            if len(segs) < depth:
                continue
            prefix = ".".join(segs[:depth])
            if not rx.fullmatch(prefix):
                continue
            e = nodes.setdefault(prefix, [False, False])
            if len(segs) == depth:
                e[0] = True
            else:
                e[1] = True
        return [(p.rsplit(".", 1)[-1], p, leaf, kids)
                for p, (leaf, kids) in sorted(nodes.items())]

    def h_find(self, req: Request) -> Response:
        query = req.arg("query", "*")
        fmt = req.arg("format", "treejson")
        nodes = self._find_nodes(query, _tenant(req))
        if fmt == "completer":
            return Response.json({"metrics": [
                {"name": text, "path": p + ("." if kids else ""),
                 "is_leaf": "1" if leaf else "0"}
                for text, p, leaf, kids in nodes]})
        return Response.json([
            {"text": text, "id": p, "leaf": 1 if leaf else 0,
             "expandable": 1 if kids else 0,
             "allowChildren": 1 if kids else 0, "context": {}}
            for text, p, leaf, kids in nodes])

    def h_expand(self, req: Request) -> Response:
        out = set()
        for q in req.args("query"):
            for _, p, _leaf, _kids in self._find_nodes(q, _tenant(req)):
                out.add(p)
        return Response.json({"results": sorted(out)})

    # -- tags api ------------------------------------------------------------

    def h_tags(self, req: Request) -> Response:
        names = [n for n in self.storage.label_names(tenant=_tenant(req))
                 if n != "__name__"]
        return Response.json([{"tag": "name"}] +
                             [{"tag": n} for n in names])

    def h_tag_values(self, req: Request) -> Response:
        tag = req.path.rsplit("/", 1)[-1]
        key = "__name__" if tag == "name" else tag
        vals = self.storage.label_values(key, tenant=_tenant(req))
        return Response.json({
            "tag": tag,
            "values": [{"value": v, "count": 1} for v in sorted(vals)]})

    def h_ac_tags(self, req: Request) -> Response:
        prefix = req.arg("tagPrefix", "")
        names = ["name"] + [
            n for n in self.storage.label_names(tenant=_tenant(req))
            if n != "__name__"]
        return Response.json(sorted(n for n in names
                                    if n.startswith(prefix)))

    def h_ac_values(self, req: Request) -> Response:
        tag = req.arg("tag")
        prefix = req.arg("valuePrefix", "")
        key = "__name__" if tag == "name" else tag
        vals = self.storage.label_values(key, tenant=_tenant(req))
        return Response.json(sorted(v for v in vals
                                    if v.startswith(prefix)))

    def h_find_series(self, req: Request) -> Response:
        filters = [_tag_expr_filter(e) for e in req.args("expr")]
        now = fasttime.unix_ms()
        names = self.storage.search_metric_names(
            filters, 0, now, tenant=_tenant(req))
        out = []
        for mn in names:
            path = mn.metric_group.decode("utf-8", "replace")
            tags = ";".join(f"{k.decode()}={v.decode()}"
                            for k, v in mn.labels)
            out.append(path + (";" + tags if tags else ""))
        return Response.json(sorted(out))

    # -- render --------------------------------------------------------------

    def h_render(self, req: Request) -> Response:
        now = fasttime.unix_ms()
        try:
            frm = parse_graphite_time(req.arg("from"), now - 3600_000)
            until = parse_graphite_time(req.arg("until"), now)
            mdp = int(req.arg("maxDataPoints", "0") or 0)
        except ValueError as e:
            return Response.error(f"cannot render: {e}", 400)
        step = self.step_ms
        if mdp > 0:
            step = max(step, ((until - frm) // mdp + step - 1)
                       // step * step)
        # grid end rounds UP so samples newer than the last whole step
        # still land in the final bucket (fresh writes at `now`)
        grid_end = until if until % step == 0 else until + step - until % step
        grid = np.arange(frm - frm % step, grid_end + 1, step,
                         dtype=np.int64)
        out = []
        try:
            for target in req.args("target"):
                node = _parse_target(target)
                out.extend(self._eval(node, grid, step, _tenant(req)))
        except (ValueError, KeyError, IndexError) as e:
            return Response.error(f"cannot render: {e}", 400)
        body = [{
            "target": s.name,
            "tags": s.tags,
            "datapoints": [
                [None if math.isnan(v) else v, int(t) // 1000]
                for t, v in zip(s.timestamps, s.values)],
        } for s in out]
        return Response.json(body)

    def _fetch(self, path_glob: str, grid, step, tenant):
        """Series matching a dotted glob, aligned to the grid."""
        rx = "^" + _glob_to_regex(path_glob) + "$"
        filters = [TagFilter(b"", rx.encode(), regex=True)]
        return _fetch_aligned(self.storage, filters, grid, step, tenant,
                              path_glob)

    def _eval(self, node: _GNode, grid, step, tenant
              ) -> list[GraphiteSeries]:
        if node.kind == "path":
            return self._fetch(node.value, grid, step, tenant)
        if node.kind != "func":
            raise ValueError(f"unexpected {node.kind} at top level")
        fn = _G_FUNCS.get(node.value)
        if fn is None:
            raise ValueError(f"unsupported graphite function {node.value!r}")
        return fn(self, node.args, grid, step, tenant)


def _tenant(req) -> tuple:
    return getattr(req, "tenant", None) or (0, 0)


def _tag_expr_filter(expr: str) -> TagFilter:
    """Graphite tag expression: tag=value, tag!=value, tag=~re, tag!=~re."""
    m = re.match(r"([^!=~]+)(!?=~?)(.*)", expr)
    if not m:
        raise ValueError(f"cannot parse tag expression {expr!r}")
    tag, op, value = m.groups()
    key = b"" if tag == "name" else tag.encode()
    return TagFilter(key, value.encode(), negate=op.startswith("!"),
                     regex=op.endswith("~"))


# -- graphite transform functions (functions.go subset) -----------------------

def _series_args(api, args, grid, step, tenant):
    out = []
    for a in args:
        if a.kind in ("path", "func"):
            out.extend(api._eval(a, grid, step, tenant))
    return out


def _scalars(args):
    return [a.value for a in args if a.kind == "num"]


def _strings(args):
    return [a.value for a in args if a.kind == "str"]


def _combine(name_fmt):
    def make(reduce_fn):
        def fn(api, args, grid, step, tenant):
            series = _series_args(api, args, grid, step, tenant)
            if not series:
                return []
            m = np.vstack([s.values for s in series])
            with np.errstate(all="ignore"):
                vals = reduce_fn(m)
                vals = np.where(np.isnan(m).all(axis=0), np.nan, vals)
            label = name_fmt.format(
                ",".join(s.path_expr or s.name for s in series))
            return [GraphiteSeries(label, {"name": label}, grid, vals)]
        return fn
    return make


def _per_series(fn_vals, rename=None):
    def fn(api, args, grid, step, tenant):
        series = _series_args(api, args, grid, step, tenant)
        extra = _scalars(args)
        out = []
        for s in series:
            with np.errstate(all="ignore"):
                vals = fn_vals(s.values, grid, step, *extra)
            name = rename(s.name, *extra) if rename else s.name
            out.append(GraphiteSeries(name, s.tags, grid, vals,
                                      s.path_expr))
        return out
    return fn


def _f_alias(api, args, grid, step, tenant):
    series = _series_args(api, args, grid, step, tenant)
    name = (_strings(args) or [""])[0]
    return [GraphiteSeries(name, s.tags, grid, s.values, s.path_expr)
            for s in series]


def _f_alias_by_node(api, args, grid, step, tenant):
    series = _series_args(api, args, grid, step, tenant)
    nodes = [int(v) for v in _scalars(args)]
    out = []
    for s in series:
        segs = s.name.split(".")
        name = ".".join(segs[n] for n in nodes
                        if -len(segs) <= n < len(segs))
        out.append(GraphiteSeries(name, s.tags, grid, s.values,
                                  s.path_expr))
    return out


def _f_group_by_node(api, args, grid, step, tenant):
    series = _series_args(api, args, grid, step, tenant)
    nums = _scalars(args)
    node = int(nums[0]) if nums else 0
    agg = (_strings(args) or ["avg"])[0]
    groups: dict[str, list] = {}
    for s in series:
        segs = s.name.split(".")
        key = segs[node] if -len(segs) <= node < len(segs) else ""
        groups.setdefault(key, []).append(s)
    red = {"sum": np.nansum, "avg": np.nanmean, "average": np.nanmean,
           "min": np.nanmin, "max": np.nanmax}.get(agg, np.nanmean)
    out = []
    for key, members in sorted(groups.items()):
        m = np.vstack([s.values for s in members])
        with np.errstate(all="ignore"):
            vals = red(m, axis=0)
        out.append(GraphiteSeries(key, {"name": key}, grid, vals))
    return out


def _f_summarize(api, args, grid, step, tenant):
    series = _series_args(api, args, grid, step, tenant)
    interval_s = 60
    strs = _strings(args)
    if strs:
        m = _REL_RE.match("-" + strs[0])
        if m:
            interval_s = int(m.group(1)) * _UNIT_S[m.group(2)]
    agg = strs[1] if len(strs) > 1 else "sum"
    red = {"sum": np.nansum, "avg": np.nanmean, "max": np.nanmax,
           "min": np.nanmin, "last": lambda a, axis: a[..., -1]}.get(
               agg, np.nansum)
    win = max(int(interval_s * 1000 // step), 1)
    out = []
    for s in series:
        vals = np.full(grid.size, np.nan)
        for i in range(0, grid.size, win):
            w = s.values[i:i + win]
            if not np.isnan(w).all():
                with np.errstate(all="ignore"):
                    vals[i:i + win] = red(w[None, :], axis=1)[0] \
                        if agg != "last" else w[~np.isnan(w)][-1]
        out.append(GraphiteSeries(
            f'summarize({s.name}, "{strs[0] if strs else "1min"}", "{agg}")',
            s.tags, grid, vals, s.path_expr))
    return out


def _nn_derivative(vals, grid, step, *extra):
    d = np.diff(vals, prepend=np.nan)
    return np.where(d >= 0, d, np.nan)


def _per_second(vals, grid, step, *extra):
    d = np.diff(vals, prepend=np.nan)
    return np.where(d >= 0, d / (step / 1000.0), np.nan)


def _keep_last(vals, grid, step, *extra):
    out = vals.copy()
    last = np.nan
    for i in range(out.size):
        if math.isnan(out[i]):
            out[i] = last
        else:
            last = out[i]
    return out


_G_FUNCS = {
    "sumSeries": _combine("sumSeries({})")(
        lambda m: np.nansum(m, axis=0)),
    "sum": _combine("sumSeries({})")(lambda m: np.nansum(m, axis=0)),
    "averageSeries": _combine("averageSeries({})")(
        lambda m: np.nanmean(m, axis=0)),
    "avg": _combine("averageSeries({})")(lambda m: np.nanmean(m, axis=0)),
    "maxSeries": _combine("maxSeries({})")(
        lambda m: np.nanmax(m, axis=0)),
    "minSeries": _combine("minSeries({})")(
        lambda m: np.nanmin(m, axis=0)),
    "alias": _f_alias,
    "aliasByNode": _f_alias_by_node,
    "aliasByTags": _f_alias_by_node,
    "groupByNode": _f_group_by_node,
    "scale": _per_series(lambda v, g, st, k=1.0: v * k,
                         rename=lambda n, k=1.0: f"scale({n},{k:g})"),
    "offset": _per_series(lambda v, g, st, k=0.0: v + k,
                          rename=lambda n, k=0.0: f"offset({n},{k:g})"),
    "absolute": _per_series(lambda v, g, st: np.abs(v)),
    "derivative": _per_series(
        lambda v, g, st: np.diff(v, prepend=np.nan)),
    "nonNegativeDerivative": _per_series(_nn_derivative),
    "perSecond": _per_series(_per_second),
    "keepLastValue": _per_series(_keep_last),
    "summarize": _f_summarize,
    "seriesByTag": None,  # replaced below (needs filter semantics)
}


def _f_series_by_tag(api, args, grid, step, tenant):
    filters = [_tag_expr_filter(sv) for sv in _strings(args)]
    return _fetch_aligned(api.storage, filters, grid, step, tenant)


def _fetch_aligned(storage, filters, grid, step, tenant, path_expr=""):
    """Fetch + last-value-in-bucket consolidation onto the render grid
    (shared by path-glob fetch and seriesByTag)."""
    frm, until = int(grid[0]), int(grid[-1])
    series = storage.search_series(filters, frm - step, until,
                                   tenant=tenant)
    out = []
    for sd in series:
        vals = np.full(grid.size, np.nan)
        idx = np.searchsorted(sd.timestamps, grid, side="right") - 1
        ok = idx >= 0
        if ok.any():
            got = sd.values[np.clip(idx, 0, None)]
            age = grid - sd.timestamps[np.clip(idx, 0, None)]
            ok &= age < step  # only samples within the bucket
            vals[ok] = got[ok]
        name = sd.metric_name.metric_group.decode("utf-8", "replace")
        tags = {k.decode(): v.decode() for k, v in sd.metric_name.labels}
        tags["name"] = name
        out.append(GraphiteSeries(name, tags, grid, vals, path_expr))
    return out


def _f_alias_by_tags(api, args, grid, step, tenant):
    series = _series_args(api, args, grid, step, tenant)
    tag_names = _strings(args)
    out = []
    for s in series:
        name = ".".join(s.tags.get(t, "") for t in tag_names) or s.name
        out.append(GraphiteSeries(name, s.tags, grid, s.values,
                                  s.path_expr))
    return out


_G_FUNCS["seriesByTag"] = _f_series_by_tag

# the wide function library (graphite_funcs.py) registers itself on top
from . import graphite_funcs as _graphite_funcs  # noqa: E402

_graphite_funcs.register(_G_FUNCS, __import__(
    "sys").modules[__name__])
_G_FUNCS["aliasByTags"] = _f_alias_by_tags
