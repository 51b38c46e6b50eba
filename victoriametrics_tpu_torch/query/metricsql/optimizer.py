"""Common-filter pushdown optimizer (reference metricsql optimizer.go:16
``Optimize``): adds missing label filters to both sides of binary
operations — ``foo{a="x"} + bar`` becomes ``foo{a="x"} + bar{a="x"}`` —
so every selector under a binary op fetches only the series that can
survive the label-matched join.  A storage-traffic reduction that feeds
the shared-selector materialization plane: fewer series fetched per
distinct expression means cheaper streams for everyone subscribed.

Soundness rules mirror the reference:

- pushdown applies per binary op, using the COMMON label filters of the
  op's result (``getCommonLabelFilters``): the union of both sides'
  filters for label-matched ops, the left side only for
  ``unless``/``ifnot``/``default`` (the right side never shapes the
  result's series set), the intersection for ``or`` (either side alone
  may produce a result series);
- ``on (...)`` / ``ignoring (...)`` modifiers trim the pushed filters to
  labels that actually participate in the match; ``group_left``/
  ``group_right`` keep only the "one" side's filters;
- aggregations propagate filters through ``by (...)``/``without (...)``
  the same way; a modifier-less aggregation blocks propagation (its
  output drops all labels);
- ``__name__`` filters never push (they name the OTHER metric);
- label-manipulating transforms (``label_set``, ``label_replace``, ...)
  and series-shape functions (``absent*``, ``scalar``, ``vector``, ...)
  block propagation through themselves.

``optimize()`` deep-copies before mutating — parse results may share
nodes (WITH-template expansion).  ``VM_MQL_OPTIMIZE=0`` disables the
pass at the ``parse_cached`` seam (escape hatch AND equality oracle:
optimized and unoptimized evaluations must return identical rows).

The port's copy of ``victoriametrics_tpu/query/metricsql/optimizer.py``, whole.
"""

from __future__ import annotations

import copy

from .ast import (AggrFuncExpr, BinaryOpExpr, Expr, FuncExpr, LabelFilter,
                  MetricExpr, RollupExpr)

#: transforms that rewrite labels: filters must not cross them in either
#: direction (a filter valid on the output may not hold on the input)
_LABEL_MANIPULATION_FUNCS = frozenset((
    "alias", "drop_common_labels", "label_copy", "label_del",
    "label_graphite_group", "label_join", "label_keep", "label_lowercase",
    "label_map", "label_match", "label_mismatch", "label_move",
    "label_replace", "label_set", "label_transform", "label_uppercase",
    "label_value",
))

#: transforms whose output series set is unrelated to any selector arg
_OPAQUE_TRANSFORMS = frozenset((
    "", "absent", "scalar", "union", "vector", "range_normalize",
    "end", "now", "pi", "ru", "start", "step", "time",
    "count_values_over_time",
))


def _is_rollup_func(name: str) -> bool:
    from ..rollup_funcs import GENERIC_FUNCS, MULTI_FUNCS, ORACLE_FUNCS
    return (name in ORACLE_FUNCS or name in GENERIC_FUNCS
            or name in MULTI_FUNCS)


def _func_arg_idx(name: str, nargs: int) -> int:
    """Index of the series arg filters may cross, or -1 (reference
    ``getFuncArgIdxForOptimization``)."""
    name = name.lower()
    if _is_rollup_func(name):
        if name == "absent_over_time":
            return -1
        if name in ("quantile_over_time", "aggr_over_time",
                    "hoeffding_bound_lower", "hoeffding_bound_upper"):
            return 1
        if name == "quantiles_over_time":
            return nargs - 1
        return 0
    if name in _LABEL_MANIPULATION_FUNCS or name in _OPAQUE_TRANSFORMS:
        return -1
    if name == "limit_offset":
        return 2
    if name in ("buckets_limit", "histogram_quantile", "histogram_share",
                "range_quantile"):
        return 1
    if name == "histogram_quantiles":
        return nargs - 1
    return 0


_LAST_ARG_AGGRS = frozenset((
    "bottomk", "bottomk_avg", "bottomk_max", "bottomk_median",
    "bottomk_min", "bottomk_last", "limitk", "outliers_iqr", "outliersk",
    "quantile", "topk", "topk_avg", "topk_max", "topk_median", "topk_min",
    "topk_last",
))


def _aggr_arg_idx(name: str, nargs: int) -> int:
    """Index of an aggregation's series arg (reference
    ``getAggrArgIdxForOptimization``): scalar-first aggrs take the last
    arg; ``count_values`` relabels and blocks propagation."""
    name = name.lower()
    if name in _LAST_ARG_AGGRS:
        return nargs - 1
    if name == "count_values":
        return -1
    return 0


def _series_arg(e) -> Expr | None:
    if isinstance(e, AggrFuncExpr):
        idx = _aggr_arg_idx(e.name, len(e.args))
    else:
        idx = _func_arg_idx(e.name, len(e.args))
    if idx < 0 or idx >= len(e.args):
        return None
    return e.args[idx]


def _fkey(f: LabelFilter) -> tuple:
    return (f.label, f.value, f.is_negative, f.is_regexp)


def _intersect(a: list[LabelFilter], b: list[LabelFilter]):
    keys = {_fkey(f) for f in b}
    return [f for f in a if _fkey(f) in keys]


def _union(a: list[LabelFilter], b: list[LabelFilter]):
    out = list(a)
    keys = {_fkey(f) for f in a}
    for f in b:
        if _fkey(f) not in keys:
            keys.add(_fkey(f))
            out.append(f)
    return out


def _trim_on(lfs: list[LabelFilter], labels: list[str]):
    keep = set(labels)
    return [f for f in lfs if f.label in keep]


def _trim_ignoring(lfs: list[LabelFilter], labels: list[str]):
    drop = set(labels)
    return [f for f in lfs if f.label not in drop]


def _trim_by_group_modifier(lfs, be: BinaryOpExpr):
    op = be.group_modifier.op.lower()
    if op == "on":
        return _trim_on(lfs, be.group_modifier.args)
    if op == "ignoring":
        return _trim_ignoring(lfs, be.group_modifier.args)
    return lfs


def _trim_by_aggr_modifier(lfs, ae: AggrFuncExpr):
    if ae.without:
        return _trim_ignoring(lfs, ae.grouping)
    if ae.grouping:
        return _trim_on(lfs, ae.grouping)
    # modifier-less aggregation: every label is dropped from the output
    return []


def _common_filters(e: Expr) -> list[LabelFilter]:
    """Label filters every output series of `e` is known to satisfy
    (``__name__`` excluded)."""
    if isinstance(e, MetricExpr):
        sets = e.filter_sets()
        lfs = [f for f in sets[0] if f.label != "__name__"]
        for fs in sets[1:]:
            lfs = _intersect(lfs, [f for f in fs if f.label != "__name__"])
        return lfs
    if isinstance(e, RollupExpr):
        return _common_filters(e.expr)
    if isinstance(e, AggrFuncExpr):
        arg = _series_arg(e)
        if arg is None:
            return []
        return _trim_by_aggr_modifier(_common_filters(arg), e)
    if isinstance(e, FuncExpr):
        arg = _series_arg(e)
        if arg is None:
            return []
        return _common_filters(arg)
    if isinstance(e, BinaryOpExpr):
        left = _common_filters(e.left)
        right = _common_filters(e.right)
        op = e.op.lower()
        if op == "or":
            lfs = _intersect(left, right)
        elif op in ("unless", "ifnot", "default"):
            lfs = left if not e.join_modifier.op else []
        else:
            jm = e.join_modifier.op.lower()
            if jm == "group_left":
                lfs = left
            elif jm == "group_right":
                lfs = right
            else:
                lfs = _union(left, right)
        return _trim_by_group_modifier(lfs, e)
    return []


def _sort_filters(fs: list[LabelFilter]) -> list[LabelFilter]:
    """Canonical order for a mutated set: the literal name filter stays
    first (the parser puts it there and ``__str__``/name-resolution rely
    on it), everything else sorts by (label, value, op)."""
    head: list[LabelFilter] = []
    rest = fs
    if fs and fs[0].label == "__name__":
        head, rest = fs[:1], fs[1:]
    return head + sorted(
        rest, key=lambda f: (f.label, f.value, f.is_negative, f.is_regexp))


def _pushdown(e: Expr, lfs: list[LabelFilter]) -> None:
    if not lfs:
        return
    if isinstance(e, MetricExpr):
        sets = [e.label_filters] + e.or_sets if e.or_sets \
            else [e.label_filters]
        new_sets = []
        for fs in sets:
            have = {_fkey(f) for f in fs}
            add = [copy.copy(f) for f in lfs if _fkey(f) not in have]
            new_sets.append(_sort_filters(fs + add) if add else fs)
        e.label_filters = new_sets[0]
        if e.or_sets:
            e.or_sets = new_sets[1:]
        return
    if isinstance(e, RollupExpr):
        _pushdown(e.expr, lfs)
        return
    if isinstance(e, AggrFuncExpr):
        lfs = _trim_by_aggr_modifier(lfs, e)
        arg = _series_arg(e)
        if arg is not None:
            _pushdown(arg, lfs)
        return
    if isinstance(e, FuncExpr):
        arg = _series_arg(e)
        if arg is not None:
            _pushdown(arg, lfs)
        return
    if isinstance(e, BinaryOpExpr):
        # both sides take the filters for EVERY op: the asymmetry lives
        # entirely in _common_filters (what may be claimed of the
        # result).  Pushing result filters into the subtractive side of
        # unless/ifnot/default is sound — a right-side series only
        # matters where its labels match a surviving left-side series,
        # which satisfies the filters by construction.
        lfs = _trim_by_group_modifier(lfs, e)
        _pushdown(e.left, lfs)
        _pushdown(e.right, lfs)
        return


def _optimize_inplace(e: Expr) -> None:
    if isinstance(e, RollupExpr):
        _optimize_inplace(e.expr)
        return
    if isinstance(e, (FuncExpr, AggrFuncExpr)):
        for a in e.args:
            _optimize_inplace(a)
        return
    if isinstance(e, BinaryOpExpr):
        _optimize_inplace(e.left)
        _optimize_inplace(e.right)
        lfs = _common_filters(e)
        _pushdown(e, lfs)
        return


def _can_optimize(e: Expr) -> bool:
    if isinstance(e, BinaryOpExpr):
        return True
    if isinstance(e, RollupExpr):
        return _can_optimize(e.expr)
    if isinstance(e, (FuncExpr, AggrFuncExpr)):
        return any(_can_optimize(a) for a in e.args)
    return False


def optimize(e: Expr) -> Expr:
    """Returns `e` with common label filters pushed across binary ops;
    the input AST is never mutated (a deep copy is optimized in place —
    parse results may share nodes via WITH-template expansion)."""
    if not _can_optimize(e):
        return e
    out = copy.deepcopy(e)
    _optimize_inplace(out)
    return out
