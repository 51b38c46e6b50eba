"""The MetricsQL evaluator's selector and shape helpers (reference
app/vmselect/promql/eval.go).

The port's copy of the parts of ``victoriametrics_tpu/query/eval.py`` that
the fleet and the device dispatch read: ``QueryError``, the selector's
storage filters (``filters_from_metric_expr``) and the fusable-shape
analysis (``_device_aggr_shape``).  The evaluator itself (``eval_expr``
and the rest of the module) comes with the evaluator item of the roadmap.
"""

from __future__ import annotations

from ..storage.tag_filters import TagFilter
from .metricsql.ast import (AggrFuncExpr, FuncExpr, MetricExpr, NumberExpr,
                            RollupExpr)


class QueryError(ValueError):
    pass


def _tag_filters(fs) -> list[TagFilter]:
    out = []
    for f in fs:
        key = b"" if f.label == "__name__" else f.label.encode()
        out.append(TagFilter(key, f.value.encode(), negate=f.is_negative,
                             regex=f.is_regexp))
    return out


def filter_sets_from_metric_expr(me: MetricExpr) -> list[list[TagFilter]]:
    """All OR'd filter sets of a selector as storage TagFilter lists."""
    return [_tag_filters(fs) for fs in me.filter_sets()]


def filters_from_metric_expr(me: MetricExpr, storage=None):
    """Storage-facing filters for a selector: a plain list[TagFilter] for
    the common single-set case; a list of filter SETS for `{a="b" or
    c="d"}` selectors (plain Storage unions them at the tsid level —
    supports_filter_union).  Backends without union support fail loudly
    instead of silently matching only the first set."""
    sets = filter_sets_from_metric_expr(me)
    if len(sets) == 1:
        return sets[0]
    if storage is not None and \
            not getattr(storage, "supports_filter_union", False):
        raise QueryError(
            "selector-level `or` filters are not supported by this "
            "storage backend yet; rewrite the query as `expr_a or expr_b`")
    return sets


_FUSED_AGGR_NAMES = ("sum", "count", "avg", "min", "max", "stddev",
                     "stdvar", "group")


def _device_aggr_shape(ae: AggrFuncExpr):
    """(phi, func, rollup-arg) of a device-fusable aggr(rollup(selector))
    expression, or None when the shape can't fuse (shared by the fused
    dispatch and the serving layer's residency-readiness probe)."""
    phi = None
    if ae.name in ("quantile", "median"):
        # quantile(phi, q) fuses when phi is a literal; median = 0.5
        if ae.name == "quantile":
            if len(ae.args) != 2 or not isinstance(ae.args[0], NumberExpr):
                return None
            phi = float(ae.args[0].value)
            arg = ae.args[1]
        else:
            if len(ae.args) != 1:
                return None
            phi = 0.5
            arg = ae.args[0]
    elif len(ae.args) != 1 or ae.name not in _FUSED_AGGR_NAMES:
        return None
    else:
        arg = ae.args[0]
    if isinstance(arg, FuncExpr):
        if len(arg.args) != 1 or arg.keep_metric_names:
            return None
        func, rarg = arg.name, arg.args[0]
    elif isinstance(arg, (MetricExpr, RollupExpr)):
        func, rarg = "default_rollup", arg
    else:
        return None
    if isinstance(rarg, MetricExpr):
        rarg = RollupExpr(expr=rarg)
    if not isinstance(rarg, RollupExpr) or \
            not isinstance(rarg.expr, MetricExpr) or rarg.expr.is_empty() or \
            rarg.needs_subquery() or rarg.at is not None:
        return None
    return phi, func, rarg
