"""MetricsQL AST (semantics of the vendored metricsql package's Expr types,
parser.go:1877-2299 — re-designed as plain Python dataclasses).

All expressions render back to canonical query strings via str(); the
canonical form is also the rollup-result-cache key.

The port's copy of ``victoriametrics_tpu/query/metricsql/ast.py``, whole.
"""

from __future__ import annotations

import dataclasses


class Expr:
    def __str__(self) -> str:  # pragma: no cover - overridden
        raise NotImplementedError


@dataclasses.dataclass
class NumberExpr(Expr):
    value: float

    def __str__(self):
        v = self.value
        if v != v:
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)


@dataclasses.dataclass
class StringExpr(Expr):
    value: str

    def __str__(self):
        return '"' + self.value.replace("\\", "\\\\").replace('"', '\\"') + '"'


@dataclasses.dataclass
class DurationExpr(Expr):
    """Duration in milliseconds; step-relative if `step_based` (e.g. "5i")."""
    ms: float
    step_based: bool = False
    text: str = ""

    def value_ms(self, step_ms: int) -> int:
        return int(self.ms * step_ms) if self.step_based else int(self.ms)

    def __str__(self):
        return self.text or f"{int(self.ms)}ms"


@dataclasses.dataclass
class LabelFilter:
    label: str          # "__name__" for the metric name
    value: str
    is_negative: bool = False
    is_regexp: bool = False

    def op(self) -> str:
        return {(False, False): "=", (True, False): "!=",
                (False, True): "=~", (True, True): "!~"}[
            (self.is_negative, self.is_regexp)]

    def __str__(self):
        v = self.value.replace("\\", "\\\\").replace('"', '\\"')
        return f'{self.label}{self.op()}"{v}"'


@dataclasses.dataclass
class MetricExpr(Expr):
    label_filters: list[LabelFilter] = dataclasses.field(default_factory=list)
    # additional OR'd filter sets: `{a="b" or c="d"}` parses into
    # label_filters=[a="b"], or_sets=[[c="d"]] — the reference metricsql's
    # labelFilterss union (selectors match series satisfying ANY set)
    or_sets: list[list[LabelFilter]] = dataclasses.field(
        default_factory=list)

    @property
    def metric_name(self) -> str | None:
        for f in self.label_filters:
            if f.label == "__name__" and not f.is_negative and not f.is_regexp:
                return f.value
        return None

    def filter_sets(self) -> list[list[LabelFilter]]:
        """All OR'd filter sets (always >= 1; single-set selectors return
        [label_filters])."""
        if not self.or_sets:
            return [self.label_filters]
        return [self.label_filters] + self.or_sets

    def is_empty(self) -> bool:
        return not self.label_filters and not self.or_sets

    @staticmethod
    def _literal_name(fs: list[LabelFilter]) -> str | None:
        if fs and fs[0].label == "__name__" and not fs[0].is_negative \
                and not fs[0].is_regexp:
            return fs[0].value
        return None

    def __str__(self):
        sets = self.filter_sets()
        if len(sets) > 1:
            # shared leading literal name renders once: foo{a="b" or c="d"}
            # — but only when every set keeps at least one more filter (a
            # name-only set would render a dangling ` or ` that can't
            # re-parse; such selectors take the general form below)
            name = self._literal_name(sets[0])
            if name is not None and all(
                    self._literal_name(fs) == name and len(fs) > 1
                    for fs in sets):
                body = " or ".join(
                    ", ".join(str(f) for f in fs[1:]) for fs in sets)
                return name + "{" + body + "}"
            return "{" + " or ".join(
                ", ".join(str(f) for f in fs) for fs in sets) + "}"
        name = self.metric_name
        rest = [f for f in self.label_filters
                if not (f.label == "__name__" and not f.is_negative
                        and not f.is_regexp and f.value == name)]
        body = ", ".join(str(f) for f in rest)
        if name is not None:
            return name + (f"{{{body}}}" if body else "")
        return f"{{{body}}}"


@dataclasses.dataclass
class RollupExpr(Expr):
    """expr[window:step] offset o @ at, e.g. m[5m] or (q)[1h:5m] offset 1d."""
    expr: Expr
    window: DurationExpr | None = None
    step: DurationExpr | None = None      # subquery step
    offset: DurationExpr | None = None
    at: Expr | None = None
    inherit_step: bool = False            # trailing ":" as in q[1h:]

    def needs_subquery(self) -> bool:
        return self.step is not None or self.inherit_step or not isinstance(
            self.expr, MetricExpr)

    def __str__(self):
        s = str(self.expr)
        if not isinstance(self.expr, (MetricExpr, FuncExpr)) and not (
                isinstance(self.expr, RollupExpr)):
            s = f"({s})"
        if self.window is not None or self.step is not None or self.inherit_step:
            w = str(self.window) if self.window is not None else ""
            if self.step is not None:
                s += f"[{w}:{self.step}]"
            elif self.inherit_step:
                s += f"[{w}:]"
            else:
                s += f"[{w}]"
        if self.offset is not None:
            s += f" offset {self.offset}"
        if self.at is not None:
            s += f" @ ({self.at})"
        return s


@dataclasses.dataclass
class FuncExpr(Expr):
    name: str
    args: list[Expr] = dataclasses.field(default_factory=list)
    keep_metric_names: bool = False

    def __str__(self):
        s = f"{self.name}({', '.join(str(a) for a in self.args)})"
        if self.keep_metric_names:
            s += " keep_metric_names"
        return s


@dataclasses.dataclass
class AggrFuncExpr(Expr):
    name: str
    args: list[Expr] = dataclasses.field(default_factory=list)
    grouping: list[str] = dataclasses.field(default_factory=list)
    without: bool = False
    limit: int = 0

    def __str__(self):
        s = f"{self.name}({', '.join(str(a) for a in self.args)})"
        if self.grouping or self.without:
            kw = "without" if self.without else "by"
            s += f" {kw} ({', '.join(self.grouping)})"
        if self.limit:
            s += f" limit {self.limit}"
        return s


@dataclasses.dataclass
class ModifierExpr:
    op: str = ""                      # on | ignoring | group_left | group_right
    args: list[str] = dataclasses.field(default_factory=list)
    prefix: str = ""                  # group_left(...) prefix "p" join prefix


@dataclasses.dataclass
class BinaryOpExpr(Expr):
    op: str
    left: Expr = None
    right: Expr = None
    bool_modifier: bool = False
    group_modifier: ModifierExpr = dataclasses.field(default_factory=ModifierExpr)
    join_modifier: ModifierExpr = dataclasses.field(default_factory=ModifierExpr)
    join_modifier_prefix: str | None = None
    keep_metric_names: bool = False

    def __str__(self):
        parts = [self._wrap(self.left), self.op]
        if self.bool_modifier:
            parts.append("bool")
        if self.group_modifier.op:
            parts.append(
                f"{self.group_modifier.op} ({', '.join(self.group_modifier.args)})")
        if self.join_modifier.op:
            jm = f"{self.join_modifier.op} ({', '.join(self.join_modifier.args)})"
            parts.append(jm)
        parts.append(self._wrap(self.right))
        return " ".join(parts)

    def _wrap(self, e: Expr) -> str:
        if isinstance(e, BinaryOpExpr):
            return f"({e})"
        return str(e)


@dataclasses.dataclass
class WithExpr(Expr):
    """WITH (a = expr, ...) body — expanded away at parse time; kept only for
    error reporting."""
    was: list
    expr: Expr

    def __str__(self):
        return str(self.expr)
