"""MetricsQL lexer + recursive-descent parser.

Grammar semantics follow the vendored metricsql package (parser.go:15,
lexer.go): full PromQL plus the MetricsQL extensions used in practice —
`default`/`if`/`ifnot` binary ops, duration literals as scalars, step-based
durations (`5i`), numeric suffixes (Ki/Mi/...), bare-number windows
(seconds), `keep_metric_names`, `limit N` on aggregates, WITH-expression
templates, `@` modifier, subqueries `[1h:5m]`.

The port's copy of ``victoriametrics_tpu/query/metricsql/parser.py``, whole.
"""

from __future__ import annotations

import re

from .ast import (AggrFuncExpr, BinaryOpExpr, DurationExpr, Expr, FuncExpr,
                  LabelFilter, MetricExpr, ModifierExpr, NumberExpr,
                  RollupExpr, StringExpr, WithExpr)


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

# no leading ":" — it would swallow the subquery separator in "[1h:1m]"
_IDENT_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_:.]*")
_DURATION_RE = re.compile(
    r"(?:\d+(?:\.\d+)?(?:[mM][sS]|[smhdwyiSMHDWYI]))+")
# Numeric size suffixes are uppercase only (K/M/G/T, Ki/Mi/...): lowercase
# m/s/h/d/w/y are duration units and must stay distinct ("5m" = 5 minutes).
_NUMBER_RE = re.compile(
    r"0[xX][0-9a-fA-F]+|0[bB][01]+|0[oO][0-7]+"
    r"|(?:\d[\d_]*(?:\.[\d_]*)?|\.\d[\d_]*)(?:[eE][+-]?\d+)?"
    r"(?:[KMGT]i?B?)?")
_OPS = ["==", "!=", ">=", "<=", "=~", "!~", "+", "-", "*", "/", "%", "^",
        ">", "<", "=", "(", ")", "{", "}", "[", "]", ",", "@", ":"]

_SUFFIX = {"K": 1e3, "Ki": 1024.0, "M": 1e6, "Mi": 1024.0 ** 2,
           "G": 1e9, "Gi": 1024.0 ** 3, "T": 1e12, "Ti": 1024.0 ** 4}

_DUR_UNIT_MS = {"ms": 1.0, "s": 1e3, "m": 60e3, "h": 3600e3, "d": 86400e3,
                "w": 7 * 86400e3, "y": 365 * 86400e3}


class Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind      # ident|number|duration|string|op|eof
        self.text = text
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind}, {self.text!r})"


def tokenize(q: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(q)
    while i < n:
        c = q[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":
            while i < n and q[i] != "\n":
                i += 1
            continue
        if c in "\"'":
            j = i + 1
            buf = []
            while j < n and q[j] != c:
                if q[j] == "\\" and j + 1 < n:
                    esc = q[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", '"': '"', "'": "'"}.get(esc, "\\" + esc))
                    j += 2
                else:
                    buf.append(q[j])
                    j += 1
            if j >= n:
                raise ParseError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and q[i + 1].isdigit()):
            m = _DURATION_RE.match(q, i)
            # duration wins only if it consumes more than the bare number
            nm = _NUMBER_RE.match(q, i)
            if m and (not nm or m.end() > nm.end()):
                toks.append(Token("duration", m.group(0), i))
                i = m.end()
                continue
            if nm:
                toks.append(Token("number", nm.group(0), i))
                i = nm.end()
                continue
        im = _IDENT_RE.match(q, i)
        if im:
            toks.append(Token("ident", im.group(0), i))
            i = im.end()
            continue
        for op in _OPS:
            if q.startswith(op, i):
                toks.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise ParseError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks


def parse_number(text: str) -> float:
    text = text.replace("_", "")
    low = text.lower()
    if low.startswith("0x"):
        return float(int(text, 16))
    if low.startswith("0b"):
        return float(int(text, 2))
    if low.startswith("0o"):
        return float(int(text, 8))
    if text.endswith("B"):
        text = text[:-1]
    for suf in ("Ki", "Mi", "Gi", "Ti"):
        if text.endswith(suf):
            return float(text[:-2]) * _SUFFIX[suf]
    if text and text[-1] in "KMGT":
        return float(text[:-1]) * _SUFFIX[text[-1]]
    return float(text)


def parse_duration_ms(text: str) -> tuple[float, bool]:
    """Returns (ms, step_based). Units are case-insensitive except the
    number/size ambiguity handled by the lexer."""
    if text.endswith(("i", "I")) and not text.lower().endswith("mi"):
        # step-based like 5i (possibly fractional)
        return float(text[:-1]), True
    total = 0.0
    for num, unit in re.findall(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)",
                                text.lower()):
        total += float(num) * _DUR_UNIT_MS[unit]
    return total, False


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

AGGR_FUNC_NAMES = frozenset("""
sum min max avg stddev stdvar count count_values bottomk topk quantile
quantiles group median mode limitk distinct sum2 geomean histogram any
topk_min topk_max topk_avg topk_median topk_last bottomk_min bottomk_max
bottomk_avg bottomk_median bottomk_last outliersk outliers_mad outliers_iqr
zscore share mad iqr
""".split())

_RIGHT_ASSOC = {"^"}

# precedence levels, low to high
_BINOPS = [
    {"or", "default", "if", "ifnot"},
    {"and", "unless"},
    {"==", "!=", ">", "<", ">=", "<="},
    {"+", "-"},
    {"*", "/", "%", "atan2"},
    {"^"},
]
_ALL_BINOPS = set().union(*_BINOPS)


class Parser:
    def __init__(self, q: str):
        self.toks = tokenize(q)
        self.i = 0
        self.with_scopes: list[dict[str, tuple[list[str], Expr]]] = [
            _default_with_scope()]

    # -- token helpers -------------------------------------------------

    @property
    def tok(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op: str):
        t = self.next()
        if t.kind != "op" or t.text != op:
            raise ParseError(f"expected {op!r}, got {t.text!r} at {t.pos}")

    def at_op(self, *ops) -> bool:
        return self.tok.kind == "op" and self.tok.text in ops

    def at_keyword(self, *kws) -> bool:
        return self.tok.kind == "ident" and self.tok.text.lower() in kws

    # -- entry ----------------------------------------------------------

    def parse(self) -> Expr:
        e = self.parse_expr(0)
        if self.tok.kind != "eof":
            raise ParseError(f"unexpected {self.tok.text!r} at {self.tok.pos}")
        return e

    def parse_expr(self, level: int = 0) -> Expr:
        if level >= len(_BINOPS):
            return self.parse_unary()
        left = self.parse_expr(level + 1)
        while True:
            op = None
            if self.at_op(*_BINOPS[level]):
                op = self.next().text
            elif self.tok.kind == "ident" and \
                    self.tok.text.lower() in _BINOPS[level]:
                op = self.next().text.lower()
            if op is None:
                return left
            be = BinaryOpExpr(op=op, left=left)
            if self.at_keyword("bool"):
                self.next()
                be.bool_modifier = True
            if self.at_keyword("on", "ignoring"):
                be.group_modifier = ModifierExpr(self.next().text.lower(),
                                                 self.parse_ident_list())
            if self.at_keyword("group_left", "group_right"):
                kw = self.next().text.lower()
                args = []
                if self.at_op("("):
                    args = self.parse_ident_list(allow_star=True)
                be.join_modifier = ModifierExpr(kw, args)
                if self.at_keyword("prefix"):
                    # group_left(...) prefix "p": copied join tags get the
                    # prefix (Go parser.go:393 JoinModifierPrefix)
                    self.next()
                    t = self.next()
                    if t.kind != "string":
                        raise ParseError(
                            f"prefix needs a string at {t.pos}")
                    be.join_modifier.prefix = t.text
            if op in _RIGHT_ASSOC:
                be.right = self.parse_expr(level)  # right-assoc
            else:
                be.right = self.parse_expr(level + 1)
            # keep_metric_names after the right operand attaches to the
            # BINOP (Go metricsql parser.go:410); a real function call
            # consumes its own flag before we get here (parser.go:1210)
            if self.at_keyword("keep_metric_names"):
                self.next()
                be.keep_metric_names = True
            left = be
        # unreachable

    def parse_unary(self) -> Expr:
        if self.at_op("-"):
            self.next()
            # unary minus binds looser than ^: -4^0.5 == -(4^0.5)
            arg = self.parse_expr(len(_BINOPS) - 1)
            if isinstance(arg, NumberExpr):
                return NumberExpr(-arg.value)
            e = BinaryOpExpr(op="*", left=NumberExpr(-1.0), right=arg)
            return self.parse_postfix(e)
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix(self.parse_primary())

    # -- postfix: [window[:step]], offset, @, keep_metric_names ----------

    def parse_postfix(self, e: Expr) -> Expr:
        if self.at_keyword("keep_metric_names"):
            # a real function call owns its flag (Go parser.go:1210); a
            # parenthesized binop too (parser.go:602); anything else
            # leaves the token for the enclosing binop (parser.go:410)
            parens = getattr(e, "_parens", False)
            if isinstance(e, FuncExpr) and not parens:
                self.next()
                e.keep_metric_names = True
            elif isinstance(e, BinaryOpExpr) and parens:
                self.next()
                e.keep_metric_names = True
            else:
                return e
        if self.at_op("[", "@") or self.at_keyword("offset"):
            return self._parse_rollup_suffix(e)
        return e

    def _parse_rollup_suffix(self, e: Expr) -> RollupExpr:
        """Go parser.go:1783 parseRollupExpr: a fixed SEQUENCE (not a loop) —
        optional [window[:step]], then optional `@`, then optional offset,
        then optionally a second `@` spot (duplicate `@` is an error). A
        suffix in any other order is left unconsumed and errors upstream."""
        re_ = RollupExpr(expr=e)
        if self.at_op("["):
            self.next()
            window = step = None
            inherit = False
            if not self.at_op(":"):
                window = self.parse_duration_token()
            if self.at_op(":"):
                self.next()
                if self.at_op("]"):
                    inherit = True
                else:
                    step = self.parse_duration_token()
            self.expect_op("]")
            re_.window, re_.step, re_.inherit_step = window, step, inherit
            if not (self.at_op("@") or self.at_keyword("offset")):
                return re_
        if self.at_op("@"):
            self.next()
            re_.at = self._parse_at_expr()
        if self.at_keyword("offset"):
            self.next()
            neg = False
            if self.at_op("-"):
                self.next()
                neg = True
            d = self.parse_duration_token()
            if neg:
                d = DurationExpr(-d.ms, d.step_based, "-" + d.text)
            re_.offset = d
        if self.at_op("@"):
            if re_.at is not None:
                raise ParseError("duplicate `@` token")
            self.next()
            re_.at = self._parse_at_expr()
        return re_

    def _parse_at_expr(self) -> Expr:
        # the at-expression takes no rollup suffixes: a trailing
        # `offset`/`[...]` binds to the OUTER rollup, so
        # `time() @ end() offset 10m` is (time() @ end()) offset 10m
        # (metricsql parser.go parseSingleExprWithoutRollupSuffix)
        if self.at_op("-"):
            self.next()
            prim = self.parse_primary()
            return (NumberExpr(-prim.value)
                    if isinstance(prim, NumberExpr) else
                    BinaryOpExpr(op="*", left=NumberExpr(-1.0), right=prim))
        return self.parse_primary()

    def parse_duration_token(self) -> DurationExpr:
        t = self.next()
        if t.kind == "duration":
            ms, step_based = parse_duration_ms(t.text)
            return DurationExpr(ms, step_based, t.text)
        if t.kind == "number":
            # bare number = seconds (MetricsQL extension)
            return DurationExpr(parse_number(t.text) * 1e3, False, t.text)
        if t.kind == "ident":
            # WITH-bound duration name
            resolved = self._resolve_with(t.text)
            if isinstance(resolved, DurationExpr):
                return resolved
            if isinstance(resolved, NumberExpr):
                return DurationExpr(resolved.value * 1e3, False, "")
        raise ParseError(f"expected duration, got {t.text!r} at {t.pos}")

    # -- primaries --------------------------------------------------------

    def parse_primary(self) -> Expr:
        t = self.tok
        if t.kind == "number":
            self.next()
            return NumberExpr(parse_number(t.text))
        if t.kind == "duration":
            self.next()
            ms, step_based = parse_duration_ms(t.text)
            return DurationExpr(ms, step_based, t.text)
        if t.kind == "string":
            self.next()
            return StringExpr(t.text)
        if t.kind == "op" and t.text == "(":
            self.next()
            if self.at_op(")"):
                # `()` is an empty union (exec_test.go `()` case)
                self.next()
                return FuncExpr(name="union", args=[])
            e = self.parse_expr(0)
            if self.at_op(","):
                # (e1, e2, ...) is union(e1, e2, ...) in MetricsQL
                exprs = [e]
                while self.at_op(","):
                    self.next()
                    if self.at_op(")"):
                        break
                    exprs.append(self.parse_expr(0))
                self.expect_op(")")
                u = FuncExpr(name="union", args=exprs)
                u._parens = True
                return u
            self.expect_op(")")
            e._parens = True
            return e
        if t.kind == "op" and t.text == "{":
            sets = self.parse_label_filters()
            return MetricExpr(label_filters=sets[0], or_sets=sets[1:])
        if t.kind == "ident":
            return self.parse_ident_expr()
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def parse_ident_expr(self) -> Expr:
        name = self.next().text
        low = name.lower()
        if low in ("nan",):
            return NumberExpr(float("nan"))
        if low in ("inf", "+inf"):
            return NumberExpr(float("inf"))
        if low == "with" and self.at_op("("):
            return self.parse_with_expr()

        # WITH-template reference?
        w = self._lookup_with(name)
        if w is not None:
            params, body = w
            if params:
                # function-like template
                self.expect_op("(")
                args = [self.parse_expr(0)]
                while self.at_op(","):
                    self.next()
                    args.append(self.parse_expr(0))
                self.expect_op(")")
                return _substitute(body, dict(zip(params, args)))
            return _clone(body)

        if self.at_op("("):
            if low in AGGR_FUNC_NAMES:
                ae = AggrFuncExpr(name=low)
                ae.args = self.parse_arg_list()
                self.parse_aggr_modifiers(ae)
                return ae
            fe = FuncExpr(name=low)
            fe.args = self.parse_arg_list()
            return fe
        if self.at_keyword("by", "without") and low in AGGR_FUNC_NAMES:
            # sum by (x) (q) form
            ae = AggrFuncExpr(name=low)
            self.parse_aggr_modifiers(ae)
            ae.args = self.parse_arg_list()
            # allow trailing modifiers too (limit)
            self.parse_aggr_modifiers(ae, allow_grouping=False)
            return ae
        # plain metric selector; the name distributes over every OR'd
        # filter set: foo{a="b" or c="d"} == {__name__="foo",a="b"} union
        # {__name__="foo",c="d"} (metricsql parser.go)
        if self.at_op("{"):
            sets = self.parse_label_filters()
            return MetricExpr(
                label_filters=[LabelFilter("__name__", name)] + sets[0],
                or_sets=[[LabelFilter("__name__", name)] + fs
                         for fs in sets[1:]])
        return MetricExpr(label_filters=[LabelFilter("__name__", name)])

    def parse_arg_list(self) -> list[Expr]:
        self.expect_op("(")
        args: list[Expr] = []
        if self.at_op(")"):
            self.next()
            return args
        args.append(self.parse_expr(0))
        while self.at_op(","):
            self.next()
            if self.at_op(")"):
                break
            args.append(self.parse_expr(0))
        self.expect_op(")")
        return args

    def parse_aggr_modifiers(self, ae: AggrFuncExpr, allow_grouping=True):
        while True:
            if allow_grouping and self.at_keyword("by", "without"):
                kw = self.next().text.lower()
                ae.grouping = self.parse_ident_list()
                ae.without = kw == "without"
            elif self.at_keyword("limit"):
                self.next()
                t = self.next()
                if t.kind != "number":
                    raise ParseError(f"expected number after limit at {t.pos}")
                ae.limit = int(parse_number(t.text))
            else:
                return

    def parse_ident_list(self, allow_star: bool = False) -> list[str]:
        self.expect_op("(")
        if allow_star and self.at_op("*"):
            # `*` is valid only in group_left(*)/group_right(*) and only as
            # the SOLE element: copy ALL tags from the one side
            # (Go parser.go parseIdentList allowStar, metric_name.go:318)
            self.next()
            self.expect_op(")")
            return ["*"]
        out = []
        while not self.at_op(")"):
            t = self.next()
            if t.kind not in ("ident", "string"):
                raise ParseError(f"expected label name at {t.pos}")
            out.append(t.text)
            if self.at_op(","):
                self.next()
        self.expect_op(")")
        return out

    def parse_label_filters(self) -> list[list[LabelFilter]]:
        """{f, f or f, f} -> list of OR'd filter sets (>= 1): the
        selector-level `or` (reference metricsql parser.go labelFilterss)
        separates complete filter sets; a series matches when ANY set
        matches.  A label literally named `or` still parses ({or="x"}):
        the keyword is only a separator BETWEEN filters."""
        self.expect_op("{")
        sets: list[list[LabelFilter]] = [[]]
        while not self.at_op("}"):
            t = self.next()
            if t.kind not in ("ident", "string"):
                raise ParseError(f"expected label name at {t.pos}")
            label = t.text
            op_t = self.next()
            if op_t.kind != "op" or op_t.text not in ("=", "!=", "=~", "!~"):
                raise ParseError(f"expected label op at {op_t.pos}")
            v = self.next()
            if v.kind != "string":
                # allow WITH-bound string/number
                if v.kind == "ident":
                    r = self._resolve_with(v.text)
                    if isinstance(r, StringExpr):
                        v = Token("string", r.value, v.pos)
                    else:
                        raise ParseError(f"expected string at {v.pos}")
                else:
                    raise ParseError(f"expected string at {v.pos}")
            sets[-1].append(LabelFilter(label, v.text,
                                        is_negative=op_t.text in ("!=", "!~"),
                                        is_regexp=op_t.text in ("=~", "!~")))
            if self.at_op(","):
                self.next()
            elif self.at_keyword("or"):
                kw = self.next()
                if self.at_op("}"):
                    raise ParseError(
                        f"missing label filters after `or` at {kw.pos}")
                sets.append([])
        self.expect_op("}")
        return sets

    # -- WITH templates ----------------------------------------------------

    def parse_with_expr(self) -> Expr:
        self.expect_op("(")
        scope: dict[str, tuple[list[str], Expr]] = {}
        self.with_scopes.append(scope)
        try:
            while not self.at_op(")"):
                nt = self.next()
                if nt.kind != "ident":
                    raise ParseError(f"expected WITH name at {nt.pos}")
                params: list[str] = []
                if self.at_op("("):
                    params = self.parse_ident_list()
                self.expect_op("=")
                body = self.parse_expr(0)
                scope[nt.text] = (params, body)
                if self.at_op(","):
                    self.next()
            self.expect_op(")")
            body = self.parse_expr(0)
        finally:
            self.with_scopes.pop()
        return body

    def _lookup_with(self, name: str):
        for scope in reversed(self.with_scopes):
            if name in scope:
                return scope[name]
        return None

    def _resolve_with(self, name: str) -> Expr | None:
        w = self._lookup_with(name)
        if w is None:
            return None
        params, body = w
        if params:
            return None
        return body


def _clone(e: Expr) -> Expr:
    import copy
    return copy.deepcopy(e)


_DEFAULT_WITH_SOURCES = {
    # builtin WITH templates (metricsql parser.go:56-71)
    "ru": (["freev", "maxv"],
           "clamp_min(maxv - clamp_min(freev, 0), 0) / "
           "clamp_min(maxv, 0) * 100"),
    "ttf": (["freev"],
            "smooth_exponential(clamp_max(clamp_max(-freev, 0) / "
            "clamp_max(deriv_fast(freev), 0), 365*24*3600), "
            "clamp_max(step()/300, 1))"),
    "range_median": (["q"], "range_quantile(0.5, q)"),
    "alias": (["q", "name"], 'label_set(q, "__name__", name)'),
}
_default_with: dict | None = None


def _default_with_scope() -> dict:
    global _default_with
    if _default_with is None:
        _default_with = {}  # set first: template bodies may reference others
        for name, (params, src) in _DEFAULT_WITH_SOURCES.items():
            _default_with[name] = (params, Parser(src).parse_expr(0))
    return _default_with


def _substitute(e: Expr, bindings: dict[str, Expr]) -> Expr:
    """Replace bare metric selectors whose name is a template param."""
    import copy
    e = copy.deepcopy(e)

    def walk(x):
        if isinstance(x, MetricExpr):
            nm = x.metric_name
            if nm in bindings and len(x.label_filters) == 1:
                return copy.deepcopy(bindings[nm])
            return x
        for field in getattr(x, "__dataclass_fields__", {}):
            v = getattr(x, field)
            if isinstance(v, Expr):
                setattr(x, field, walk(v))
            elif isinstance(v, list):
                setattr(x, field, [walk(a) if isinstance(a, Expr) else a
                                   for a in v])
        return x

    return walk(e)


def parse(q: str) -> Expr:
    """Parse a MetricsQL query into an AST (metricsql.Parse analog)."""
    if not q or not q.strip():
        raise ParseError("empty query")
    return Parser(q).parse()
