"""Tag filters: the compiled form of `{label op "value"}` selectors
(reference lib/storage/tag_filters.go; regex or-suffix expansion
regexutil analog).

A TagFilter matches label values for one key with one of four ops:
  =  (negate=False, regex=False)     != (negate=True, regex=False)
  =~ (negate=False, regex=True)      !~ (negate=True, regex=True)

The metric group (__name__) is filter key b"" in the index, matching the
reference's convention of indexing the name as the empty tag key.

Regexes that are plain literal alternations (`a|b|c`, possibly with a common
literal prefix like `api_(get|put)`) expand to exact-value lists so they use
posting lookups instead of full value scans (the reference's or-values
optimization, regexutil.Simplify).

The port's copy of ``victoriametrics_tpu/storage/tag_filters.py``, whole.
"""

from __future__ import annotations

import re


def _try_literal_alternation(expr: str) -> list[str] | None:
    """Expand a pure literal alternation regex into its values, else None."""
    # strip one redundant non-capturing/capturing group around the whole expr
    if not expr:
        return [""]
    specials = set(".+*?[]{}^$\\()|")
    # split on top-level | inside at most one group level
    def split_top(e: str) -> list[str] | None:
        parts, depth, cur = [], 0, []
        for ch in e:
            if ch == "(":
                depth += 1
                if depth == 1:
                    continue
            elif ch == ")":
                depth -= 1
                if depth < 0:
                    return None
                if depth == 0:
                    continue
            elif ch == "|" and depth <= 0:
                parts.append("".join(cur))
                cur = []
                continue
            cur.append(ch)
        if depth != 0:
            return None
        parts.append("".join(cur))
        return parts

    # common case: prefix(group of alternatives) with literal prefix
    m = re.fullmatch(r"([^.+*?\[\]{}^$\\()|]*)\(([^()]*)\)", expr)
    if m and "|" in m.group(2):
        prefix, alts = m.group(1), m.group(2).split("|")
        if all(not (set(a) & specials) for a in alts):
            return [prefix + a for a in alts]
    parts = split_top(expr)
    if parts is None:
        return None
    if any(set(p) & specials for p in parts):
        return None
    return parts


class TagFilter:
    __slots__ = ("key", "value", "negate", "regex", "_re", "or_values")

    def __init__(self, key: bytes, value: bytes, negate: bool = False,
                 regex: bool = False):
        self.key = key
        self.value = value
        self.negate = negate
        self.regex = regex
        self._re = None
        self.or_values: list[bytes] | None = None
        if regex:
            expr = value.decode()
            vals = _try_literal_alternation(expr)
            if vals is not None:
                self.or_values = [v.encode() for v in vals]
            else:
                # fully-anchored match, Prometheus semantics
                self._re = re.compile("(?:" + expr + ")\\Z")
        else:
            self.or_values = [value]

    @property
    def is_empty_match(self) -> bool:
        """Does this filter match a missing label? (e.g. x="" or x=~"a?")"""
        if not self.regex:
            return (self.value == b"") != self.negate
        if self.or_values is not None:
            return (b"" in self.or_values) != self.negate
        return bool(self._re.match("")) != self.negate

    def match_value(self, v: bytes) -> bool:
        if self.or_values is not None:
            ok = v in self.or_values
        else:
            try:
                ok = bool(self._re.match(v.decode("utf-8", "replace")))
            except re.error:  # pragma: no cover
                ok = False
        return ok != self.negate

    def __repr__(self):
        op = {(False, False): "=", (True, False): "!=",
              (False, True): "=~", (True, True): "!~"}[(self.negate, self.regex)]
        return f"{self.key.decode() or '__name__'}{op}{self.value.decode()!r}"


def filters_from_dict(d: dict) -> list[TagFilter]:
    """Convenience: {'__name__': 'http_requests', 'job': ('=~', 'a|b')}."""
    out = []
    for k, v in d.items():
        key = b"" if k == "__name__" else k.encode()
        if isinstance(v, tuple):
            op, val = v
            out.append(TagFilter(key, val.encode(), negate=op in ("!=", "!~"),
                                 regex=op in ("=~", "!~")))
        else:
            out.append(TagFilter(key, v.encode()))
    return out
