"""Prometheus relabeling, full superset (reference lib/promrelabel/
relabel.go:20,163-430 — 19 actions incl. the VictoriaMetrics extensions —
plus if_expression.go series-selector guards).

Configs are dicts (parsed from YAML):
  {source_labels: [..], separator: ";", target_label: x, regex: "..",
   modulus: N, replacement: "$1", action: replace, if: '{selector}'}

apply(configs, labels) -> new labels list or None (dropped).

The port's copy of ``victoriametrics_tpu/ingest/relabel.py``, whole;
``hashmod`` hashes with the port's ``native.xxh64`` (the ``xxhash``
package's digest).
"""

from __future__ import annotations

import re

from .. import native
from ..query.metricsql import parse as mql_parse
from ..query.metricsql.ast import MetricExpr
from ..storage.tag_filters import TagFilter


class RelabelConfig:
    def __init__(self, cfg: dict):
        self.source_labels = [s for s in cfg.get("source_labels", [])]
        self.separator = cfg.get("separator", ";")
        self.target_label = cfg.get("target_label", "")
        regex = cfg.get("regex")
        self.regex_orig = regex
        if regex is None:
            # Prometheus default regex is (.*) — one capture group for $1
            self.regex = re.compile("(?s)(.*)\\Z")
        else:
            self.regex = re.compile("(?:" + str(regex) + ")\\Z")
        self.modulus = int(cfg.get("modulus", 0))
        self.replacement = str(cfg.get("replacement", "$1"))
        self.action = cfg.get("action", "replace")
        self.if_selectors = self._parse_if(cfg.get("if"))
        self.labels_cfg = cfg.get("labels", {})  # for graphite action
        self.match_cfg = cfg.get("match", "")

    @staticmethod
    def _parse_if(expr):
        if not expr:
            return None
        exprs = expr if isinstance(expr, list) else [expr]
        out = []
        for e in exprs:
            ast = mql_parse(str(e))
            if not isinstance(ast, MetricExpr):
                raise ValueError(f"relabel if must be a series selector: {e}")
            # `if` selectors OR across entries already; OR'd filter sets
            # ({a="b" or c="d"}) expand into extra entries; one shared
            # lowering (query/eval) keeps `if` semantics identical to
            # query-side selectors
            from ..query.eval import filter_sets_from_metric_expr
            out.extend(filter_sets_from_metric_expr(ast))
        return out

    def _if_matches(self, labels: dict) -> bool:
        if self.if_selectors is None:
            return True
        for filters in self.if_selectors:
            ok = True
            for tf in filters:
                key = "__name__" if tf.key == b"" else tf.key.decode()
                val = labels.get(key, "").encode()
                if not tf.match_value(val):
                    ok = False
                    break
            if ok:
                return True
        return False

    def _source_value(self, labels: dict) -> str:
        return self.separator.join(labels.get(s, "")
                                   for s in self.source_labels)

    def _expand(self, m: re.Match) -> str:
        # $1 / ${1} / $name expansion
        repl = re.sub(r"\$(\d+)", r"\\\1", self.replacement)
        repl = re.sub(r"\$\{(\w+)\}", r"\\g<\1>", repl)
        try:
            return m.expand(repl)
        except re.error:
            return self.replacement

    def apply(self, labels: dict) -> dict | None:
        """Returns the new labels dict or None if the target is dropped."""
        if not self._if_matches(labels):
            if self.action == "keep" and self.if_selectors is not None \
                    and "regex" not in self.__dict__:
                pass
            # `if` mismatch: keep/keep_metrics DROP when guarded only by if
            if self.action in ("keep", "keep_metrics") and \
                    self.regex_orig is None:
                return None
            return labels
        a = self.action
        if a == "replace":
            src = self._source_value(labels)
            m = self.regex.match(src)
            if m is None:
                return labels
            val = self._expand(m)
            out = dict(labels)
            if val:
                out[self.target_label] = val
            else:
                out.pop(self.target_label, None)
            return out
        if a == "replace_all":
            src = self._source_value(labels)
            rx = re.compile(str(self.regex_orig)) if self.regex_orig else None
            if rx is None:
                return labels
            repl = re.sub(r"\$(\d+)", r"\\\1", self.replacement)
            out = dict(labels)
            out[self.target_label] = rx.sub(repl, src)
            return out
        if a == "keep":
            return labels if self.regex.match(self._source_value(labels)) \
                else None
        if a == "drop":
            return None if self.regex.match(self._source_value(labels)) \
                else labels
        if a == "keep_metrics":
            return labels if self.regex.match(labels.get("__name__", "")) \
                else None
        if a == "drop_metrics":
            return None if self.regex.match(labels.get("__name__", "")) \
                else labels
        if a in ("keep_if_equal", "keepequal"):
            if a == "keepequal":
                ok = labels.get(self.target_label, "") == \
                    self._source_value(labels)
            else:
                vals = {labels.get(s, "") for s in self.source_labels}
                ok = len(vals) == 1
            return labels if ok else None
        if a in ("drop_if_equal", "dropequal"):
            if a == "dropequal":
                eq = labels.get(self.target_label, "") == \
                    self._source_value(labels)
            else:
                vals = {labels.get(s, "") for s in self.source_labels}
                eq = len(vals) == 1
            return None if eq else labels
        if a == "keep_if_contains":
            hay = labels.get(self.target_label, "")
            return labels if all(labels.get(s, "") in hay.split(",")
                                 for s in self.source_labels) else None
        if a == "drop_if_contains":
            hay = labels.get(self.target_label, "")
            return None if all(labels.get(s, "") in hay.split(",")
                               for s in self.source_labels) else labels
        if a == "hashmod":
            src = self._source_value(labels)
            out = dict(labels)
            out[self.target_label] = str(
                native.xxh64(src.encode()) % max(self.modulus, 1))
            return out
        if a == "labelmap":
            out = dict(labels)
            for k, v in list(labels.items()):
                m = self.regex.match(k)
                if m:
                    out[self._expand(m)] = v
            return out
        if a == "labelmap_all":
            rx = re.compile(str(self.regex_orig)) if self.regex_orig else None
            out = {}
            repl = re.sub(r"\$(\d+)", r"\\\1", self.replacement)
            for k, v in labels.items():
                out[rx.sub(repl, k) if rx else k] = v
            return out
        if a == "labeldrop":
            return {k: v for k, v in labels.items()
                    if not self.regex.match(k)}
        if a == "labelkeep":
            return {k: v for k, v in labels.items()
                    if k == "__name__" or self.regex.match(k)}
        if a == "lowercase":
            out = dict(labels)
            out[self.target_label] = self._source_value(labels).lower()
            return out
        if a == "uppercase":
            out = dict(labels)
            out[self.target_label] = self._source_value(labels).upper()
            return out
        if a == "graphite":
            return self._apply_graphite(labels)
        raise ValueError(f"unknown relabel action {a!r}")

    def _apply_graphite(self, labels: dict) -> dict:
        """match: "foo.*.bar" with `labels: {job: "$1"}` templates
        (the reference's graphite action)."""
        name = labels.get("__name__", "")
        pattern = self.match_cfg
        rx = re.compile("(?:" + re.escape(pattern).replace("\\*", "([^.]*)")
                        + ")\\Z")
        m = rx.match(name)
        if not m:
            return labels
        out = dict(labels)
        for k, tmpl in self.labels_cfg.items():
            val = re.sub(r"\$(\d+)", lambda mm: m.group(int(mm.group(1))),
                         str(tmpl))
            out[k] = val
        return out


class ParsedConfigs:
    def __init__(self, configs: list[dict]):
        self.configs = [RelabelConfig(c) for c in configs]

    def apply(self, labels: dict) -> dict | None:
        out = dict(labels)
        for rc in self.configs:
            out = rc.apply(out)
            if out is None:
                return None
        return {k: v for k, v in out.items() if v != ""}


def parse_relabel_configs(yaml_text_or_list) -> ParsedConfigs:
    if isinstance(yaml_text_or_list, str):
        from ..utils import configfile
        yaml_text_or_list = configfile.loads(yaml_text_or_list,
                                             "relabel config") or []
    return ParsedConfigs(yaml_text_or_list)
