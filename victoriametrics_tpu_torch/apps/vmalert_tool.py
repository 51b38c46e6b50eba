"""vmalert-tool: promtool-style unit testing for rule files (reference
app/vmalert-tool/unittest).

Test file format (promtool-compatible subset):

  rule_files: [rules.yml]
  evaluation_interval: 1m
  tests:
  - interval: 1m
    input_series:
    - series: 'errs{job="api"}'
      values: '0+10x10'            # expanding notation: start+stepxcount
    alert_rule_test:
    - eval_time: 5m
      alertname: ErrsHigh
      exp_alerts:
      - exp_labels: {job: api, severity: crit}
    metricsql_expr_test:
    - expr: sum(errs)
      eval_time: 5m
      exp_samples:
      - labels: '{}'
        value: 50

The port's copy of ``victoriametrics_tpu/apps/vmalert_tool.py``; the test
and rule files load through ``utils/configfile`` (PyYAML where it is
installed, else JSON).
"""

from __future__ import annotations

import argparse
import re
import sys
import tempfile

from ..utils import configfile, logger


def parse_series_values(spec: str) -> list[float]:
    """promtool expanding notation: 'a+bxn' / 'a-bxn' / 'axn' / literals,
    space separated; '_' = missing, 'stale' = staleness marker."""
    out: list[float] = []
    for tok in str(spec).split():
        m = re.fullmatch(r"(-?[\d.]+)([+-][\d.]+)x(\d+)", tok)
        if m:
            start, step, n = float(m.group(1)), float(m.group(2)), int(m.group(3))
            out.extend(start + step * i for i in range(n + 1))
            continue
        m = re.fullmatch(r"(-?[\d.]+)x(\d+)", tok)
        if m:
            out.extend([float(m.group(1))] * (int(m.group(2)) + 1))
            continue
        if tok == "_":
            out.append(float("nan"))
        elif tok == "stale":
            from ..ops.decimal import STALE_NAN
            out.append(STALE_NAN)
        else:
            out.append(float(tok))
    return out


def _parse_series_selector(s: str) -> dict:
    from ..query.metricsql import parse
    from ..query.metricsql.ast import MetricExpr
    e = parse(s)
    if not isinstance(e, MetricExpr):
        raise ValueError(f"input_series must be a plain series: {s}")
    labels = {}
    for f in e.label_filters:
        if f.is_negative or f.is_regexp:
            raise ValueError(f"input_series labels must be exact: {s}")
        labels[f.label] = f.value
    return labels


def run_test_file(path: str) -> list[str]:
    """Returns a list of failure messages (empty = all passed)."""
    import math
    import os

    from ..query.types import EvalConfig
    from ..storage.storage import Storage
    from .vmalert import Datasource

    cfg = configfile.load(path) or {}
    failures: list[str] = []

    rule_groups = []
    for rf in cfg.get("rule_files", []):
        full = rf if os.path.isabs(rf) else \
            os.path.join(os.path.dirname(os.path.abspath(path)), rf)
        rcfg = configfile.load(full) or {}
        rule_groups.extend(rcfg.get("groups", []))

    for ti, test in enumerate(cfg.get("tests", [])):
        from ..query.metricsql.parser import parse_duration_ms
        interval_ms = int(parse_duration_ms(
            str(test.get("interval", cfg.get("evaluation_interval", "1m"))))[0])
        with tempfile.TemporaryDirectory() as tmp:
            storage = Storage(tmp)
            # test epoch: use a fixed recent-ish base so per-day index works
            t0 = 1_700_000_000_000
            rows = []
            for inp in test.get("input_series", []):
                labels = _parse_series_selector(inp["series"])
                vals = parse_series_values(inp.get("values", ""))
                for i, v in enumerate(vals):
                    if isinstance(v, float) and math.isnan(v) and \
                            not _is_stale(v):
                        continue
                    rows.append((labels, t0 + i * interval_ms, v))
            storage.add_rows(rows)
            storage.force_flush()

            class _LocalDS(Datasource):
                def __init__(self):
                    pass

                def query(self, expr, ts=None):
                    ec = EvalConfig(start=int(ts * 1000), end=int(ts * 1000),
                                    step=interval_ms, storage=storage,
                                    lookback_delta=5 * interval_ms)
                    from ..query.exec import exec_query
                    rows_ = exec_query(ec, expr)
                    out = []
                    for r in rows_:
                        v = float(r.values[-1])
                        if math.isnan(v):
                            continue
                        out.append({"metric": r.metric_name.to_dict(),
                                    "value": v, "ts": ts})
                    return out

            ds = _LocalDS()

            for at in test.get("alert_rule_test", []):
                eval_ms = int(parse_duration_ms(str(at["eval_time"]))[0])
                want = at.get("exp_alerts") or []
                got = _eval_alert(rule_groups, ds, at["alertname"],
                                  (t0 + eval_ms) / 1e3, interval_ms)
                got_lbls = sorted(
                    tuple(sorted({k: v for k, v in g.items()
                                  if k != "alertname"}.items()))
                    for g in got)
                want_lbls = sorted(
                    tuple(sorted({str(k): str(v)
                                  for k, v in (w.get("exp_labels") or {}).items()
                                  }.items()))
                    for w in want)
                if got_lbls != want_lbls:
                    failures.append(
                        f"test #{ti} alert {at['alertname']} at "
                        f"{at['eval_time']}: expected {want_lbls}, "
                        f"got {got_lbls}")

            for et in test.get("metricsql_expr_test", []) + \
                    test.get("promql_expr_test", []):
                eval_ms = int(parse_duration_ms(str(et["eval_time"]))[0])
                res = ds.query(et["expr"], (t0 + eval_ms) / 1e3)
                want = et.get("exp_samples") or []
                if len(res) != len(want):
                    failures.append(
                        f"test #{ti} expr {et['expr']!r}: expected "
                        f"{len(want)} samples, got {len(res)}")
                    continue
                remaining = list(res)
                for w in want:
                    wv = float(w.get("value", 0))
                    w_labels = (_parse_series_selector(w["labels"])
                                if w.get("labels") else None)
                    # match by labels when given, else by value
                    match = None
                    for g in remaining:
                        if w_labels is not None:
                            if g["metric"] == w_labels:
                                match = g
                                break
                        elif abs(g["value"] - wv) <= 1e-9 * max(abs(wv), 1):
                            match = g
                            break
                    if match is None:
                        failures.append(
                            f"test #{ti} expr {et['expr']!r}: no result "
                            f"matching {w}")
                        continue
                    remaining.remove(match)
                    if abs(match["value"] - wv) > 1e-9 * max(abs(wv), 1):
                        failures.append(
                            f"test #{ti} expr {et['expr']!r} "
                            f"{w.get('labels', '')}: expected {wv}, "
                            f"got {match['value']}")
            storage.close()
    return failures


def _is_stale(v: float) -> bool:
    import numpy as np

    from ..ops import decimal as dec
    return bool(dec.is_stale_nan(np.array([v])).any())


def _eval_alert(rule_groups, ds, alertname, now_s, interval_ms):
    """Evaluate matching alerting rules stepwise up to now_s so `for`
    durations behave; returns firing label sets."""
    from .vmalert import STATE_FIRING, AlertingRule, Group

    out = []
    for g in rule_groups:
        for rc in g.get("rules", []):
            if rc.get("alert") != alertname:
                continue
            rule = AlertingRule(rc, None)
            t = 1_700_000_000_000 / 1e3
            while t <= now_s:
                rule.eval(ds, t)
                t += interval_ms / 1e3
            for st in rule._active.values():
                if st["state"] == STATE_FIRING or rule.for_s == 0:
                    out.append(st["labels"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="vmalert-tool")
    sub = p.add_subparsers(dest="cmd", required=True)
    ut = sub.add_parser("unittest")
    ut.add_argument("--files", action="append", required=True)
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    all_ok = True
    for f in args.files:
        with configfile.exit_on_error():
            failures = run_test_file(f)
        if failures:
            all_ok = False
            for msg in failures:
                logger.errorf("FAILED: %s", msg)
        else:
            logger.infof("%s: OK", f)
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
