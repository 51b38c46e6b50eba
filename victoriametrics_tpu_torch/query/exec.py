"""Query execution top (reference app/vmselect/promql/exec.go:36): parse
cache -> eval -> sorted results.

The port's copy of ``victoriametrics_tpu/query/exec.py``, whole."""

from __future__ import annotations

import os
import threading

import numpy as np

from .eval import QueryError, eval_expr
from .metricsql import parse
from .metricsql.ast import Expr
from .types import EvalConfig, Timeseries

_parse_cache: dict[tuple, Expr] = {}
_parse_lock = threading.Lock()
_PARSE_CACHE_MAX = 10_000


def optimize_enabled() -> bool:
    """Common-filter pushdown (metricsql Optimize analog) on?
    ``VM_MQL_OPTIMIZE=0`` restores raw-parse evaluation exactly — the
    escape hatch AND the equality oracle."""
    return os.environ.get("VM_MQL_OPTIMIZE", "1") != "0"


def parse_cached(q: str) -> Expr:
    """Parse (and, by default, optimize) one query; the cache key
    includes the optimizer flag so flipping VM_MQL_OPTIMIZE never serves
    a stale AST from the other mode."""
    opt = optimize_enabled()
    key = (q, opt)
    with _parse_lock:
        e = _parse_cache.get(key)
    if e is not None:
        return e
    e = parse(q)
    if opt:
        from .metricsql.optimizer import optimize
        e = optimize(e)
    with _parse_lock:
        if len(_parse_cache) >= _PARSE_CACHE_MAX:
            _parse_cache.clear()
        _parse_cache[key] = e
    return e


_SORT_FUNCS = frozenset({
    "sort", "sort_desc", "sort_by_label", "sort_by_label_desc",
    "sort_by_label_numeric", "sort_by_label_numeric_desc", "limit_offset"})


def exec_query(ec: EvalConfig, q: str) -> list[Timeseries]:
    """Range query: returns series on the ec grid, sorted by labels unless
    the top-level function imposes its own order (exec.go:80-100 analog)."""
    expr = parse_cached(q)
    # every storage/cache/device seam under this eval accounts into the
    # query's CostTracker (workpool propagates it to fan-out workers);
    # nested evals over the same shared tracker re-install it, harmless
    import time as _time

    from ..utils import costacc
    prev_cost = costacc.set_current(ec._cost)
    t0 = _time.perf_counter()
    w0 = ec._cost.local_wall_ms_total()
    try:
        rows = eval_expr(ec, expr)
    finally:
        # name the leftover: eval wall not claimed by any LOCAL phase
        # lap (parse/AST walk/series glue) lands in eval:other instead
        # of silently vanishing from the cost split.  Baseline is the
        # local-lap total only — remote nodes' laps merged in during a
        # fan-out accrue concurrently and may sum past local wall,
        # which would wrongly suppress this bucket
        dt_ms = (_time.perf_counter() - t0) * 1e3
        inner_ms = ec._cost.local_wall_ms_total() - w0
        if dt_ms > inner_ms:
            costacc.lap("eval:other", (dt_ms - inner_ms) / 1e3)
        costacc.set_current(prev_cost)
    # drop all-NaN series (absent everywhere)
    out = [ts for ts in rows if not np.isnan(ts.values).all()]
    from .metricsql.ast import FuncExpr
    if not (isinstance(expr, FuncExpr) and expr.name in _SORT_FUNCS):
        out.sort(key=lambda ts: ts.metric_name.marshal())
    return out


def exec_instant(ec_base: EvalConfig, q: str, ts_ms: int) -> list[Timeseries]:
    """Instant query at ts_ms (single-point grid)."""
    ec = ec_base.child(start=ts_ms, end=ts_ms)
    return exec_query(ec, q)
