"""Query execution top (reference app/vmselect/promql/exec.go:36): the
parse cache and the optimizer switch.

The port's copy of the part of ``victoriametrics_tpu/query/exec.py`` that
turns a query's text into its expression: ``parse_cached`` and
``optimize_enabled``.  ``exec_query`` and ``exec_instant``, which run the
evaluator on that expression, come with the evaluator item of the roadmap.
"""

from __future__ import annotations

import os
import threading

from .metricsql import parse
from .metricsql.ast import Expr

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
