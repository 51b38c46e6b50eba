"""Per-query resource limits and memory admission (reference
app/vmselect/promql/eval.go:1776-1885 rollupMemoryLimiter,
app/vmselect/promql/memory_limiter.go, -search.max* flag family).

A query is admitted only if its estimated rollup working set fits the
shared budget (25% of allowed memory, like getRollupMemoryLimiter);
estimates use the reference's formula: series*1000 + points*16 bytes.

The port's copy of ``victoriametrics_tpu/query/limits.py``, whole.
"""

from __future__ import annotations

import threading

from ..utils import memory


class QueryLimitError(ValueError):
    """Raised when a query exceeds a -search.max* limit (HTTP 422)."""


class MemoryLimiter:
    """memory_limiter.go analog: admit/release byte reservations."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self.usage = 0
        self._lock = threading.Lock()

    def get(self, n: int) -> bool:
        with self._lock:
            if n <= self.max_size - self.usage:
                self.usage += n
                return True
            return False

    def put(self, n: int) -> None:
        with self._lock:
            if n > self.usage:
                raise ValueError("BUG: releasing more than acquired")
            self.usage -= n


_rollup_limiter: MemoryLimiter | None = None
_rollup_lock = threading.Lock()


def rollup_memory_limiter() -> MemoryLimiter:
    global _rollup_limiter
    with _rollup_lock:
        if _rollup_limiter is None:
            _rollup_limiter = MemoryLimiter(memory.allowed() // 4)
        return _rollup_limiter


def estimate_rollup_memory(n_series: int, points_per_series: int) -> int:
    """eval.go:1839 rollupMemorySize: series overhead + 16B per point."""
    return n_series * 1000 + n_series * points_per_series * 16


class _Admission:
    """Context manager holding a rollup-memory reservation."""

    def __init__(self, limiter: MemoryLimiter, size: int):
        self.limiter = limiter
        self.size = size

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.limiter.put(self.size)
        return False


def admit_rollup(query: str, n_series: int, points_per_series: int,
                 max_memory_per_query: int = 0) -> _Admission:
    """Raise QueryLimitError if the estimated working set does not fit;
    otherwise reserve it until the context exits (eval.go:1842-1866)."""
    size = estimate_rollup_memory(n_series, points_per_series)
    if max_memory_per_query > 0 and size > max_memory_per_query:
        raise QueryLimitError(
            f"not enough memory for processing {query!r}, which selects "
            f"{n_series} time series with {points_per_series} points in "
            f"each according to -search.maxMemoryPerQuery="
            f"{max_memory_per_query}; requested memory: {size} bytes; "
            f"possible solutions: reduce the number of matching series, "
            f"increase the step query arg, raise -search.maxMemoryPerQuery")
    lim = rollup_memory_limiter()
    if not lim.get(size):
        raise QueryLimitError(
            f"not enough memory for processing {query!r}, which selects "
            f"{n_series} time series with {points_per_series} points in "
            f"each; total available memory for concurrent requests: "
            f"{lim.max_size} bytes; requested memory: {size} bytes; "
            f"possible solutions: reduce the number of matching series, "
            f"increase the step query arg, use a node with more RAM, "
            f"increase -memory.allowedPercent")
    return _Admission(lim, size)
