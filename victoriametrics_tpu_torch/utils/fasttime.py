"""Cached coarse clock (reference lib/fasttime: 1s-resolution cached unix time).

Python's time.time() is cheap but not free on hot ingest paths; we cache the
current unix seconds, refreshed lazily with a 0.5s tolerance, plus millisecond
helpers used by storage timestamps (all timestamps in the system are unix ms,
like the reference).

The port's copy of ``victoriametrics_tpu/utils/fasttime.py``, whole.
"""

from __future__ import annotations

import time

_cached = (0.0, 0)  # (monotonic_at_refresh, unix_secs)


def unix_timestamp() -> int:
    global _cached
    mono = time.monotonic()
    at, secs = _cached
    if mono - at > 0.5:
        secs = int(time.time())
        _cached = (mono, secs)
    return secs


def unix_ms() -> int:
    return int(time.time() * 1000)


def unix_seconds() -> float:
    """Float unix seconds (for durations/uptime at ms resolution)."""
    return time.time()


def unix_ns() -> int:
    """Integer unix nanoseconds (uniqueness counters, snapshot-name
    seeds — anything that wants restart-monotonic entropy)."""
    return time.time_ns()
