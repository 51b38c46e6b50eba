"""Leveled, rate-limited logging (capability parity with reference lib/logger).

The reference exposes Infof/Warnf/Errorf/Panicf with per-second error rate
limiting and message counters (lib/logger/logger.go:112-142).  We build on
stdlib logging and add: rate limiting per call-site, a panic helper that
raises, and counters exported to /metrics.

The port's copy of ``victoriametrics_tpu/utils/logger.py``, whole.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections import defaultdict

_counters = defaultdict(int)  # level -> messages logged (exported as vm_log_messages_total)
_counters_lock = threading.Lock()

_rate_state: dict[tuple[str, int], tuple[float, int]] = {}
_rate_lock = threading.Lock()

_logger = logging.getLogger("vmtpu")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s\t%(levelname)s\t%(message)s", datefmt="%Y-%m-%dT%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def set_level(level: str) -> None:
    _logger.setLevel(getattr(logging, level.upper()))


def _count(level: str) -> None:
    with _counters_lock:
        _counters[level] += 1


def message_counters() -> dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def infof(fmt: str, *args) -> None:
    _count("info")
    _logger.info(fmt, *args)


def warnf(fmt: str, *args) -> None:
    _count("warn")
    _logger.warning(fmt, *args)


def errorf(fmt: str, *args) -> None:
    _count("error")
    _logger.error(fmt, *args)


class InternalError(RuntimeError):
    """Raised by panicf — the analog of logger.Panicf 'BUG:' invariants."""


def panicf(fmt: str, *args) -> None:
    _count("panic")
    msg = fmt % args if args else fmt
    _logger.error("PANIC: %s", msg)
    raise InternalError(msg)


def throttled_warnf(key: str, interval_s: float, fmt: str, *args) -> None:
    """Log at most once per interval_s for the given key (reference:
    lib/storage/storage.go:2155 logSkippedSeries pattern)."""
    now = time.monotonic()
    with _rate_lock:
        last, suppressed = _rate_state.get((key, 0), (0.0, 0))
        if now - last < interval_s:
            _rate_state[(key, 0)] = (last, suppressed + 1)
            return
        _rate_state[(key, 0)] = (now, 0)
    if suppressed:
        warnf(fmt + " (%d similar messages suppressed)", *args, suppressed)
    else:
        warnf(fmt, *args)
