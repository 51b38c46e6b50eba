"""Allowed-memory accounting (reference lib/memory/memory.go:29-72).

memory.Allowed() = allowedPercent (default 60%) of the cgroup/system RAM
limit; cache sizing throughout the storage engine derives from it.

The port's copy of ``victoriametrics_tpu/utils/memory.py``, whole.
"""

from __future__ import annotations

import os

_allowed_percent = 60.0
_allowed_bytes_override = 0


import functools


@functools.cache
def _system_memory() -> int:
    # Computed once (reference uses sync.Once): cache sizing calls this on
    # hot paths. cgroup v2 limit if present, else /proc/meminfo MemTotal.
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            v = f.read().strip()
            if v != "max":
                return int(v)
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 32


def set_allowed_percent(p: float) -> None:
    global _allowed_percent
    _allowed_percent = p


def set_allowed_bytes(n: int) -> None:
    global _allowed_bytes_override
    _allowed_bytes_override = n


def allowed() -> int:
    if _allowed_bytes_override > 0:
        return _allowed_bytes_override
    return int(_system_memory() * _allowed_percent / 100.0)


def remaining() -> int:
    return max(0, _system_memory() - allowed())


def available_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1
