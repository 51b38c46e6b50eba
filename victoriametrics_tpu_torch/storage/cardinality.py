"""Hourly/daily series cardinality limiters (reference
lib/bloomfilter/{filter,limiter}.go, wired at lib/storage/storage.go:2136
registerSeriesCardinality).

A limiter admits at most max_series distinct metricIDs per rotation
window; rows for ids beyond that are dropped with a counter. Membership is
a bloom filter sized at 16 bits per item with k=4 probes (the reference's
bloomfilter sizing), reset at each window rollover.

The port's copy of ``victoriametrics_tpu/storage/cardinality.py``, whole.
"""

from __future__ import annotations

from ..devtools.locktrace import make_lock
from ..utils import fasttime

K_PROBES = 4
BITS_PER_ITEM = 16


class BloomLimiter:
    def __init__(self, max_series: int, rotation_s: int, name: str = ""):
        self.max_series = max_series
        self.rotation_s = rotation_s
        self.name = name
        # floor well above BITS_PER_ITEM*k so tiny limits (tests, strict
        # quotas) don't degenerate into false-positive admissions
        nbits = max(max_series * BITS_PER_ITEM, 4096)
        self._nbits = nbits
        self._bits = bytearray((nbits + 7) // 8)
        self._tracked = 0
        self._bucket = fasttime.unix_timestamp() // rotation_s
        self.rows_dropped = 0
        # concurrent striped writers probe the same limiter; admissions
        # must be atomic or the budget can be oversubscribed
        self._lock = make_lock("storage.BloomLimiter._lock")

    def _rotate_if_needed_locked(self):
        b = fasttime.unix_timestamp() // self.rotation_s
        if b != self._bucket:
            self._bucket = b
            self._bits = bytearray(len(self._bits))
            self._tracked = 0

    def add(self, metric_id: int) -> bool:
        """True if the id is admitted (already tracked, or capacity left);
        False means the row must be dropped (limiter.go:62 Add)."""
        # splitmix64-style probe sequence off the (already well-mixed) id
        nbits = self._nbits
        h = (metric_id ^ (metric_id >> 33)) * 0xff51afd7ed558ccd & (2**64 - 1)
        probes = []
        for i in range(K_PROBES):
            h = (h + 0x9e3779b97f4a7c15) & (2**64 - 1)
            x = (h ^ (h >> 29)) * 0xbf58476d1ce4e5b9 & (2**64 - 1)
            pos = x % nbits
            probes.append((pos >> 3, 1 << (pos & 7)))
        with self._lock:
            self._rotate_if_needed_locked()
            bits = self._bits
            missing = [(byte, mask) for byte, mask in probes
                       if not bits[byte] & mask]
            if not missing:
                return True  # (probabilistically) already tracked
            if self._tracked >= self.max_series:
                self.rows_dropped += 1
                return False
            for byte, mask in missing:
                bits[byte] |= mask
            self._tracked += 1
            return True

    @property
    def current_series(self) -> int:
        with self._lock:
            self._rotate_if_needed_locked()
            return self._tracked

    def metrics(self) -> dict:
        p = f"vm_{self.name}_series_limit"
        return {
            f"{p}_max_series": self.max_series,
            f"{p}_current_series": self.current_series,
            f"{p}_rows_dropped_total": self.rows_dropped,
        }
