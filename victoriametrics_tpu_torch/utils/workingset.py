"""Two-generation working-set cache (reference lib/workingsetcache):
instead of wiping a full cache — a multi-million-entry ``clear()`` on
the ingest hot path costs a latency cliff AND a cold restart for every
live series — the cache rotates: on overflow the current map becomes
the *previous* generation and a fresh current map starts empty.
Lookups fall through current -> previous, promoting hits back into
current, so the working set survives rotation and only entries idle for
a whole generation are dropped.

Used by the ingest pipeline's hot caches (the raw-label TSID cache in
``storage.Storage``, the id->name/id->TSID caches in ``IndexDB``) —
each keyed lookup is a couple of dict probes under a ``make_lock`` lock
so the racetrace sanitizer sees proper happens-before edges between
concurrent striped writers.

The port's copy of ``victoriametrics_tpu/utils/workingset.py``, whole.
"""

from __future__ import annotations

from ..devtools.locktrace import make_lock

__all__ = ["WorkingSetCache"]

_MISS = object()


class WorkingSetCache:
    """Bounded dict with two-generation rotation instead of clear().

    ``max_entries`` bounds the *current* generation; total resident
    entries are at most ``2 * max_entries`` across both generations
    (same bound shape as the reference's split-cache mode).
    """

    __slots__ = ("name", "max_entries", "_lock", "_cur", "_prev",
                 "rotations")

    def __init__(self, max_entries: int, name: str = "workingset"):
        if max_entries < 1:
            raise ValueError("max_entries must be positive")
        self.name = name
        self.max_entries = max_entries
        self._lock = make_lock(f"utils.workingset.{name}")
        self._cur: dict = {}
        self._prev: dict = {}
        self.rotations = 0

    def _rotate_locked(self) -> None:
        self._prev = self._cur
        self._cur = {}
        self.rotations += 1

    def get(self, key, default=None):
        with self._lock:
            v = self._cur.get(key, _MISS)
            if v is not _MISS:
                return v
            v = self._prev.get(key, _MISS)
            if v is _MISS:
                return default
            # promote: a hit in the old generation is working-set-live
            if len(self._cur) >= self.max_entries:
                self._rotate_locked()
            self._cur[key] = v
            return v

    def put(self, key, value) -> None:
        with self._lock:
            if key not in self._cur and \
                    len(self._cur) >= self.max_entries:
                self._rotate_locked()
            self._cur[key] = value

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._cur or key in self._prev

    def __len__(self) -> int:
        with self._lock:
            if not self._prev:
                return len(self._cur)
            return len(self._cur.keys() | self._prev.keys())

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._cur) or bool(self._prev)

    def items(self) -> list:
        """Snapshot of distinct (key, value) pairs; current-generation
        values win over previous-generation ones."""
        with self._lock:
            merged = dict(self._prev)
            merged.update(self._cur)
            return list(merged.items())

    def clear(self) -> None:
        with self._lock:
            self._cur = {}
            self._prev = {}

    def filter(self, keep) -> None:
        """Drop every entry where ``keep(key, value)`` is falsy (e.g.
        purging tombstoned TSIDs after delete_series)."""
        with self._lock:
            self._cur = {k: v for k, v in self._cur.items() if keep(k, v)}
            self._prev = {k: v for k, v in self._prev.items() if keep(k, v)}
