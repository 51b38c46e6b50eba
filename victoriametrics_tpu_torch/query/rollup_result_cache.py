"""The rollup result cache's storage-facing surface.

The port's copy of ``victoriametrics_tpu/query/rollup_result_cache.py`` as
far as the storage uses it: ``next_storage_token`` (the per-storage key
token), ``OFFSET_MS`` (how far back an ingested row must lie to invalidate
cached tails) and ``GLOBAL.reset``, which ``Storage.add_rows`` calls on such
a backfill.  The cache holds no entries yet: its entries, merges and ring
buffers come with the evaluator item of the roadmap, which reads them.
"""

from __future__ import annotations

import itertools
import threading

# results newer than now - OFFSET_MS are never cached: samples may still
# arrive for them (the reference's -search.cacheTimestampOffset)
OFFSET_MS = 5 * 60_000

_storage_tokens = itertools.count(1)


def next_storage_token() -> int:
    """Unique per-storage-instance token for cache keys: id() could be
    reused after GC, silently serving another storage's entries."""
    return next(_storage_tokens)


class RollupResultCache:
    """The process-wide cache's reset seam; ``resets`` counts backfills
    that invalidated it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.resets = 0

    def reset(self) -> None:
        with self._lock:
            self.resets += 1


GLOBAL = RollupResultCache()
