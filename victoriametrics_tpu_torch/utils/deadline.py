"""Storage-side query deadline budget (ROADMAP item 3's named leftover).

The select plane already clips every RPC *socket* operation to the
query's remaining budget — but a vmstorage that received the request
kept burning the dead query's FULL server-side cost (index scan, part
decode, assembly) after the caller gave up.  This module is the
server-side half: the remaining budget ships inside ``search_v1`` /
``searchColumns_v1`` requests, and the storage engine calls
:meth:`Budget.tick` every N series during index scans and
:meth:`Budget.check` once per fetch unit, aborting mid-flight with the
typed :class:`DeadlineExceededError` that crosses the RPC boundary as
itself (the vmselect surfaces it WITHOUT marking the healthy node
down).

The port's copy of ``victoriametrics_tpu/utils/deadline.py``, whole.
"""

from __future__ import annotations

import threading
import time

#: index-scan granularity: budget checked every this many resolved
#: series (an abort lands within ~one check interval of expiry)
CHECK_EVERY = 256


class DeadlineExceededError(ValueError):
    """The query's deadline budget expired while the storage engine was
    still scanning/fetching; the work was aborted server-side.  Typed so
    the RPC layer ships it across the wire as a deadline (no error-log
    flood, no node-down marking) instead of a generic handler error.
    A ValueError subclass so the HTTP layer maps a LOCAL storage abort
    through the same error path as the evaluator's own
    QueryLimitError deadline check."""


class Budget:
    """Per-query abort token threaded through the storage read path.

    ``tick()`` is the cheap per-item call (one int increment; the real
    clock check fires every :data:`CHECK_EVERY` calls); ``check()`` is
    the unconditional boundary check (per fetch unit / per phase).
    ``on_abort`` runs once when the budget first trips (the
    vm_storage_deadline_aborts_total counter lives with the storage
    engine, not here)."""

    __slots__ = ("deadline", "on_abort", "_n", "_tripped", "_lock")

    def __init__(self, deadline: float, on_abort=None):
        self.deadline = deadline
        self.on_abort = on_abort
        self._n = 0
        self._tripped = False
        # fetch units call check() from concurrent pool workers: the
        # trip latch needs real mutual exclusion or one aborted query
        # counts as several in vm_storage_deadline_aborts_total
        self._lock = threading.Lock()

    def tick(self) -> None:
        self._n += 1
        if self._n % CHECK_EVERY == 0:
            self.check()

    def check(self) -> None:
        if not self.deadline or time.monotonic() < self.deadline:
            return
        with self._lock:
            first = not self._tripped
            self._tripped = True
        if first and self.on_abort is not None:
            self.on_abort()
        raise DeadlineExceededError(
            "storage-side deadline exceeded: query budget expired "
            "mid-scan; the remaining work was aborted on the vmstorage")
