"""Per-query cost hooks.

The port's copy of ``victoriametrics_tpu/utils/costacc.py`` as far as the
storage uses it: the hooks ``restamp``, ``lap`` and ``add_part_bytes``,
which account to the calling thread's current tracker.  No tracker is ever
installed here, so each hook is one thread-local read: the ``CostTracker``,
its per-tenant usage table and the brackets that install it come with the
evaluator item of the roadmap.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def current():
    """The calling thread's cost tracker, or None."""
    return getattr(_tls, "current", None)


def restamp() -> None:
    """Reset this thread's lap stamp (start of a lap chain)."""


def lap(bucket: str, wall_s: float) -> None:
    """Account one phase lap of `wall_s` seconds to the current tracker."""
    tr = current()
    if tr is not None:
        tr.lap(bucket, wall_s)


def add_part_bytes(n: int) -> None:
    """Account `n` raw column bytes fetched from parts."""
    tr = current()
    if tr is not None:
        tr.add_part_bytes(n)
