"""Lock factories of the lock-order tracer.

The port's copy of ``victoriametrics_tpu/devtools/locktrace.py`` as far as
the storage uses it: ``make_lock`` and ``make_rlock`` return a plain
``threading.Lock``/``RLock``, as the reference does while tracing is off.
The traced lock (``TracedLock``, ``VMT_LOCKTRACE=1``) comes with the
tooling item of the roadmap.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A ``threading.Lock``; ``name`` is the lock's role (e.g.
    ``"storage.Table._lock"``), which the tracer keys its graph on."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock``; ``name`` as for :func:`make_lock`."""
    del name
    return threading.RLock()
