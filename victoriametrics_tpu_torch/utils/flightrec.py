"""Flight-recorder hooks.

The port's copy of ``victoriametrics_tpu/utils/flightrec.py`` as far as the
storage uses it: the record hooks ``rec``, ``instant`` and ``span`` and the
flight context.  The hooks record nothing here: the per-thread event rings,
their captures and the context propagation through the work pool come with
the evaluator item of the roadmap, which serves them.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def rec(name: str, t0: float, dur: float, arg=None) -> None:
    """Record one complete span [t0, t0 + dur) (perf_counter seconds)."""


def instant(name: str, arg=None) -> None:
    """Record a zero-duration marker."""


class _Span:
    """``with flightrec.span("name"):`` -- the region a recorder times."""

    __slots__ = ("name", "arg")

    def __init__(self, name: str, arg=None):
        self.name = name
        self.arg = arg

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def span(name: str, arg=None) -> _Span:
    return _Span(name, arg)


def set_ctx(ctx: int) -> int:
    """Install `ctx` as the calling thread's flight context; returns the
    previous one."""
    prev = getattr(_tls, "ctx", 0)
    _tls.ctx = ctx
    return prev


def get_ctx() -> int:
    return getattr(_tls, "ctx", 0)
