"""Query tracing: a tree of timed spans threaded through every query layer
(reference lib/querytracer/tracer.go:16-76), activated per-request via
`trace=1` and embedded in the API response JSON for UI rendering.

A disabled tracer is a no-op singleton so hot paths pay one branch.
Device phases (the device rollups) report their spans too, giving host+device
timing in one tree.

The port's copy of ``victoriametrics_tpu/utils/querytracer.py``, whole.
"""

from __future__ import annotations

import threading
import time

_enabled_globally = True

# the calling thread's active tracer: set by the serving layer around a
# query, PROPAGATED to pool workers by utils/workpool around each task —
# so a span created on a worker attaches to the submitting query's tree
# instead of silently vanishing
_tls = threading.local()


def set_current(tracer) -> "Tracer | _NopTracer":
    """Install `tracer` as the calling thread's active tracer; returns
    the previous one (callers restore it in a finally)."""
    prev = getattr(_tls, "current", NOP)
    _tls.current = tracer if tracer is not None else NOP
    return prev


def current() -> "Tracer | _NopTracer":
    """The calling thread's active tracer (NOP when none): worker-side
    code adds spans via ``querytracer.current().new_child(...)`` without
    threading a tracer argument through every layer."""
    return getattr(_tls, "current", NOP)


def set_deny_tracing(deny: bool):
    global _enabled_globally
    _enabled_globally = not deny


class Tracer:
    __slots__ = ("message", "start", "duration_s", "children", "_done")

    def __init__(self, fmt: str = "", *args):
        self.message = (fmt % args) if args else fmt
        self.start = time.perf_counter()
        self.duration_s = 0.0
        self.children: list[Tracer] = []
        self._done = False

    @property
    def enabled(self) -> bool:
        return True

    def new_child(self, fmt: str, *args) -> "Tracer":
        child = Tracer(fmt, *args)
        self.children.append(child)
        return child

    def printf(self, fmt: str, *args) -> None:
        child = self.new_child(fmt, *args)
        child.donef("")

    def donef(self, fmt: str = "", *args) -> None:
        if self._done:
            return
        self._done = True
        self.duration_s = time.perf_counter() - self.start
        if fmt:
            extra = (fmt % args) if args else fmt
            self.message = f"{self.message}: {extra}" if self.message else extra

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # close the span even when the traced layer raises; donef is
        # idempotent, so a span already closed with a success message
        # keeps it
        if exc is not None:
            self.donef("error: %s", exc)
        else:
            self.donef("")
        return False

    @classmethod
    def from_dict(cls, d: dict) -> "Tracer":
        """Rebuild a (finished) span tree from its to_dict() form — the
        receiving half of cross-RPC trace propagation."""
        t = cls(str(d.get("message", "")))
        t.duration_s = float(d.get("duration_msec", 0.0)) / 1e3
        t._done = True
        t.children = [cls.from_dict(c) for c in d.get("children", ())]
        return t

    def add_remote(self, d: dict) -> None:
        """Graft a remote span tree (a storage node's to_dict()) under
        this span, giving one host+device+network tree per query."""
        if d:
            self.children.append(Tracer.from_dict(d))

    def to_dict(self) -> dict:
        if not self._done:
            self.donef("")
        out = {"duration_msec": round(self.duration_s * 1e3, 3),
               "message": self.message}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class _NopTracer:
    __slots__ = ()

    @property
    def enabled(self) -> bool:
        return False

    def new_child(self, fmt, *args):
        return self

    def printf(self, fmt, *args):
        pass

    def donef(self, fmt="", *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def add_remote(self, d):
        pass

    def to_dict(self):
        return {}


NOP = _NopTracer()


def new(enabled: bool, fmt: str = "", *args):
    if enabled and _enabled_globally:
        return Tracer(fmt, *args)
    return NOP
