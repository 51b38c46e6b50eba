"""Happens-before race sanitizer (the vector-clock half of devtools'
`-race` analog; FastTrack-style, Flanagan & Freund PLDI'09).

Every thread carries a vector clock.  Clocks are synchronized at the
project's existing injection seams:

- ``locktrace.make_lock``/``make_rlock`` locks (acquire joins the lock's
  clock into the thread; release publishes the thread's clock into the
  lock) — the whole storage/RPC lock hierarchy is covered for free;
- ``threading.Thread.start``/``join`` (fork publishes the parent clock
  to the child; join publishes the child's final clock to the joiner);
- ``queue.Queue.put``/``get`` (a queue is one coarse sync object: put
  publishes, get subscribes).

Shared state is observed through :func:`traced_fields`, a class
decorator naming the hot mutable fields of a class (partition part
lists, mergeset pending buffers, cache dicts, RPC connection state).
When the sanitizer is OFF — ``VMT_RACETRACE`` unset — the decorator
returns the class untouched and ``enable()`` was never called, so
production code pays **zero** cost: no descriptor, no patched stdlib,
plain ``threading`` locks.  When ON, each named field becomes a data
descriptor whose reads/writes are checked against the last write (and
the reads since it): two accesses to the same field, at least one a
write, with neither ordered before the other by the happens-before
relation, are a data race.  Reports carry BOTH stack traces and are
counted in the ``vm_race_reports_total`` registry counter.

Granularity note: the sanitizer sees *field* reads and writes.  A
``self._pending.extend(...)`` is a field READ (the list object itself
is mutated); unsynchronized concurrent extends are only flagged when
some racing access also *rebinds* or reads-then-writes the field.  The
hot structures here are swapped wholesale under their locks
(``rows, self._pending = self._pending, []``), which is exactly the
pattern field granularity catches.

Deterministic replay: each access is also a preemption point for
``devtools.sched.DeterministicScheduler`` (see that module), so the
interleaving that produced a report can be replayed from its seed.

The port's copy of ``victoriametrics_tpu/devtools/racetrace.py``, whole,
but that ``enable()`` creates ``vm_race_reports_total`` at 0, so a clean
traced run shows its zero on ``/metrics``, and that the stdlib seams it
wraps are the stdlib's own even where the reference's sanitizer patched
them first (a test process that imports both packages).
"""

from __future__ import annotations

import itertools
import os
import queue as _queue_mod
import sys
import threading
import traceback
import weakref

__all__ = ["RaceWarning", "RaceReport", "traced_fields", "traced_field",
           "enabled", "enable", "disable", "reports", "reset",
           "racetrace_env_enabled"]

_STACK_LIMIT = 16


class RaceWarning(UserWarning):
    """A happens-before data race was observed."""


class RaceReport:
    """One racy access pair: ``first`` happened earlier (program order of
    detection), ``second`` is the access that exposed the race."""

    __slots__ = ("cls_name", "field", "kind", "first_thread", "first_op",
                 "first_stack", "second_thread", "second_op", "second_stack")

    def __init__(self, cls_name, field, kind, first_thread, first_op,
                 first_stack, second_thread, second_op, second_stack):
        self.cls_name = cls_name
        self.field = field
        self.kind = kind                    # "write-write" | "read-write" | "write-read"
        self.first_thread = first_thread
        self.first_op = first_op            # "read" | "write"
        self.first_stack = first_stack      # traceback.StackSummary
        self.second_thread = second_thread
        self.second_op = second_op
        self.second_stack = second_stack

    def format(self) -> str:
        return (
            f"DATA RACE ({self.kind}) on {self.cls_name}.{self.field}\n"
            f"  {self.second_op} by thread {self.second_thread!r}:\n"
            + "".join("    " + ln for ln in self.second_stack.format())
            + f"  previous {self.first_op} by thread {self.first_thread!r}:\n"
            + "".join("    " + ln for ln in self.first_stack.format()))

    def __repr__(self):
        return (f"<RaceReport {self.kind} {self.cls_name}.{self.field} "
                f"{self.first_thread!r} vs {self.second_thread!r}>")


# -- detector state -----------------------------------------------------------

# One coarse lock guards every vector clock and shadow cell.  This is a
# debug sanitizer: correctness and simplicity beat parallelism here.
_DET = threading.RLock()
_enabled = False
_reports: list[RaceReport] = []
_seen: set[tuple] = set()           # dedup key per racy pair
_next_tid = itertools.count(1)
_tls = threading.local()            # .st: _ThreadState, .sched: scheduler
_SHADOW = "_vmt$shadow"


class _ThreadState:
    __slots__ = ("tid", "vc", "name")

    def __init__(self, name: str, parent_vc: dict | None = None):
        self.tid = next(_next_tid)
        self.name = name
        self.vc = dict(parent_vc) if parent_vc else {}
        self.vc[self.tid] = 1


def _state() -> _ThreadState:
    st = getattr(_tls, "st", None)
    if st is None:
        cur = threading.current_thread()
        st = _ThreadState(cur.name, getattr(cur, "_vmt_parent_vc", None))
        _tls.st = st
    return st


def _join_vc(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if v > dst.get(k, 0):
            dst[k] = v


class _Cell:
    """FastTrack shadow word for one (object, field)."""

    __slots__ = ("w_tid", "w_clock", "w_thread", "w_stack", "reads")

    def __init__(self):
        self.w_tid = 0
        self.w_clock = 0
        self.w_thread = ""
        self.w_stack = None
        self.reads = {}             # tid -> (clock, thread_name, stack)


def _capture(depth: int):
    # lookup_lines=False: no linecache I/O on the hot access path; source
    # lines resolve lazily when (and only when) a report is formatted
    stack = traceback.StackSummary.extract(
        traceback.walk_stack(sys._getframe(depth)), limit=_STACK_LIMIT,
        lookup_lines=False)
    stack.reverse()
    return stack


def _report(cls_name, field, kind, first_thread, first_op, first_stack,
            st, stack, second_op):
    f_line = first_stack[-1] if first_stack else None
    s_line = stack[-1] if stack else None
    key = (cls_name, field, kind,
           f_line and (f_line.filename, f_line.lineno),
           s_line and (s_line.filename, s_line.lineno))
    if key in _seen:
        return
    _seen.add(key)
    rep = RaceReport(cls_name, field, kind, first_thread, first_op,
                     first_stack, st.name, second_op, stack)
    _reports.append(rep)
    from .locktrace import _inc_counter
    _inc_counter("vm_race_reports_total")
    import warnings
    warnings.warn(rep.format(), RaceWarning, stacklevel=4)


def _on_access(obj, field: str, is_write: bool) -> None:
    st = _state()
    stack = _capture(3)
    with _DET:
        shadow = obj.__dict__.get(_SHADOW)
        if shadow is None:
            shadow = obj.__dict__[_SHADOW] = {}
        cell = shadow.get(field)
        if cell is None:
            cell = shadow[field] = _Cell()
        my = st.vc
        cls_name = type(obj).__name__
        if is_write:
            if cell.w_tid and cell.w_tid != st.tid and \
                    cell.w_clock > my.get(cell.w_tid, 0):
                _report(cls_name, field, "write-write", cell.w_thread,
                        "write", cell.w_stack, st, stack, "write")
            for rt, (rc, rname, rstack) in cell.reads.items():
                if rt != st.tid and rc > my.get(rt, 0):
                    _report(cls_name, field, "read-write", rname,
                            "read", rstack, st, stack, "write")
            cell.w_tid = st.tid
            cell.w_clock = my[st.tid]
            cell.w_thread = st.name
            cell.w_stack = stack
            cell.reads = {}
        else:
            if cell.w_tid and cell.w_tid != st.tid and \
                    cell.w_clock > my.get(cell.w_tid, 0):
                _report(cls_name, field, "write-read", cell.w_thread,
                        "write", cell.w_stack, st, stack, "read")
            cell.reads[st.tid] = (my[st.tid], st.name, stack)
    sched = getattr(_tls, "sched", None)
    if sched is not None:
        sched.point()


# -- traced fields ------------------------------------------------------------

class _TracedField:
    """Data descriptor proxying one instance attribute through the
    detector; the value itself lives in the instance ``__dict__`` under
    its ordinary name, so enabling/disabling tracing at any time leaves
    existing instances fully usable."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        _on_access(obj, self.name, False)
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        _on_access(obj, self.name, True)
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        _on_access(obj, self.name, True)
        try:
            del obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None


_registry: list[tuple[type, tuple[str, ...]]] = []


def traced_fields(*names: str):
    """Class decorator declaring which mutable fields the sanitizer
    observes.  A no-op (the class is returned untouched) unless/until the
    sanitizer is enabled; ``enable()`` retrofits every registered class."""

    def deco(cls):
        _registry.append((cls, names))
        if _enabled:
            _install(cls, names)
        return cls

    return deco


traced_field = traced_fields  # accessor-wrapper alias


def _install(cls, names):
    for n in names:
        if not isinstance(getattr(cls, n, None), _TracedField):
            setattr(cls, n, _TracedField(n))


def _remove(cls, names):
    for n in names:
        if isinstance(cls.__dict__.get(n), _TracedField):
            delattr(cls, n)


# -- stdlib sync seams --------------------------------------------------------

def _stdlib(fn, orig: str):
    """The stdlib's own `fn`: where another copy of this sanitizer (the
    reference's, in a process that imports both packages and enabled it
    first) has patched the seam, the original that copy saved as `orig`.
    Two copies chained would share a thread's clock attributes."""
    mod = sys.modules.get(getattr(fn, "__module__", None) or "")
    if mod is not None and mod.__name__ != __name__ and \
            mod.__name__.endswith(".devtools.racetrace"):
        return getattr(mod, orig)
    return fn


_orig_thread_start = _stdlib(threading.Thread.start, "_orig_thread_start")
_orig_thread_join = _stdlib(threading.Thread.join, "_orig_thread_join")
_orig_queue_put = _stdlib(_queue_mod.Queue.put, "_orig_queue_put")
_orig_queue_get = _stdlib(_queue_mod.Queue.get, "_orig_queue_get")
_queue_vcs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _traced_start(self):
    st = _state()
    with _DET:
        self._vmt_parent_vc = dict(st.vc)
        st.vc[st.tid] += 1          # the fork is a release on the parent
    orig_run = self.run

    def _run_and_publish():
        try:
            orig_run()
        finally:
            try:
                s = _state()
                with _DET:
                    self._vmt_final_vc = dict(s.vc)
            except Exception:  # vmt: disable=VMT003 — a publish failure in
                pass           # this finally must not mask the run() outcome

    self.run = _run_and_publish
    return _orig_thread_start(self)


def _traced_join(self, timeout=None):
    r = _orig_thread_join(self, timeout)
    if not self.is_alive():
        fin = getattr(self, "_vmt_final_vc", None)
        if fin is not None:
            st = _state()
            with _DET:
                _join_vc(st.vc, fin)
    return r


def _traced_put(self, item, block=True, timeout=None):
    # publish BEFORE the item becomes visible to a consumer
    st = _state()
    with _DET:
        vc = _queue_vcs.get(self)
        if vc is None:
            vc = _queue_vcs[self] = {}
        _join_vc(vc, st.vc)
        st.vc[st.tid] += 1
    return _orig_queue_put(self, item, block, timeout)


def _traced_get(self, block=True, timeout=None):
    item = _orig_queue_get(self, block, timeout)
    st = _state()
    with _DET:
        vc = _queue_vcs.get(self)
        if vc is not None:
            _join_vc(st.vc, vc)
    return item


# -- lock hooks (installed into devtools.locktrace) ---------------------------

class _LockHooks:
    """Installed as ``locktrace._race_hooks`` while the sanitizer is on;
    TracedLock routes its inner acquire/release bracketing through these."""

    @staticmethod
    def acquire_inner(inner, blocking, timeout):
        sched = getattr(_tls, "sched", None)
        if sched is None or not blocking or (timeout is not None
                                             and timeout >= 0):
            return inner.acquire(blocking, timeout)
        # under the deterministic scheduler a blocking wait would deadlock
        # the turnstile (the holder is parked at a preemption point), so
        # spin: try, deschedule, retry once rescheduled
        while not inner.acquire(False):
            sched.lock_spin()
        return True

    @staticmethod
    def acquired(lock):
        st = _state()
        with _DET:
            vc = getattr(lock, "_vmt_vc", None)
            if vc:
                _join_vc(st.vc, vc)

    @staticmethod
    def released(lock):
        st = _state()
        with _DET:
            vc = getattr(lock, "_vmt_vc", None)
            if vc is None:
                vc = lock._vmt_vc = {}
            _join_vc(vc, st.vc)
            st.vc[st.tid] += 1


# -- lifecycle ----------------------------------------------------------------

def racetrace_env_enabled() -> bool:
    return os.environ.get("VMT_RACETRACE", "") not in ("", "0")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the sanitizer on: install field descriptors on every
    registered class and patch the stdlib sync seams.  Locks created
    through ``make_lock``/``make_rlock`` AFTER this call are traced."""
    global _enabled
    if _enabled:
        return
    _enabled = True
    for cls, names in _registry:
        _install(cls, names)
    threading.Thread.start = _traced_start
    threading.Thread.join = _traced_join
    _queue_mod.Queue.put = _traced_put
    _queue_mod.Queue.get = _traced_get
    from . import locktrace
    locktrace._race_hooks = _LockHooks
    try:
        from ..utils import metrics as metricslib
        metricslib.REGISTRY.counter("vm_race_reports_total")
    except (ImportError, AttributeError):
        pass                        # registry unavailable mid-bootstrap


def disable() -> None:
    """Undo ``enable()``.  Instances created while tracing was on keep
    working: their values live under the plain attribute names."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    for cls, names in _registry:
        _remove(cls, names)
    threading.Thread.start = _orig_thread_start
    threading.Thread.join = _orig_thread_join
    _queue_mod.Queue.put = _orig_queue_put
    _queue_mod.Queue.get = _orig_queue_get
    from . import locktrace
    locktrace._race_hooks = None


def reports() -> list[RaceReport]:
    with _DET:
        return list(_reports)


def reset() -> None:
    """Drop accumulated reports and dedup state (between test cases)."""
    with _DET:
        _reports.clear()
        _seen.clear()


if racetrace_env_enabled():
    enable()
