"""Runtime lock-order tracer (the `-race` half of devtools).

``TracedLock`` is a drop-in for ``threading.Lock``/``RLock`` that keeps
a per-thread stack of held locks and a global acquisition-order graph
keyed by lock *role* (the stable name passed at construction, so every
``Partition._lock`` instance shares one node, like Go lock ranking).
When thread T acquires lock B while holding lock A, the edge A->B is
recorded; if the graph already proves B->...->A, two threads running
those paths concurrently can deadlock, and the tracer fails fast with
:class:`LockOrderError` instead of letting a stress test hang.

It also warns (:class:`LockHeldTooLongWarning`) when a lock is held
longer than ``VMT_LOCKTRACE_MAX_HOLD_MS`` (default 500) — the static
VMT004 rule's runtime sibling.

Production code never pays for any of this: ``make_lock``/``make_rlock``
return plain ``threading`` primitives unless ``VMT_LOCKTRACE`` is set
(``1``/``raise`` fail fast on cycles, ``warn`` only warns).

Known limitation: edges between two locks with the *same* role (e.g.
two sibling partitions locked together) are not recorded, since role
granularity cannot tell hierarchical order from a real ABBA there.

The port's copy of ``victoriametrics_tpu/devtools/locktrace.py``, whole,
but that a traced process creates its ``vm_locktrace_*`` counters at 0
when its first traced lock is made, so a clean run shows its zeros on
``/metrics``.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["LockOrderError", "LockOrderWarning", "LockHeldTooLongWarning",
           "LockGraph", "TracedLock", "make_lock", "make_rlock",
           "locktrace_enabled"]


class LockOrderError(RuntimeError):
    """A lock acquisition would complete an ABBA cycle (potential
    deadlock)."""


class LockOrderWarning(UserWarning):
    """Cycle detected while running in VMT_LOCKTRACE=warn mode."""


class LockHeldTooLongWarning(UserWarning):
    """A traced lock was held past the configured hold budget."""


_tls = threading.local()  # .held: list[_Held], shared by all traced locks

# Installed by devtools.racetrace.enable(): an object with
# acquire_inner/acquired/released used to bracket the inner lock ops with
# vector-clock joins (and scheduler-aware spin acquires). None = off.
_race_hooks = None


def _inc_counter(name: str) -> None:
    """Best-effort registry counter bump (findings are also exported as
    vm_locktrace_* self-metrics, not just warnings/exceptions)."""
    try:
        from ..utils import metrics as metricslib
        metricslib.REGISTRY.counter(name).inc()
    except ImportError:
        pass                        # registry unavailable mid-bootstrap


#: the counters a traced process exports (created at 0 by make_lock)
_EXPORTED = ("vm_locktrace_cycles_total", "vm_locktrace_hold_warnings_total")
_exported = False


def _export_counters() -> None:
    global _exported
    if _exported:
        return
    try:
        from ..utils import metrics as metricslib
        for name in _EXPORTED:
            metricslib.REGISTRY.counter(name)
    except (ImportError, AttributeError):
        return                      # registry unavailable mid-bootstrap
    # benign race: two first callers both create the same counters, which
    # the registry dedups by name
    _exported = True  # vmt: disable=VMT015


def _held_stack():
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class _Held:
    __slots__ = ("lock", "t0")

    def __init__(self, lock, t0):
        self.lock = lock
        self.t0 = t0


class LockGraph:
    """Global acquisition-order graph: edge A->B means some thread
    acquired role B while holding role A."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}

    def record(self, held: str, new: str):
        """Record edge held->new. Returns (added, cycle): ``added`` is
        True when the edge was not already known (the caller un-records
        it if the acquisition then fails), ``cycle`` is the cycle path
        (role names, ``[new, ..., held, new]``) if one now exists."""
        if held == new:
            return False, None  # same role: hierarchy vs ABBA unknowable
        with self._mu:
            first_time = new not in self._edges.get(held, ())
            self._edges.setdefault(held, set()).add(new)
            if not first_time:
                return False, None  # known edge, checked when first added
            return True, self._find_path(new, held)

    def remove_edge(self, held: str, new: str) -> None:
        with self._mu:
            self._edges.get(held, set()).discard(new)

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        # DFS for src ->...-> dst; called with _mu held
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [dst, src]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def clear(self):
        with self._mu:
            self._edges.clear()


GLOBAL_GRAPH = LockGraph()


def _default_max_hold_ms() -> float:
    try:
        return float(os.environ.get("VMT_LOCKTRACE_MAX_HOLD_MS", "500"))
    except ValueError:
        return 500.0


def _flight_wait_ms() -> float:
    """Blocking waits on a traced lock longer than this land on the
    flight-recorder timeline as ``lock:<role>`` spans (only meaningful
    under VMT_LOCKTRACE — production locks are untraced plain locks)."""
    try:
        return float(os.environ.get("VM_FLIGHT_LOCK_WAIT_MS", "5"))
    except ValueError:
        return 5.0


class TracedLock:
    """Instrumented drop-in for ``threading.Lock``/``RLock``.

    ``name`` is the lock's *role* (stable per call site, shared by all
    instances of a class) used as the node key in the order graph.
    """

    def __init__(self, name: str, *, reentrant: bool = False,
                 graph: LockGraph | None = None, mode: str | None = None,
                 max_hold_ms: float | None = None):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._graph = graph if graph is not None else GLOBAL_GRAPH
        env = os.environ.get("VMT_LOCKTRACE", "1")
        self._mode = mode if mode is not None else \
            ("warn" if env.lower() == "warn" else "raise")
        self._max_hold_ms = max_hold_ms if max_hold_ms is not None \
            else _default_max_hold_ms()
        # thread ident that currently owns the inner lock (+ depth for
        # RLocks); lets acquire() spot stale stack entries left behind by
        # cross-thread Lock hand-offs (acquire here, release elsewhere)
        self._owner: int | None = None
        self._owner_depth = 0

    def _check_order(self, stack):
        """Record edges held->self; returns them for rollback (a failed
        try-lock must not leave phantom edges poisoning the graph)."""
        added = []
        for held in stack:
            was_new, cycle = self._graph.record(held.lock.name, self.name)
            if was_new:
                added.append((held.lock.name, self.name))
            if cycle:
                msg = (f"lock-order cycle: acquiring '{self.name}' while "
                       f"holding '{held.lock.name}', but the reverse order "
                       f"was already observed ({' -> '.join(cycle)}); two "
                       f"threads on these paths can deadlock")
                _inc_counter("vm_locktrace_cycles_total")
                if self._mode == "warn":
                    import warnings
                    warnings.warn(msg, LockOrderWarning, stacklevel=3)
                else:
                    # the acquisition is aborted: none of its edges may
                    # outlive it, or they poison the graph with false
                    # cycles for later, legitimate acquisitions
                    for held_name, new_name in added:
                        self._graph.remove_edge(held_name, new_name)
                    raise LockOrderError(msg)
        return added

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        stack = _held_stack()
        # entries for locks this thread no longer owns are stale leftovers
        # of a cross-thread hand-off (legal for plain Lock): drop them so
        # they neither record false edges nor fake a self-deadlock
        stack[:] = [h for h in stack if h.lock._owner == me]
        already = any(h.lock is self for h in stack)
        added = []
        if not already:
            added = self._check_order(stack)
        elif not self._reentrant:
            raise LockOrderError(
                f"non-reentrant lock '{self.name}' re-acquired by the "
                f"same thread (self-deadlock)")
        hooks = _race_hooks
        t_wait = time.perf_counter()
        if hooks is not None:
            ok = hooks.acquire_inner(self._inner, blocking, timeout)
        else:
            ok = self._inner.acquire(blocking, timeout)
        waited = time.perf_counter() - t_wait
        if waited * 1e3 > _flight_wait_ms():
            # contended-lock visibility on the flight timeline: WHO was
            # stalled on WHAT while a refresh ran (import deferred — the
            # slow path only; devtools must stay import-light)
            from ..utils import flightrec
            flightrec.rec("lock:" + self.name, t_wait, waited)
        if ok:
            if hooks is not None:
                hooks.acquired(self)
            self._owner = me
            self._owner_depth += 1
            stack.append(_Held(self, time.monotonic()))
        else:
            for held_name, new_name in added:
                self._graph.remove_edge(held_name, new_name)
        return ok

    def release(self) -> None:
        stack = _held_stack()
        entry = None
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                entry = stack.pop(i)
                break
        # bookkeeping BEFORE the inner release: the instant
        # _inner.release() returns, a blocked acquirer may win the lock
        # and set its own ownership, which ours must not clobber
        prev = (self._owner, self._owner_depth)
        self._owner_depth = max(self._owner_depth - 1, 0)
        if self._owner_depth == 0:
            self._owner = None
        hooks = _race_hooks
        if hooks is not None:
            # publish this thread's clock into the lock BEFORE the inner
            # release makes the protected state visible to the next owner
            hooks.released(self)
        try:
            self._inner.release()
        except RuntimeError:
            self._owner, self._owner_depth = prev
            raise
        if entry is None:
            return
        if not any(h.lock is self for h in stack):  # outermost release
            held_ms = (time.monotonic() - entry.t0) * 1e3
            if held_ms > self._max_hold_ms:
                import warnings
                _inc_counter("vm_locktrace_hold_warnings_total")
                warnings.warn(
                    f"lock '{self.name}' held for {held_ms:.0f}ms "
                    f"(budget {self._max_hold_ms:.0f}ms); slow work "
                    f"inside the critical section?",
                    LockHeldTooLongWarning, stacklevel=2)

    def locked(self) -> bool:
        if self._reentrant:
            return any(h.lock is self for h in _held_stack())
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        kind = "RLock" if self._reentrant else "Lock"
        return f"<TracedLock {kind} {self.name!r}>"


# -- factory (the only thing production modules import) ----------------------

def locktrace_enabled() -> bool:
    return os.environ.get("VMT_LOCKTRACE", "") not in ("", "0")


def make_lock(name: str):
    """A ``threading.Lock`` — traced when VMT_LOCKTRACE is set or the
    racetrace sanitizer is enabled (its vector clocks synchronize at this
    seam).

    ``name`` should be the lock's role, e.g. ``"storage.Table._lock"``:
    stable per call site and shared by all instances."""
    if locktrace_enabled() or _race_hooks is not None:
        _export_counters()
        return TracedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — traced when VMT_LOCKTRACE or racetrace is
    enabled."""
    if locktrace_enabled() or _race_hooks is not None:
        _export_counters()
        return TracedLock(name, reentrant=True)
    return threading.RLock()
