"""Deterministic cooperative interleaving scheduler (the replay half of
the race tooling; a simple probabilistic-concurrency-testing — PCT —
variant).

The OS scheduler only exposes the races it happens to interleave;
``DeterministicScheduler`` serializes a set of worker threads through a
turnstile so that exactly one *scheduled* thread runs between traced
points, and all scheduling decisions come from one seeded RNG.  The
traced points are the racetrace sanitizer's observation sites (traced
field accesses and ``TracedLock`` operations), so enabling
``racetrace`` densely instruments real storage code with preemption
opportunities for free.

At each point the running thread is, with probability ``change_prob``,
demoted below every previously demoted thread (the PCT "change point"),
and control passes to the highest-priority runnable thread.  Because
every decision is drawn from the seeded RNG *in schedule order*, the
whole interleaving is a pure function of (seed, program): running the
same seeded workload twice yields the identical ``trace``, which is how
a reported race is replayed — rerun with the seed printed in the
report/test failure.

Usage::

    racetrace.enable()
    sched = DeterministicScheduler(seed=1234)
    sched.spawn("w0", worker, arg0)
    sched.spawn("w1", worker, arg1)
    sched.run()                  # starts all, drives to completion
    assert sched.trace == expected_replay

Threads must go through ``spawn`` (registration order feeds the RNG);
unregistered threads — e.g. the main thread — pass traced points
without participating in the turnstile.

A scheduled thread that blocks on a ``TracedLock`` is spun via
``lock_spin()`` (try-acquire, deschedule, retry) instead of parking in
the kernel, because its holder is itself parked in the turnstile.  A
thread that blocks anywhere the scheduler cannot see (bare
``threading`` primitives, socket reads) is covered by ``step_timeout``:
waiters seize the turnstile after it elapses, trading determinism for
progress on that pathological step.

The port's copy of ``victoriametrics_tpu/devtools/sched.py``, whole.
"""

from __future__ import annotations

import random
import threading
import time

from . import racetrace

__all__ = ["DeterministicScheduler"]


class DeterministicScheduler:
    def __init__(self, seed: int = 0, change_prob: float = 0.15,
                 step_timeout: float = 5.0):
        self.seed = seed
        self.change_prob = change_prob
        self.step_timeout = step_timeout
        self.rng = random.Random(seed)
        self.trace: list[str] = []      # thread name per executed point
        self._cv = threading.Condition()
        self._threads: list[threading.Thread] = []
        self._prio: dict[str, float] = {}
        self._alive: set[str] = set()
        self._entered = 0
        self._current: str | None = None
        self._low = 0.0                 # monotonically decreasing demotion floor
        self._started = False
        self._errors: list[tuple[str, BaseException]] = []

    # -- test-facing API ---------------------------------------------------

    def spawn(self, name: str, fn, *args, **kwargs) -> threading.Thread:
        """Register a worker; priorities are drawn from the seeded RNG in
        spawn order, so spawn calls must be deterministic too."""
        if self._started:
            raise RuntimeError("spawn() after run()")
        if name in self._prio:
            raise ValueError(f"duplicate scheduled thread name {name!r}")
        self._prio[name] = self.rng.random()

        def body():
            racetrace._tls.sched = self
            try:
                self._enter(name)
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised in run()
                self._errors.append((name, e))
            finally:
                racetrace._tls.sched = None
                self._leave(name)

        t = threading.Thread(target=body, name=name, daemon=True)
        self._threads.append(t)
        self._alive.add(name)
        return t

    def run(self, timeout: float = 60.0) -> None:
        """Start every spawned thread and drive the workload to completion
        (raises if a worker wedges past ``timeout``)."""
        self._started = True
        for t in self._threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.1, deadline - time.monotonic()))
            if t.is_alive():
                raise RuntimeError(
                    f"scheduled thread {t.name!r} wedged (seed={self.seed}, "
                    f"trace so far: {self.trace[-20:]})")
        if self._errors:
            name, err = self._errors[0]
            raise RuntimeError(
                f"scheduled thread {name!r} raised under seed "
                f"{self.seed}") from err

    # -- turnstile ---------------------------------------------------------

    def _enter(self, name: str) -> None:
        """Start barrier: every thread parks here until ALL spawned threads
        arrived, so the first RNG draw never races thread startup."""
        with self._cv:
            self._entered += 1
            self._cv.notify_all()
            while self._entered < len(self._threads):
                self._cv.wait(self.step_timeout)
            if self._current is None:
                self._pick_locked()
            self._wait_for_turn_locked(name)

    def _leave(self, name: str) -> None:
        with self._cv:
            self._alive.discard(name)
            if self._current == name:
                self._pick_locked()
            self._cv.notify_all()

    def _pick_locked(self) -> None:
        self._current = max(self._alive, key=self._prio.__getitem__) \
            if self._alive else None

    def _wait_for_turn_locked(self, name: str) -> None:
        while self._current != name:
            if not self._cv.wait(self.step_timeout):
                # the chosen thread is stuck somewhere untraced: seize the
                # turnstile rather than deadlock (non-deterministic fallback,
                # only reachable when the workload blocks outside trace
                # points for step_timeout straight); recorded in the trace
                # so a replay divergence is self-diagnosing
                self.trace.append(name + "/seized")
                self._current = name
                break

    def point(self) -> None:
        """One traced point: maybe a PCT change point, then yield the
        turnstile to the highest-priority runnable thread."""
        name = threading.current_thread().name
        with self._cv:
            if name not in self._alive:
                return
            self.trace.append(name)
            if self.rng.random() < self.change_prob:
                self._demote_locked(name)
            self._cv.notify_all()
            self._wait_for_turn_locked(name)

    def lock_spin(self) -> None:
        """Called (via racetrace's lock hooks) when a scheduled thread
        fails a try-acquire: unconditionally demote so the lock holder —
        parked in the turnstile — gets to run and release."""
        name = threading.current_thread().name
        with self._cv:
            if name not in self._alive:
                return
            self.trace.append(name + "/blocked")
            self._demote_locked(name)
            self._cv.notify_all()
            self._wait_for_turn_locked(name)

    def _demote_locked(self, name: str) -> None:
        self._low -= 1.0
        self._prio[name] = self._low
        self._pick_locked()
