"""Shared fetch/decode work pool, search-concurrency gate and merge gate.

The port's copy of ``victoriametrics_tpu/utils/workpool.py`` as far as the
storage uses it: ``POOL`` (the lazily started worker pool whose ``run``
returns results in submit order, waiters helping with queued work so
nested runs never deadlock), ``SEARCH_GATE``/``SearchGate`` (bounded
search admission), ``MERGE_GATE`` (bounded part writes that yield to
in-flight serving), ``configured_shards`` and ``ingest_parallel_enabled``.

Left out: the per-tenant quotas, priority classes and per-tenant metrics
of the reference's ``TenantGate`` (``VM_TENANT_QUOTAS``), and the serve
sections (``serving()``) a refresh is wrapped in, which come with the HTTP
layer; here every tenant shares the one global limit, and merges yield to
in-flight searches.
The propagation of the query tracer and the cost tracker to pool workers
comes with the evaluator.  The deterministic scheduler is not ported.

Sizing: ``VM_SEARCH_WORKERS`` -- unset/``0`` means ``cpu_count``, ``1``
disables parallelism, ``N>1`` pins the worker count, re-read at every
``run``/``submit``.  ``VM_SEARCH_CONCURRENCY`` (default ``2*cpu_count``)
and ``VM_SEARCH_MAX_QUEUE_MS`` (default 10 s) size the search gate,
``VM_MERGE_WORKERS`` the merge gate.
"""

from __future__ import annotations

import os
import queue
import threading
import time as _time

from ..devtools.locktrace import make_lock
from . import flightrec
from . import metrics as metricslib

__all__ = ["WorkPool", "Future", "SearchGate", "SearchLimitError",
           "MergeGate", "POOL", "SEARCH_GATE", "MERGE_GATE",
           "configured_workers", "configured_shards",
           "ingest_parallel_enabled", "serving_busy"]

_TASKS_TOTAL = metricslib.REGISTRY.counter("vm_workpool_tasks_total")


# time spent QUEUED at the SearchGate before a fetch starts (the fetch
# phase family lives in storage/storage.py; this member is owned here
# because the gate is the thing that queues) — with it the phase split
# sums to contended wall time instead of silently losing the queue wait
_QUEUE_WAIT = metricslib.REGISTRY.float_counter(
    'vm_fetch_phase_seconds_total{phase="queue_wait"}')

# per-thread context for the MergeGate serve-priority yield: a pool worker
# holding a shared-POOL slot must never sleep in the yield — see
# MergeGate._maybe_yield
_yield_tls = threading.local()


def serving_busy() -> bool:
    """True while any search is in flight (the gauge is process-global:
    every SearchGate instance shares it)."""
    return metricslib.REGISTRY.gauge("vm_search_concurrent_current").get() > 0


def configured_workers() -> int:
    """Worker count from ``VM_SEARCH_WORKERS`` (unset/0 -> cpu_count,
    1 -> parallelism disabled, N -> N)."""
    raw = os.environ.get("VM_SEARCH_WORKERS", "")
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n <= 0:
        n = os.cpu_count() or 1
    return n


def configured_shards() -> int:
    """Ingest stripe count from ``VM_INGEST_SHARDS`` (the rawRowsShards
    analog): unset/0 -> cpu_count, 1 -> the exact sequential write path,
    N -> N registration stripes."""
    raw = os.environ.get("VM_INGEST_SHARDS", "")
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n <= 0:
        n = os.cpu_count() or 1
    return n


def ingest_parallel_enabled() -> bool:
    """True when the write path may hand work to the pool:
    ``VM_INGEST_SHARDS`` > 1 AND the pool itself is enabled.
    ``VM_INGEST_SHARDS=1`` is the write path's own escape hatch; note
    that ``VM_SEARCH_WORKERS=1`` disables the SHARED pool entirely and
    therefore reverts BOTH the read and the write path to sequential —
    bisect write-path issues with VM_INGEST_SHARDS, not the pool knob."""
    return configured_shards() > 1 and POOL.parallel_enabled()




class _Batch:
    """One run()/submit() call's shared state: ordered result slots, a
    pending count, the first error, and a one-shot completion queue."""

    __slots__ = ("lock", "results", "pending", "error", "done")

    def __init__(self, n: int):
        self.lock = make_lock("utils.workpool._Batch.lock")
        self.results = [None] * n
        self.pending = n
        self.error: BaseException | None = None
        self.done: queue.Queue = queue.Queue()


class Future:
    """Handle for one submitted task; ``result()`` waits (helping the
    pool while it does) and re-raises the task's exception.  Safe for
    multiple waiters/repeat calls: the completion token is re-armed
    after each successful wait, so every ``result()`` returns."""

    __slots__ = ("_pool", "_batch")

    def __init__(self, pool: "WorkPool", batch: _Batch):
        self._pool = pool
        self._batch = batch

    def result(self):
        return self._pool._collect(self._batch)[0]


class WorkPool:
    def __init__(self, workers: int | None = None):
        # None = resolve VM_SEARCH_WORKERS at every run (the shared POOL);
        # an int pins the size (tests)
        self._cfg_workers = workers
        self._lock = make_lock("utils.workpool.WorkPool._lock")
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []

    # -- sizing ------------------------------------------------------------

    def workers(self) -> int:
        return self._cfg_workers if self._cfg_workers is not None \
            else configured_workers()

    def parallel_enabled(self) -> bool:
        """True when run()/submit() would actually use worker threads."""
        return self.workers() > 1

    def _ensure_started(self, want: int) -> None:
        with self._lock:
            while len(self._threads) < want:
                t = threading.Thread(  # vmt: disable=VMT011 — the pool itself
                    target=self._worker, daemon=True,
                    name=f"vm-workpool-{len(self._threads)}")
                self._threads.append(t)
                t.start()

    def _worker(self) -> None:
        me = threading.current_thread()
        _yield_tls.pool_worker = True
        while True:
            item = self._q.get()
            if item is None:        # shutdown sentinel (tests only)
                return
            self._exec(item)
            # converge toward a LOWERED VM_SEARCH_WORKERS: excess workers
            # retire after finishing a task (threads can't be resized in
            # place; idle excess workers retire at their next task)
            with self._lock:
                if len(self._threads) > max(self.workers(), 1) and \
                        me in self._threads:
                    self._threads.remove(me)
                    return

    def shutdown(self) -> None:
        """Stop the workers (tests; call between batches, not racing an
        in-flight run()); in production the daemon workers simply die
        with the process."""
        with self._lock:
            threads, self._threads = self._threads, []
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(timeout=10)

    # -- execution ---------------------------------------------------------

    def _exec(self, item) -> None:
        fn, i, batch, ctx, t_enq = item
        err = None
        # cross-thread attribution: the task runs under the SUBMITTING
        # query's flight context (t_enq is None on the inline path —
        # same thread, context already right)
        if t_enq is not None:
            t_run = _time.perf_counter()
            prev_ctx = flightrec.set_ctx(ctx)
            # recorded AFTER set_ctx so the queue wait carries the
            # submitting query's ctx (it is part of that query's latency)
            flightrec.rec("pool:queue_wait", t_enq, t_run - t_enq)
        try:
            r = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in _collect
            err = e
            r = None
        finally:
            if t_enq is not None:
                flightrec.rec("pool:task", t_run,
                              _time.perf_counter() - t_run)
                flightrec.set_ctx(prev_ctx)
        with batch.lock:
            batch.results[i] = r
            if err is not None and batch.error is None:
                batch.error = err
            batch.pending -= 1
            last = batch.pending == 0
        if last:
            # exactly one put per batch: the waiter's done.get() pairs
            # with it (and carries the finisher's vector clock)
            batch.done.put(None)

    def _collect(self, batch: _Batch):
        """Wait for a batch, helping with queued work (any batch's)
        while waiting — the no-deadlock-under-nesting guarantee."""
        while True:
            with batch.lock:
                if batch.pending == 0:
                    break
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                batch.done.get()
                # re-arm: Futures may be waited by several threads (or
                # twice by a helper that re-entered); each waiter must
                # find a token (its put also chains the clock edge on)
                batch.done.put(None)
                break
            if item is None:
                # a shutdown sentinel racing this waiter: hand it back to
                # the worker it was meant for and park — our batch's tasks
                # were enqueued before the sentinel, so workers drain them
                # first (FIFO)
                self._q.put(None)
                batch.done.get()
                batch.done.put(None)
                break
            self._exec(item)
        with batch.lock:
            err = batch.error
            results = list(batch.results)
        if err is not None:
            raise err
        return results

    def run(self, fns) -> list:
        """Execute every callable, returning results in submit order;
        the first raised exception is re-raised after the whole batch
        drains (no task of a failed batch is left running)."""
        fns = list(fns)
        n = len(fns)
        if n == 0:
            return []
        w = self.workers()
        if n == 1 or w <= 1:
            # inline degraded mode still EXECUTES the tasks: count them,
            # so vm_workpool_tasks_total means "tasks run through the
            # pool seam" on 1-core boxes too (was 0 there, which read as
            # a dead pool on the dashboard and flaked the metric test)
            _TASKS_TOTAL.inc(n)
            return [fn() for fn in fns]
        self._ensure_started(min(w, n))
        batch = _Batch(n)
        _TASKS_TOTAL.inc(n)
        ctx = flightrec.get_ctx()
        t_enq = _time.perf_counter()
        for i, fn in enumerate(fns):
            self._q.put((fn, i, batch, ctx, t_enq))
        return self._collect(batch)

    def submit(self, fn) -> Future:
        """Pipeline seam: run one task in the background (inline when
        the pool is disabled) and collect it later via Future.result()."""
        batch = _Batch(1)
        if self.workers() <= 1:
            _TASKS_TOTAL.inc()
            self._exec((fn, 0, batch, 0, None))
            return Future(self, batch)
        self._ensure_started(1)
        _TASKS_TOTAL.inc()
        self._q.put((fn, 0, batch, flightrec.get_ctx(),
                     _time.perf_counter()))
        return Future(self, batch)


#: the one shared pool; sized by VM_SEARCH_WORKERS at first parallel use
POOL = WorkPool()

metricslib.REGISTRY.gauge("vm_workpool_workers",
                          callback=lambda: len(POOL._threads))
metricslib.REGISTRY.gauge("vm_workpool_queue_depth",
                          callback=POOL._q.qsize)

# -- search concurrency gate --------------------------------------------------

class SearchLimitError(RuntimeError):
    """The search could not start within the queue-wait budget."""

    retry_after_s = 1


class SearchGate:
    """Bounded admission for storage searches (the vmstorage
    ``-search.maxConcurrentRequests`` limiter analog): up to ``limit``
    searches run at once; excess callers queue for at most
    ``max_queue_ms`` and are then rejected with :class:`SearchLimitError`.
    ``admit(tenant)`` takes the tenant for the reference's signature;
    every tenant shares the one limit here."""

    def __init__(self, limit: int | None = None,
                 max_queue_ms: float | None = None):
        if limit is None:
            try:
                limit = int(os.environ.get("VM_SEARCH_CONCURRENCY", "0"))
            except ValueError:
                limit = 0
        if limit <= 0:
            limit = 2 * (os.cpu_count() or 1)
        if max_queue_ms is None:
            try:
                max_queue_ms = float(
                    os.environ.get("VM_SEARCH_MAX_QUEUE_MS", "10000"))
            except ValueError:
                max_queue_ms = 10000.0
        self.limit = limit
        self.max_queue_s = max_queue_ms / 1e3
        self._sem = threading.Semaphore(limit)
        metricslib.REGISTRY.gauge("vm_search_concurrent_limit").set(limit)
        self._current = metricslib.REGISTRY.gauge(
            "vm_search_concurrent_current")
        self._queued = metricslib.REGISTRY.counter(
            "vm_search_requests_queued_total")
        self._rejected = metricslib.REGISTRY.counter(
            "vm_search_requests_rejected_total")

    def admit(self, tenant=(0, 0)) -> "SearchGate":
        """Context manager admitting one search."""
        del tenant
        return self

    def __enter__(self):
        if not self._sem.acquire(blocking=False):
            self._queued.inc()
            t0 = _time.perf_counter()
            ok = self._sem.acquire(timeout=self.max_queue_s)
            wait = _time.perf_counter() - t0
            _QUEUE_WAIT.inc(wait)
            flightrec.rec("fetch:queue_wait", t0, wait)
            if not ok:
                self._rejected.inc()
                raise SearchLimitError(
                    f"couldn't start the search within "
                    f"{self.max_queue_s:.1f}s: {self.limit} concurrent "
                    f"searches are already running (raise "
                    f"VM_SEARCH_CONCURRENCY or reduce query load)")
        self._current.inc()
        return self

    def __exit__(self, *exc):
        self._current.dec()
        self._sem.release()
        return False


#: process-wide gate (one storage engine per process in production)
SEARCH_GATE = SearchGate()



# -- merge concurrency gate ---------------------------------------------------

class MergeGate:
    """Bounded admission for heavy part writes — flush encodes and
    background merges (the reference's ``mergeWorkersCount`` bound,
    lib/storage/partition.go): at most ``limit`` part writes run at
    once across data partitions AND index mergesets, so a flush storm
    cannot saturate every core with zstd/fsync while ingest and queries
    starve.

    ``VM_MERGE_WORKERS`` (default ``cpu_count``) sizes the gate; the
    gate only *bounds* concurrency — the work itself is fanned by
    ``Table.flush_to_disk``/``force_merge`` over :data:`POOL`.

    Serve priority: on entry the gate YIELDS to in-flight serving — while
    any search/serve section is active (``serving_busy``), merge
    admission defers for up to ``VM_MERGE_YIELD_MS`` (default 250; 0
    disables) and resumes as soon as serving drains.  This keeps a
    background flush/merge storm from sitting on every core exactly while
    a dashboard refresh is being served (the measured source of
    steady-state refresh-latency variance).  Bounded: merges always
    proceed after the budget, so ingest pressure cannot starve them;
    counted by ``vm_merge_gate_yields_total``."""

    def __init__(self, limit: int | None = None):
        if limit is None:
            try:
                limit = int(os.environ.get("VM_MERGE_WORKERS", "0"))
            except ValueError:
                limit = 0
        if limit <= 0:
            limit = os.cpu_count() or 1
        self.limit = limit
        self._sem = threading.Semaphore(limit)
        self._pending = metricslib.Gauge("pending")
        self._active = metricslib.Gauge("active")
        self._yields = metricslib.REGISTRY.counter(
            "vm_merge_gate_yields_total")

    @property
    def yields(self) -> int:
        """Merge admissions that deferred to in-flight serving."""
        return self._yields.get()

    def _maybe_yield(self) -> None:
        # Never yield on a thread that would invert the priority it
        # exists to protect: a shared-POOL worker sleeping here holds a
        # pool slot the serve's own fetch tasks are queued behind.  The
        # yield therefore applies only on dedicated flusher/merger
        # threads (and direct callers).
        if getattr(_yield_tls, "pool_worker", False):
            return
        try:
            budget_ms = float(os.environ.get("VM_MERGE_YIELD_MS", "250"))
        except ValueError:
            budget_ms = 250.0
        if budget_ms <= 0 or not serving_busy():
            return
        self._yields.inc()
        t0 = _time.perf_counter()
        deadline = _time.monotonic() + budget_ms / 1e3
        while _time.monotonic() < deadline and serving_busy():
            _time.sleep(0.002)
        flightrec.rec("merge:yield", t0, _time.perf_counter() - t0)

    @property
    def pending(self) -> int:
        """Writers waiting for a merge slot."""
        return int(self._pending.get())

    @property
    def active(self) -> int:
        """Writers holding a merge slot."""
        return int(self._active.get())

    def __enter__(self):
        self._maybe_yield()
        # t0 AFTER the yield: _maybe_yield records its own merge:yield
        # span, so gate_wait covers only the slot-semaphore wait — the
        # two flight spans partition the admission delay instead of
        # double-reporting the same interval
        t0 = _time.perf_counter()
        self._pending.inc()
        try:
            self._sem.acquire()
        finally:
            self._pending.dec()
            # slot wait: the gap between a flush/merge being REQUESTED
            # (serve-priority yield already served) and a worker slot
            # freeing up
            wait = _time.perf_counter() - t0
            if wait > 0.0005:
                flightrec.rec("merge:gate_wait", t0, wait)
        self._active.inc()
        return self

    def __exit__(self, *exc):
        self._active.dec()
        self._sem.release()
        return False


#: process-wide merge gate; sized by VM_MERGE_WORKERS at import
MERGE_GATE = MergeGate()

metricslib.REGISTRY.gauge("vm_merge_pending",
                          callback=lambda: MERGE_GATE.pending)
metricslib.REGISTRY.gauge("vm_merge_active",
                          callback=lambda: MERGE_GATE.active)
