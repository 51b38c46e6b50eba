"""Shared fetch/decode work pool + search-concurrency gate (the
single-node analog of the reference's per-CPU read parallelism:
app/vmselect/netstorage unpack workers fanning block decode across
gomaxprocs goroutines, and lib/storage's search concurrency limiter
bounding how many searches run at once).

One process owns ONE lazily-started pool (:data:`POOL`) of
``cpu_count`` daemon workers.  The hot storage read path fans
per-partition/per-part piece collection across it (zstd + native decode
release the GIL, so the workers genuinely overlap), the cluster fanout
reuses it instead of spawning fresh threads per query, and the chunked
fetch pipeline prefetches chunk *i+1* on it while chunk *i* rolls up.

Design constraints, in order:

- **Determinism of results.**  ``run(fns)`` returns results in submit
  order; callers that concatenate them get byte-identical output to the
  sequential loop.  ``VM_SEARCH_WORKERS=1`` disables the pool entirely
  (every ``run`` degenerates to an inline ``[fn() for fn in fns]``),
  restoring today's single-threaded execution exactly — the escape
  hatch the deterministic scheduler and bisection both rely on.
- **No deadlocks under nesting.**  A task may itself call ``run`` (a
  cluster fanout task fetches from a local node whose table fans parts
  across the same pool).  Waiters therefore HELP: while its batch is
  incomplete, the submitting thread drains and executes queued tasks
  instead of parking, so every ``run`` makes progress even when all
  workers are blocked in nested waits.
- **Happens-before edges the racetrace sanitizer understands.**  Tasks
  travel through a ``queue.Queue`` (put/get carry vector clocks when
  the sanitizer is on: submit *happens-before* execute), each batch's
  result slots are written and read under a ``make_lock`` lock
  (execute *happens-before* collect), and completion is signalled by
  one ``queue.Queue`` put (the final execute *happens-before* the
  waiter's wakeup).  No bare Events/Conditions anywhere on the seam.
- **Deterministic-scheduler safety.**  A thread scheduled by
  ``devtools.sched.DeterministicScheduler`` executes its batch INLINE:
  pool workers are not turnstile participants, so handing them work
  would reintroduce the wall-clock nondeterminism the scheduler exists
  to remove (and a scheduled thread parked in ``done.get()`` would
  stall the turnstile until ``step_timeout`` seizes it).

Pool sizing: ``VM_SEARCH_WORKERS`` — unset/``0`` means ``cpu_count``,
``1`` disables parallelism, ``N>1`` pins the worker count.  The env var
is re-read at every ``run``/``submit`` so tests (and the deterministic
scheduler harness) can flip modes without restarting the process.

Self-metrics (the metrics registry): ``vm_workpool_tasks_total``,
``vm_workpool_queue_depth``, ``vm_workpool_workers``, and from the
gate ``vm_search_concurrent_{current,limit}`` plus
``vm_search_requests_{queued,rejected}_total``.

The port's copy of ``victoriametrics_tpu/utils/workpool.py``, whole.
"""

from __future__ import annotations

import os
import queue
import threading
import time as _time

from ..devtools.locktrace import make_lock
from . import costacc
from . import flightrec
from . import metrics as metricslib
from . import querytracer

__all__ = ["WorkPool", "Future", "SearchGate", "TenantGate",
           "TenantQuota", "parse_tenant_quotas", "SearchLimitError",
           "MergeGate", "POOL", "SEARCH_GATE", "MERGE_GATE",
           "configured_workers", "configured_shards",
           "ingest_parallel_enabled", "serving", "serving_busy"]

_TASKS_TOTAL = metricslib.REGISTRY.counter("vm_workpool_tasks_total")

# time spent QUEUED at the SearchGate before a fetch starts (the fetch
# phase family lives in storage/storage.py; this member is owned here
# because the gate is the thing that queues) — with it the phase split
# sums to contended wall time instead of silently losing the queue wait
_QUEUE_WAIT = metricslib.REGISTRY.float_counter(
    'vm_fetch_phase_seconds_total{phase="queue_wait"}')

# whole-refresh serve sections (the HTTP cached range executor wraps each
# refresh): together with the SearchGate occupancy below this is the
# "someone is being served right now" signal the MergeGate yields to
_SERVING = metricslib.REGISTRY.gauge("vm_serving_current")
# per-thread context for the MergeGate serve-priority yield: a thread
# that is itself serving (or a pool worker holding a shared-POOL slot)
# must never sleep in the yield — see MergeGate._maybe_yield
_yield_tls = threading.local()


class _ServingSection:
    def __enter__(self):
        _SERVING.inc()
        _yield_tls.serving = getattr(_yield_tls, "serving", 0) + 1
        return self

    def __exit__(self, *exc):
        _SERVING.dec()
        _yield_tls.serving -= 1
        return False


def serving() -> _ServingSection:
    """Context manager marking an in-flight serve (query refresh); merge
    admission defers to these sections (MergeGate serve priority)."""
    return _ServingSection()


def serving_busy() -> bool:
    """True while any search or serve section is in flight (the gauges
    are process-global: every SearchGate instance shares them)."""
    return _SERVING.get() > 0 or \
        metricslib.REGISTRY.gauge("vm_search_concurrent_current").get() > 0


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


def _sched_active() -> bool:
    """True when the calling thread runs under the deterministic
    scheduler (devtools.sched) — batches then execute inline."""
    from ..devtools import racetrace
    return getattr(racetrace._tls, "sched", None) is not None


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
        return self.workers() > 1 and not _sched_active()

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
        fn, i, batch, ctx, tracer, cost, t_enq = item
        err = None
        # cross-thread attribution: the task runs under the SUBMITTING
        # query's flight context, tracer and cost tracker, so spans and
        # cost laps created here attach to that query instead of an
        # anonymous worker (t_enq is None on the inline path — same
        # thread, context already right)
        if t_enq is not None:
            t_run = _time.perf_counter()
            prev_ctx = flightrec.set_ctx(ctx)
            prev_tr = querytracer.set_current(tracer)
            prev_cost = costacc.set_current(cost)
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
                costacc.set_current(prev_cost)
                querytracer.set_current(prev_tr)
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
        if n == 1 or w <= 1 or _sched_active():
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
        tr = querytracer.current()
        cost = costacc.current()
        t_enq = _time.perf_counter()
        for i, fn in enumerate(fns):
            self._q.put((fn, i, batch, ctx, tr, cost, t_enq))
        return self._collect(batch)

    def submit(self, fn) -> Future:
        """Pipeline seam: run one task in the background (inline when
        the pool is disabled) and collect it later via Future.result()."""
        batch = _Batch(1)
        if self.workers() <= 1 or _sched_active():
            _TASKS_TOTAL.inc()
            self._exec((fn, 0, batch, 0, None, None, None))
            return Future(self, batch)
        self._ensure_started(1)
        _TASKS_TOTAL.inc()
        self._q.put((fn, 0, batch, flightrec.get_ctx(),
                     querytracer.current(), costacc.current(),
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
    """The search could not start within the queue-wait budget.  HTTP
    layers convert this to 429 + Retry-After (the same shed-load
    contract as the ingest rate limiter's RateLimitedError)."""

    retry_after_s = 1


#: priority classes, best first; admission scans waiters by
#: (priority rank, arrival order) so "high" jumps "normal" jumps "low",
#: FIFO within a class
_PRIORITY_RANKS = {"high": 0, "normal": 1, "low": 2}


class TenantQuota:
    """One tenant's admission policy: concurrency cap, queue-time
    budget, priority class.  ``limit=0`` means "no per-tenant cap"
    (global gate only); ``queue_ms=None`` inherits the gate default."""

    __slots__ = ("limit", "queue_ms", "priority", "rank")

    def __init__(self, limit: int = 0, queue_ms: float | None = None,
                 priority: str = "normal"):
        self.limit = int(limit)
        self.queue_ms = queue_ms
        self.priority = priority
        self.rank = _PRIORITY_RANKS.get(priority, 1)


#: the no-quota default: global limit only, gate-default queue budget,
#: normal priority == exactly the pre-tenant SearchGate behavior
_DEFAULT_QUOTA = TenantQuota()


def parse_tenant_quotas(raw: str) -> dict:
    """Parse ``VM_TENANT_QUOTAS``.  Grammar::

        spec   := entry (';' entry)*
        entry  := tenant '=' limit [':' queue_ms [':' priority]]
        tenant := accountID [':' projectID] | '*'

    ``accountID`` alone means project 0; ``*`` sets the default quota
    for tenants not listed.  Unparseable entries are dropped (a typo'd
    env var must degrade to today's global behavior, not crash the
    storage engine at import).  Example::

        VM_TENANT_QUOTAS='0:0=8:5000:high;7=2:100:low;*=4'
    """
    quotas: dict = {}
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        tstr, eq, rhs = entry.partition("=")
        if not eq:
            continue
        tstr = tstr.strip()
        parts = rhs.strip().split(":")
        try:
            limit = int(parts[0])
            if limit < 0:
                # a negative cap would make the tenant permanently
                # inadmissible; drop the entry like any other typo
                continue
            queue_ms = float(parts[1]) if len(parts) > 1 and parts[1] \
                else None
            priority = parts[2] if len(parts) > 2 and parts[2] \
                else "normal"
            if priority not in _PRIORITY_RANKS:
                continue
            if tstr == "*":
                key = "*"
            elif ":" in tstr:
                a, p = tstr.split(":", 1)
                key = (int(a), int(p))
            else:
                key = (int(tstr), 0)
        except ValueError:
            continue
        quotas[key] = TenantQuota(limit, queue_ms, priority)
    return quotas


class _Waiter:
    """One queued admission request.  ``granted`` flips under the gate
    lock; the token queue additionally carries the releaser's vector
    clock to the blocked waiter (racetrace's queue put/get seam)."""

    __slots__ = ("rank", "seq", "tenant", "quota", "granted", "q")

    def __init__(self, rank: int, seq: int, tenant, quota: TenantQuota):
        self.rank = rank
        self.seq = seq
        self.tenant = tenant
        self.quota = quota
        self.granted = False
        self.q: queue.Queue = queue.Queue()


class TenantGate:
    """Per-tenant bounded admission for storage searches (the vmstorage
    ``-search.maxConcurrentRequests`` limiter analog, extended with
    multi-tenant QoS): up to ``limit`` searches run concurrently
    process-wide, and a tenant with a configured quota additionally
    never holds more than its own cap — one noisy tenant saturating its
    slots queues AGAINST ITSELF while other tenants keep being admitted
    from the remaining global capacity.  Excess callers queue for at
    most their queue-time budget and are then rejected loudly
    (:class:`SearchLimitError` → HTTP 429) instead of piling unbounded
    decode work onto a saturated host.

    Sizing: ``VM_SEARCH_CONCURRENCY`` (default ``2*cpu_count``) bounds
    the global gate; ``VM_SEARCH_MAX_QUEUE_MS`` (default 10s) is the
    default queue budget; ``VM_TENANT_QUOTAS`` (see
    :func:`parse_tenant_quotas`) adds per-tenant caps, queue budgets
    and priority classes.  The env var is re-read (and re-parsed only
    when its text changed) at every admission, so tests and operators
    flip quotas without restarting.  With ``VM_TENANT_QUOTAS`` unset
    the gate is behavior-identical to the pre-tenant SearchGate.

    Fairness: waiters are granted in (priority rank, arrival) order —
    strict priority between classes, FIFO within one — and a waiter
    blocked only by its OWN tenant quota never holds back later waiters
    of other tenants (no head-of-line blocking across tenants).

    Deterministic-scheduler safety: a thread running under
    ``devtools.sched`` spins through the (traced) gate lock instead of
    parking in a queue the turnstile cannot see, so the race-marked
    stress replays deterministically.

    Self-metrics: the global ``vm_search_*`` family (unchanged names)
    plus per-tenant ``vm_tenant_search_requests_total``,
    ``vm_tenant_search_queued_total``, ``vm_tenant_search_rejected_total``
    and ``vm_tenant_search_concurrent`` labeled ``{tenant="acc:proj"}``.
    Gate waits record ``fetch:queue_wait`` flight spans under the
    waiting query's context; rejections record a ``gate:rejected``
    flight instant so shed load shows up in captures."""

    #: bounded per-tenant metric cardinality: DISTINCT tenants beyond
    #: this fold into one shared ``tenant="other"`` label set (tenant
    #: ids come straight from the URL path — an unauthenticated client
    #: iterating ids must not grow process memory or metric output)
    _MAX_TENANT_METRICS = 1000

    def __init__(self, limit: int | None = None,
                 max_queue_ms: float | None = None,
                 quotas: dict | None = None):
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
        # quotas pinned at construction (tests) or re-read from
        # VM_TENANT_QUOTAS per admission (production/chaos runs)
        self._quotas_pinned = quotas
        self._quotas_env_raw: str | None = None
        self._quotas_env: dict = {}
        self._lock = make_lock("utils.workpool.TenantGate._lock")
        self._global_current = 0
        self._tenant_counts: dict = {}
        self._waiters: list[_Waiter] = []
        self._seq = 0
        metricslib.REGISTRY.gauge("vm_search_concurrent_limit").set(limit)
        self._current = metricslib.REGISTRY.gauge(
            "vm_search_concurrent_current")
        self._queued = metricslib.REGISTRY.counter(
            "vm_search_requests_queued_total")
        self._rejected = metricslib.REGISTRY.counter(
            "vm_search_requests_rejected_total")
        self._tenant_metric_memo: dict[tuple, object] = {}
        self._tenant_label_seen: set = set()

    # -- config ------------------------------------------------------------

    def _quotas(self) -> dict:
        if self._quotas_pinned is not None:
            return self._quotas_pinned
        raw = os.environ.get("VM_TENANT_QUOTAS", "")
        if raw != self._quotas_env_raw:
            self._quotas_env = parse_tenant_quotas(raw)
            self._quotas_env_raw = raw
        return self._quotas_env

    def quota_for(self, tenant) -> TenantQuota:
        q = self._quotas()
        return q.get(tenant) or q.get("*") or _DEFAULT_QUOTA

    # -- per-tenant metrics ------------------------------------------------

    def _tenant_metric(self, name: str, tenant, gauge: bool = False):
        key = (name, tenant)
        m = self._tenant_metric_memo.get(key)
        if m is not None:
            return m
        # fold decision is per DISTINCT tenant and sticky (the set only
        # grows), so inc/dec pairs always resolve to the same handle;
        # folded tenants share the (name, "other") entry and add NO
        # per-tenant memo keys — both the memo and the registry stay
        # bounded under tenant-id iteration.  GIL-benign without the
        # gate lock: a racing double-create resolves to the registry's
        # one handle.
        if tenant in self._tenant_label_seen or \
                len(self._tenant_label_seen) < self._MAX_TENANT_METRICS:
            self._tenant_label_seen.add(tenant)
            label = f"{tenant[0]}:{tenant[1]}"
        else:
            label = "other"
            key = (name, "other")
            m = self._tenant_metric_memo.get(key)
            if m is not None:
                return m
        full = metricslib.format_name(name, {"tenant": label})
        m = (metricslib.REGISTRY.gauge(full) if gauge
             else metricslib.REGISTRY.counter(full))
        self._tenant_metric_memo[key] = m
        return m

    # -- admission ---------------------------------------------------------

    def admit(self, tenant=(0, 0)) -> "_Admission":
        """Context manager admitting one search for `tenant`."""
        return _Admission(self, tenant)

    # back-compat: the gate itself is a context manager for the default
    # tenant (the pre-tenant SearchGate surface)
    def __enter__(self):
        self._acquire((0, 0))
        return self

    def __exit__(self, *exc):
        self._release((0, 0))
        return False

    def _admissible_locked(self, tenant, quota: TenantQuota) -> bool:
        if self._global_current >= self.limit:
            return False
        if quota.limit and \
                self._tenant_counts.get(tenant, 0) >= quota.limit:
            return False
        return True

    def _take_locked(self, tenant) -> None:
        self._global_current += 1
        self._tenant_counts[tenant] = \
            self._tenant_counts.get(tenant, 0) + 1

    def _grant_locked(self) -> None:
        """Hand free capacity to waiters in (priority, arrival) order.
        A waiter capped by its own tenant quota is skipped — later
        waiters of OTHER tenants still get the free global slots."""
        if not self._waiters or self._global_current >= self.limit:
            return
        for w in sorted(self._waiters, key=lambda w: (w.rank, w.seq)):
            if self._global_current >= self.limit:
                break
            if w.quota.limit and self._tenant_counts.get(
                    w.tenant, 0) >= w.quota.limit:
                continue
            self._take_locked(w.tenant)
            w.granted = True
            self._waiters.remove(w)
            # exactly one token per grant; carries the granter's clock
            w.q.put(None)

    def _acquire(self, tenant) -> None:
        quota = self.quota_for(tenant)
        self._tenant_metric("vm_tenant_search_requests_total",
                            tenant).inc()
        with self._lock:
            # fast path: empty queue + capacity (no waiter may be
            # overtaken — priority classes only reorder QUEUED requests)
            if not self._waiters and self._admissible_locked(tenant,
                                                             quota):
                self._take_locked(tenant)
                self._mark_admitted(tenant)
                return
            w = _Waiter(quota.rank, self._seq, tenant, quota)
            self._seq += 1
            self._waiters.append(w)
            # a newcomer may still be immediately grantable (e.g. the
            # queue holds only quota-capped waiters of another tenant)
            self._grant_locked()
            if w.granted:
                try:
                    w.q.get_nowait()
                except queue.Empty:
                    pass
                self._mark_admitted(tenant)
                return
        self._queued.inc()
        self._tenant_metric("vm_tenant_search_queued_total", tenant).inc()
        budget_s = (quota.queue_ms / 1e3 if quota.queue_ms is not None
                    else self.max_queue_s)
        t0 = _time.perf_counter()
        deadline = _time.monotonic() + budget_s
        admitted = self._wait(w, deadline)
        wait = _time.perf_counter() - t0
        # the previously invisible fetch phase: time QUEUED at the gate
        # before the search starts — without it the per-phase split
        # under-reports contended wall time
        _QUEUE_WAIT.inc(wait)
        flightrec.rec("fetch:queue_wait", t0, wait)
        if not admitted:
            self._rejected.inc()
            self._tenant_metric("vm_tenant_search_rejected_total",
                                tenant).inc()
            # shed load must stay attributable: an instant in the ring
            # ties the rejection into flight captures (the HTTP layer
            # additionally links it into the slow-query log)
            flightrec.instant(
                "gate:rejected",
                arg=f"{tenant[0]}:{tenant[1]} after {wait * 1e3:.0f}ms")
            per_tenant = (f" (tenant quota {quota.limit})"
                          if quota.limit else "")
            raise SearchLimitError(
                f"couldn't start the search within {budget_s:.1f}s: "
                f"{self.limit} concurrent searches are already "
                f"running{per_tenant} (raise VM_SEARCH_CONCURRENCY / "
                f"VM_TENANT_QUOTAS or reduce query load)")
        self._mark_admitted(tenant)

    def _wait(self, w: _Waiter, deadline: float) -> bool:
        """Wait for a grant until `deadline`; True = admitted.  On
        timeout the waiter deregisters itself — unless a grant raced
        the timeout, in which case the slot is kept."""
        if _sched_active():
            # deterministic-scheduler path: spin through the traced
            # lock (each acquire is a turnstile point) instead of
            # parking where the scheduler cannot see the dependency
            while True:
                with self._lock:
                    if w.granted:
                        return True
                    self._grant_locked()
                    if w.granted:
                        return True
                    if _time.monotonic() >= deadline:
                        self._waiters.remove(w)
                        return False
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            try:
                w.q.get(timeout=remaining)
                return True
            except queue.Empty:
                break
        with self._lock:
            if w.granted:
                # the grant raced our timeout: the token is already in
                # the queue — consume it and keep the slot
                try:
                    w.q.get_nowait()
                except queue.Empty:
                    pass
                return True
            self._waiters.remove(w)
        return False

    def _mark_admitted(self, tenant) -> None:
        self._current.inc()
        self._tenant_metric("vm_tenant_search_concurrent", tenant,
                            gauge=True).inc()

    def _release(self, tenant) -> None:
        with self._lock:
            self._global_current -= 1
            n = self._tenant_counts.get(tenant, 0) - 1
            if n > 0:
                self._tenant_counts[tenant] = n
            else:
                self._tenant_counts.pop(tenant, None)
            self._grant_locked()
        self._current.dec()
        self._tenant_metric("vm_tenant_search_concurrent", tenant,
                            gauge=True).dec()

    # -- introspection (tests) --------------------------------------------

    def occupancy(self) -> tuple[int, dict]:
        """(global in-flight, {tenant: in-flight}) snapshot."""
        with self._lock:
            return self._global_current, dict(self._tenant_counts)


class _Admission:
    __slots__ = ("_gate", "_tenant")

    def __init__(self, gate: TenantGate, tenant):
        self._gate = gate
        self._tenant = tenant

    def __enter__(self):
        self._gate._acquire(self._tenant)
        return self

    def __exit__(self, *exc):
        self._gate._release(self._tenant)
        return False


#: the pre-tenant name; the gate with no VM_TENANT_QUOTAS configured is
#: behavior-identical to the old global SearchGate
SearchGate = TenantGate

#: process-wide gate (one storage engine per process in production)
SEARCH_GATE = TenantGate()


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
    counted by ``vm_merge_gate_yields_total``.  Skipped under the
    deterministic scheduler (wall-clock waits would break replay)."""

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
        # pool slot the serve's own fetch tasks are queued behind, and a
        # serving thread that picked up a queued flush task while helping
        # the pool (WorkPool._collect) would block on its OWN serving
        # gauge for the whole budget.  The yield therefore applies only
        # on dedicated flusher/merger threads (and direct callers).
        if getattr(_yield_tls, "pool_worker", False) or \
                getattr(_yield_tls, "serving", 0):
            return
        try:
            budget_ms = float(os.environ.get("VM_MERGE_YIELD_MS", "250"))
        except ValueError:
            budget_ms = 250.0
        if budget_ms <= 0 or _sched_active() or not serving_busy():
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
