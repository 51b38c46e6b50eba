"""The port's lock-order tracer, race sanitizer and deterministic scheduler
(``victoriametrics_tpu_torch/devtools/locktrace.py``, ``racetrace.py``,
``sched.py``) against the reference's: the ``TestLockTrace``,
``TestRaceTrace`` and ``TestDeterministicScheduler`` cases of
``tests/test_stress_race.py`` and the scheduler cases of
``tests/test_tenant_gate.py``, each written once and run on both packages
through the ``P`` fixture (``ref`` = the JAX package, ``port`` = the
PyTorch one), on each package's own storage, mergeset, partition and work
pool.  One seed and one workload give the same switch-point sequence and
the same race reports in both packages.  The port's smokes
(``devtools/*_overhead.py``, ``*_smoke.py``) exit 0.

Two cases are the reference's copies and fail for the reference's own
recorded reason (their data sits at July 2025, outside the 13-month
retention): ``test_concurrent_ingest_query_flush_snapshot`` and
``TestLockTrace::test_storage_lock_hierarchy_under_tracing``.  They run on
the port only here; the reference runs its own in
``tests/test_stress_race.py``."""

import importlib
import os
import queue
import random
import subprocess
import sys
import threading
import time
import types
import warnings

import numpy as np
import pytest

pytestmark = pytest.mark.race  # the tools/race_torch.sh selection

needs_native = pytest.mark.requires_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_753_700_000_000
DURATION_S = 8.0
N_WRITERS = 2
SERIES_PER_WRITER = 24


def _package(name: str):
    root = "victoriametrics_tpu" if name == "ref" else \
        "victoriametrics_tpu_torch"

    def mod(rel):
        return importlib.import_module(f"{root}.{rel}")
    P = types.SimpleNamespace(
        name=name, root=root,
        locktrace=mod("devtools.locktrace"),
        racetrace=mod("devtools.racetrace"), sched=mod("devtools.sched"),
        metrics=mod("utils.metrics"), workpool=mod("utils.workpool"),
        native=mod("native"), mergeset=mod("storage.mergeset"),
        partition=mod("storage.partition"), tsid=mod("storage.tsid"),
        Storage=mod("storage.storage").Storage,
        filters_from_dict=mod("storage.tag_filters").filters_from_dict,
        exec_query=mod("query.exec").exec_query,
        EvalConfig=mod("query.types").EvalConfig)
    P.TracedLock = P.locktrace.TracedLock
    P.LockOrderError = P.locktrace.LockOrderError
    P.LockHeldTooLongWarning = P.locktrace.LockHeldTooLongWarning
    P.RaceWarning = P.racetrace.RaceWarning
    P.DeterministicScheduler = P.sched.DeterministicScheduler
    P.make_lock = P.locktrace.make_lock

    @P.racetrace.traced_fields("n")
    class _Scratch:
        """The seeded-race fixture: one traced int, no lock."""

        def __init__(self):
            self.n = 0
            self.d = {}

    P.Scratch = _Scratch
    return P


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def P(request):
    return REF if request.param == "ref" else PORT


def _val(ts_arr):
    return (ts_arr % 1_000_000_000).astype(np.float64)


def _race_on(P, monkeypatch):
    """P's sanitizer alone on the stdlib seams.  Both packages' patch the
    same seams and read the same VMT_RACETRACE, which tools/race_torch.sh
    sets: each is re-enabled over the other's after the test, in import
    order."""
    monkeypatch.setenv("VMT_LOCKTRACE_MAX_HOLD_MS", "60000")
    # the port's saved seams are the stdlib's own (racetrace._stdlib); the
    # reference's may be the port's wrappers, when the port came first
    for seam in ("_orig_thread_start", "_orig_thread_join",
                 "_orig_queue_put", "_orig_queue_get"):
        monkeypatch.setattr(REF.racetrace, seam,
                            getattr(PORT.racetrace, seam))
    was = [R.racetrace.enabled() for R in (REF, PORT)]
    PORT.racetrace.disable()
    REF.racetrace.disable()
    P.racetrace.enable()
    P.racetrace.reset()
    return was


def _race_off(P, was):
    P.racetrace.reset()
    P.racetrace.disable()
    for R, on in zip((REF, PORT), was):
        if on:
            R.racetrace.enable()


@pytest.fixture
def race_on(P, monkeypatch):
    """The package's sanitizer on for the test body (no-op teardown when
    the run came in with VMT_RACETRACE=1)."""
    was = _race_on(P, monkeypatch)
    yield P.racetrace
    _race_off(P, was)


# -- the reference's storage stress, on the port ----------------------------

class _Stress:
    def __init__(self, P, storage):
        self.P = P
        self.storage = storage
        self.stop = threading.Event()
        self.errors: list[BaseException] = []
        self.appended = [0] * N_WRITERS
        self.lock = threading.Lock()

    def guard(self, fn):
        def run():
            rng = random.Random(id(fn) & 0xFFFF)
            try:
                while not self.stop.is_set():
                    fn(rng)
                    time.sleep(rng.uniform(0, 0.01))
            except BaseException as e:  # noqa: BLE001 - harness boundary
                self.errors.append(e)
                self.stop.set()
        return run

    def writer(self, w):
        step = [0]
        keys = [f'stress{{w="{w}",i="{i}"}}'.encode()
                for i in range(SERIES_PER_WRITER)]
        keybuf = b"".join(keys)
        klens = np.fromiter((len(k) for k in keys), np.int64, len(keys))
        koffs = np.concatenate([[0], np.cumsum(klens)[:-1]])

        def run(rng):
            k = rng.randint(1, 6)
            base = T0 + step[0] * 15_000
            step[0] += k
            ts = (base + np.arange(k, dtype=np.int64)[None, :] * 15_000 +
                  w)
            ts = np.broadcast_to(ts, (len(keys), k)).reshape(-1).copy()
            cr = self.P.native.ColumnarRows(
                keybuf, np.repeat(koffs, k), np.repeat(klens, k),
                ts, _val(ts))
            self.storage.add_rows_columnar(cr)
            with self.lock:
                self.appended[w] += k
        return run

    def reader(self, rng):
        w = rng.randrange(N_WRITERS)
        cols = self.storage.search_columns(
            self.P.filters_from_dict({"__name__": "stress", "w": str(w)}),
            T0 - 10**6, T0 + 10**10)
        for s in range(cols.n_series):
            n = int(cols.counts[s])
            ts = cols.ts[s, :n]
            vals = cols.vals[s, :n]
            assert bool((np.diff(ts) > 0).all()), \
                "timestamps not strictly increasing"
            np.testing.assert_array_equal(vals, _val(ts))

    def querier(self, rng):
        rows = self.P.exec_query(
            self.P.EvalConfig(start=T0, end=T0 + 4_000_000, step=60_000,
                              storage=self.storage, tpu=None,
                              disable_cache=bool(rng.getrandbits(1))),
            'count(last_over_time(stress[10m]))')
        for ts in rows:
            v = ts.values[np.isfinite(ts.values)]
            assert bool((v <= N_WRITERS * SERIES_PER_WRITER).all())

    def flusher(self, rng):
        if rng.random() < 0.3:
            self.storage.force_merge()
        else:
            self.storage.force_flush()

    def snapshotter(self, rng):
        name = self.storage.create_snapshot()
        time.sleep(rng.uniform(0, 0.02))
        assert self.storage.delete_snapshot(name)

    def deleter(self, rng):
        self.storage.add_rows(
            [({"__name__": "victim", "i": str(rng.randrange(4))},
              T0 + rng.randrange(10**6), 1.0)])
        self.storage.delete_series(
            self.P.filters_from_dict({"__name__": "victim"}))


@needs_native
def test_concurrent_ingest_query_flush_snapshot(tmp_path):
    """The reference's stress, on the port's storage (its data sits at
    July 2025; it fails as the reference's does, ROADMAP §C)."""
    P = PORT
    s = P.Storage(str(tmp_path / "s"))
    st = _Stress(P, s)
    workers = [st.guard(st.writer(w)) for w in range(N_WRITERS)]
    workers += [st.guard(st.reader), st.guard(st.querier),
                st.guard(st.flusher), st.guard(st.snapshotter),
                st.guard(st.deleter)]
    threads = [threading.Thread(target=f, daemon=True) for f in workers]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    while time.monotonic() - t0 < DURATION_S and not st.stop.is_set():
        time.sleep(0.1)
    st.stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "stress worker wedged (deadlock?)"
    if st.errors:
        raise st.errors[0]
    s.force_flush()
    s.force_merge()
    for w in range(N_WRITERS):
        cols = s.search_columns(
            P.filters_from_dict({"__name__": "stress", "w": str(w)}),
            T0 - 10**6, T0 + 10**10)
        assert cols.n_series == SERIES_PER_WRITER
        expected = st.appended[w]
        for i in range(cols.n_series):
            n = int(cols.counts[i])
            assert n == expected, (w, i, n, expected)
            ts = cols.ts[i, :n]
            np.testing.assert_array_equal(cols.vals[i, :n], _val(ts))
    s.close()


# -- runtime lock-order tracing (devtools/locktrace) -------------------------

class TestLockTrace:
    def test_cycle_detected_fails_fast(self, P):
        g = P.locktrace.LockGraph()
        a = P.TracedLock("stress.A", graph=g, mode="raise")
        b = P.TracedLock("stress.B", graph=g, mode="raise")
        phase1_done = threading.Event()
        errors: list[BaseException] = []

        def t1():
            with a:
                with b:
                    pass
            phase1_done.set()

        def t2():
            assert phase1_done.wait(10)
            try:
                with b:
                    with a:
                        pass
            except P.LockOrderError as e:
                errors.append(e)

        threads = [threading.Thread(target=t1, daemon=True),
                   threading.Thread(target=t2, daemon=True)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
            assert not t.is_alive(), "locktrace test wedged"
        assert time.monotonic() - t0 < 15
        assert len(errors) == 1
        assert "stress.A" in str(errors[0]) and "stress.B" in str(errors[0])

    def test_cycle_counted_in_registry(self, P):
        """A detected cycle moves the package's vm_locktrace_cycles_total
        (what a traced server exposes on /metrics)."""
        c = P.metrics.REGISTRY.counter("vm_locktrace_cycles_total")
        before = c.get()
        g = P.locktrace.LockGraph()
        a = P.TracedLock("cnt.A", graph=g, mode="warn")
        b = P.TracedLock("cnt.B", graph=g, mode="warn")
        with a:
            with b:
                pass
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with b:
                with a:
                    pass
        assert c.get() == before + 1

    def test_consistent_order_is_quiet(self, P):
        g = P.locktrace.LockGraph()
        a = P.TracedLock("q.A", graph=g)
        b = P.TracedLock("q.B", graph=g)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert g.edges() == {"q.A": {"q.B"}}

    def test_rlock_reentry_and_nonreentrant_self_deadlock(self, P):
        g = P.locktrace.LockGraph()
        r = P.TracedLock("q.R", graph=g, reentrant=True)
        with r:
            with r:
                assert r.locked()
        plain = P.TracedLock("q.P", graph=g)
        with plain:
            with pytest.raises(P.LockOrderError, match="re-acquired"):
                plain.acquire()

    def test_failed_trylock_leaves_no_phantom_edge(self, P):
        g = P.locktrace.LockGraph()
        a = P.TracedLock("t.A", graph=g)
        b = P.TracedLock("t.B", graph=g)
        acquired, release = threading.Event(), threading.Event()

        def holder():
            with b:
                acquired.set()
                release.wait(10)

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        assert acquired.wait(10)
        with a:
            assert b.acquire(blocking=False) is False
        release.set()
        t.join(10)
        assert "t.B" not in g.edges().get("t.A", set())
        with b:
            with a:
                pass

    def test_cycle_abort_rolls_back_partial_edges(self, P):
        g = P.locktrace.LockGraph()
        a = P.TracedLock("r.A", graph=g)
        b = P.TracedLock("r.B", graph=g)
        c = P.TracedLock("r.C", graph=g)
        with c:
            with b:
                pass
        with a:
            with b:
                with pytest.raises(P.LockOrderError):
                    c.acquire()
        assert "r.C" not in g.edges().get("r.A", set())
        with c:
            with a:
                pass

    def test_cross_thread_handoff_reacquire(self, P):
        lk = P.TracedLock("t.H", graph=P.locktrace.LockGraph())
        lk.acquire()
        t = threading.Thread(target=lk.release)
        t.start()
        t.join()
        lk.acquire()
        lk.release()

    def test_held_too_long_warns(self, P):
        lk = P.TracedLock("q.slow", graph=P.locktrace.LockGraph(),
                          max_hold_ms=1.0)
        with pytest.warns(P.LockHeldTooLongWarning):
            with lk:
                time.sleep(0.02)

    def test_factory_injects_traced_locks(self, P, monkeypatch):
        monkeypatch.setenv("VMT_LOCKTRACE", "1")
        assert isinstance(P.locktrace.make_lock("x"), P.TracedLock)
        assert isinstance(P.locktrace.make_rlock("x"), P.TracedLock)
        monkeypatch.setenv("VMT_LOCKTRACE", "0")
        if P.racetrace.enabled():
            assert isinstance(P.locktrace.make_lock("x"), P.TracedLock)
        else:
            assert isinstance(P.locktrace.make_lock("x"),
                              type(threading.Lock()))

    def test_traced_factory_exports_zero_counters(self, monkeypatch):
        """The port creates its vm_locktrace_* counters at 0 with its first
        traced lock, so a clean traced server shows its zeros."""
        monkeypatch.setenv("VMT_LOCKTRACE", "warn")
        PORT.locktrace.make_lock("x")
        text = PORT.metrics.REGISTRY.write_prometheus()
        for name in ("vm_locktrace_cycles_total",
                     "vm_locktrace_hold_warnings_total"):
            assert f"\n{name} " in "\n" + text, name

    @needs_native
    def test_storage_lock_hierarchy_under_tracing(self, tmp_path,
                                                  monkeypatch):
        """The reference's case on the port's storage (its data sits at
        July 2025; it fails as the reference's does, ROADMAP §C)."""
        P = PORT
        monkeypatch.setenv("VMT_LOCKTRACE", "1")
        s = P.Storage(str(tmp_path / "lt"))
        t0 = 1_753_700_000_000
        s.add_rows([({"__name__": "lt", "i": str(i)}, t0 + i * 1000, 1.0)
                    for i in range(32)])
        s.force_flush()
        s.force_merge()
        assert len(s.search_series(
            P.filters_from_dict({"__name__": "lt"}), t0 - 1,
            t0 + 10**6)) == 32
        s.close()

    @needs_native
    def test_storage_and_rpc_run_clean_under_tracing(self, P, tmp_path,
                                                     monkeypatch):
        """The package's storage behind its RPC server and a cluster
        client, every lock traced with cycles raising: ingest, flush,
        merge and a search round trip raise no LockOrderError, move no
        cycle counter and leave no race report (data at a recent hour)."""
        monkeypatch.setenv("VMT_LOCKTRACE", "1")
        rpc = importlib.import_module(f"{P.root}.parallel.rpc")
        capi = importlib.import_module(f"{P.root}.parallel.cluster_api")
        cycles = P.metrics.REGISTRY.counter("vm_locktrace_cycles_total")
        before = cycles.get()
        was = _race_on(P, monkeypatch)
        try:
            st = P.Storage(str(tmp_path / "n"))
            handlers = capi.make_storage_handlers(st)
            ins = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_INSERT, handlers)
            sel = rpc.RPCServer("127.0.0.1", 0, rpc.HELLO_SELECT, handlers)
            ins.start()
            sel.start()
            cl = capi.ClusterStorage([capi.StorageNodeClient(
                "127.0.0.1", ins.port, sel.port)])
            t0 = (int(time.time() * 1000) // 3_600_000 - 1) * 3_600_000
            try:
                cl.add_rows([({"__name__": "tr", "i": str(i)},
                              t0 + j * 15_000, float(j))
                             for i in range(16) for j in range(8)])
                st.force_flush()
                st.force_merge()
                got = cl.search_series(
                    P.filters_from_dict({"__name__": "tr"}), t0 - 1,
                    t0 + 10**6)
                assert len(got) == 16
            finally:
                for n in cl.nodes:
                    n.close()
                ins.stop()
                sel.stop()
                st.close()
            assert cycles.get() == before
            assert P.racetrace.reports() == [], "\n\n".join(
                r.format() for r in P.racetrace.reports())
        finally:
            _race_off(P, was)


# -- happens-before race sanitizer (devtools/racetrace) ----------------------

class TestRaceTrace:
    def test_seeded_race_is_detected_with_both_stacks(self, P, race_on):
        b = P.Scratch()

        def bump():
            for _ in range(4):
                b.n = b.n + 1
                b.d["k"] = b.d.get("k", 0) + 1

        ts = [threading.Thread(target=bump) for _ in range(2)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.RaceWarning)
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        reps = P.racetrace.reports()
        assert reps, "unsynchronized cross-thread access not reported"
        r = reps[0]
        assert r.field == "n" and r.cls_name == "_Scratch"
        assert r.kind in ("write-write", "read-write", "write-read")
        first = "".join(str(f) for f in r.first_stack.format())
        second = "".join(str(f) for f in r.second_stack.format())
        assert "test_torch_tracers" in first and "bump" in first
        assert "test_torch_tracers" in second and "bump" in second
        assert r.first_thread != r.second_thread

    def test_report_counted_in_registry(self, P, race_on):
        c = P.metrics.REGISTRY.counter("vm_race_reports_total")
        before = c.get()
        b = P.Scratch()
        ts = [threading.Thread(target=lambda: setattr(b, "n", b.n + 1))
              for _ in range(2)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.RaceWarning)
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        assert c.get() > before

    def test_make_lock_synchronized_twin_is_clean(self, P, race_on):
        b = P.Scratch()
        lk = P.make_lock("race.scratch._lock")
        assert isinstance(lk, P.TracedLock)

        def bump():
            for _ in range(8):
                with lk:
                    b.n = b.n + 1

        ts = [threading.Thread(target=bump) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert P.racetrace.reports() == []
        assert b.n == 24

    def test_queue_handoff_is_clean(self, P, race_on):
        b = P.Scratch()
        q = queue.Queue()

        def producer():
            b.n = 41
            q.put("ready")

        def consumer():
            q.get()
            b.n = b.n + 1

        t1 = threading.Thread(target=producer)
        t2 = threading.Thread(target=consumer)
        t1.start()
        t2.start()
        t1.join()
        t2.join()
        assert P.racetrace.reports() == []
        assert b.n == 42

    def test_thread_start_join_create_edges(self, P, race_on):
        b = P.Scratch()
        b.n = 1

        def child():
            b.n += 1

        t = threading.Thread(target=child)
        t.start()
        t.join()
        b.n += 1
        assert P.racetrace.reports() == []
        assert b.n == 3

    def test_disabled_is_plain_attribute(self, P, monkeypatch):
        if P.racetrace.enabled():
            pytest.skip("suite running under VMT_RACETRACE=1")
        monkeypatch.setenv("VMT_LOCKTRACE", "0")
        assert not isinstance(P.Scratch.__dict__.get("n"),
                              P.racetrace._TracedField)
        assert not isinstance(
            P.partition.Partition.__dict__.get("_pending"),
            P.racetrace._TracedField)
        assert isinstance(P.make_lock("x"), type(threading.Lock()))

    def test_enable_exports_zero_report_counter(self, monkeypatch):
        was = _race_on(PORT, monkeypatch)
        try:
            text = PORT.metrics.REGISTRY.write_prometheus()
            assert "\nvm_race_reports_total " in "\n" + text
        finally:
            _race_off(PORT, was)

    def test_port_traces_the_same_fields(self):
        """The port declares the same traced fields on the same classes
        as the reference (storage, mergeset, index, table, RPC, the tile
        cache), read from the decorators in each package's source."""
        import ast

        def declared(P):
            out = set()
            top = os.path.join(REPO, P.root)
            for root, dirs, files in os.walk(top):
                dirs[:] = [d for d in dirs if d not in ("_build", "devtools")]
                for f in files:
                    if not f.endswith(".py"):
                        continue
                    with open(os.path.join(root, f), encoding="utf-8") as fh:
                        tree = ast.parse(fh.read())
                    for node in ast.walk(tree):
                        if not isinstance(node, ast.ClassDef):
                            continue
                        for d in node.decorator_list:
                            if isinstance(d, ast.Call) and getattr(
                                    d.func, "id", "") == "traced_fields":
                                out.update((node.name, a.value)
                                           for a in d.args)
            return sorted(out)
        assert declared(PORT) == declared(REF)
        assert ("TileCache", "_entries") in declared(PORT)


# -- deterministic interleaving scheduler (devtools/sched) -------------------

def _racy_run(P, seed):
    P.racetrace.reset()
    sched = P.DeterministicScheduler(seed=seed, change_prob=0.3)
    b = P.Scratch()

    def bump():
        for _ in range(6):
            b.n = b.n + 1

    for i in range(3):
        sched.spawn(f"w{i}", bump)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", P.RaceWarning)
        sched.run(timeout=30)
    pairs = [(r.field, r.kind, r.first_thread, r.second_thread)
             for r in P.racetrace.reports()]
    return sched.trace, pairs


def _locked_run(P, seed):
    P.racetrace.reset()
    sched = P.DeterministicScheduler(seed=seed, change_prob=0.3)
    b = P.Scratch()
    lk = P.make_lock("sched.locked._lock")

    def bump():
        for _ in range(6):
            with lk:
                b.n = b.n + 1

    for i in range(3):
        sched.spawn(f"w{i}", bump)
    sched.run(timeout=30)
    return sched.trace, b.n, P.racetrace.reports()


def _pool_run(P, pool, seed):
    P.racetrace.reset()
    sched = P.DeterministicScheduler(seed=seed, change_prob=0.3)
    b = P.Scratch()
    lk = P.make_lock("sched.pool._lock")
    logs = {}

    def body(w):
        def job(j):
            with lk:
                b.n = b.n + 1
            return (w, j, threading.current_thread().name)
        logs[w] = pool.run([lambda j=j: job(j) for j in range(4)])

    for i in range(3):
        sched.spawn(f"w{i}", body, i)
    sched.run(timeout=60)
    return sched.trace, b.n, dict(logs), P.racetrace.reports()


class TestDeterministicScheduler:
    def test_same_seed_replays_same_interleaving_and_reports(self, P,
                                                             race_on):
        t1, p1 = _racy_run(P, 1234)
        t2, p2 = _racy_run(P, 1234)
        assert t1 == t2
        assert p1 == p2
        assert p1, "the seeded racy workload must be flagged"
        assert len(t1) > 10

    def test_locked_workload_is_clean_and_deterministic(self, P, race_on):
        t1, n1, r1 = _locked_run(P, 77)
        t2, n2, r2 = _locked_run(P, 77)
        assert t1 == t2 and n1 == n2 == 18
        assert r1 == [] and r2 == []
        assert any(x.endswith("/blocked") for x in t1)

    def test_workpool_runs_inline_under_scheduler(self, P, race_on):
        pool = P.workpool.WorkPool(workers=4)
        t1, n1, l1, r1 = _pool_run(P, pool, 321)
        t2, n2, l2, r2 = _pool_run(P, pool, 321)
        assert t1 == t2 and n1 == n2 == 12
        assert l1 == l2
        for w, got in l1.items():
            assert [g[:2] for g in got] == [(w, j) for j in range(4)]
            assert all(g[2] == f"w{w}" for g in got)
        assert r1 == [] and r2 == []
        assert pool._threads == []

    @needs_native
    @pytest.mark.parametrize("assemble", ["1", "0"])
    def test_parallel_fetch_stress_racetrace_clean(self, P, tmp_path,
                                                   race_on, monkeypatch,
                                                   assemble):
        monkeypatch.setenv("VM_SEARCH_WORKERS", "2")
        monkeypatch.setenv("VM_NATIVE_ASSEMBLE", assemble)
        s = P.Storage(str(tmp_path / "pf"))
        keys = [f'pfetch{{i="{i}"}}'.encode() for i in range(16)]
        keybuf = b"".join(keys)
        klens = np.fromiter((len(k) for k in keys), np.int64, len(keys))
        koffs = np.concatenate([[0], np.cumsum(klens)[:-1]])

        def append(step, k):
            ts = (T0 + (step + np.arange(k, dtype=np.int64))[None, :]
                  * 15_000)
            ts = np.broadcast_to(ts, (len(keys), k)).reshape(-1).copy()
            s.add_rows_columnar(P.native.ColumnarRows(
                keybuf, np.repeat(koffs, k), np.repeat(klens, k),
                ts, _val(ts)))

        for p in range(3):
            append(p * 8, 8)
            s.force_flush()

        stop = threading.Event()
        errors: list[BaseException] = []

        def guard(fn):
            def run():
                try:
                    i = 0
                    while not stop.is_set() and i < 40:
                        fn(i)
                        i += 1
                except BaseException as e:  # noqa: BLE001 — harness edge
                    errors.append(e)
                    stop.set()
            return run

        def reader(_i):
            cols = s.search_columns(
                P.filters_from_dict({"__name__": "pfetch"}),
                T0 - 10**6, T0 + 10**10)
            for r in range(cols.n_series):
                n = int(cols.counts[r])
                np.testing.assert_array_equal(cols.vals[r, :n],
                                              _val(cols.ts[r, :n]))

        def writer(i):
            append(24 + i, 2)

        def flusher(i):
            if i % 4 == 0:
                s.force_flush()

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.LockHeldTooLongWarning)
            threads = [threading.Thread(target=f, daemon=True)
                       for f in (guard(reader), guard(reader),
                                 guard(writer), guard(flusher))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "parallel fetch stress wedged"
        if errors:
            raise errors[0]
        assert P.racetrace.reports() == [], "\n\n".join(
            r.format() for r in P.racetrace.reports())
        s.close()

    @needs_native
    def test_sharded_ingest_query_stress_racetrace_clean(self, P, tmp_path,
                                                         race_on,
                                                         monkeypatch):
        monkeypatch.setenv("VM_INGEST_SHARDS", "4")
        monkeypatch.setenv("VM_SEARCH_WORKERS", "2")
        s = P.Storage(str(tmp_path / "si"))
        keys = [f'shing{{i="{i}"}}'.encode() for i in range(16)]
        keybuf = b"".join(keys)
        klens = np.fromiter((len(k) for k in keys), np.int64, len(keys))
        koffs = np.concatenate([[0], np.cumsum(klens)[:-1]])

        stop = threading.Event()
        errors: list[BaseException] = []

        def guard(fn):
            def run():
                try:
                    i = 0
                    while not stop.is_set() and i < 30:
                        fn(i)
                        i += 1
                except BaseException as e:  # noqa: BLE001 — harness edge
                    errors.append(e)
                    stop.set()
            return run

        def col_writer(i):
            k = 4
            ts = (T0 + (i * k + np.arange(k, dtype=np.int64))[None, :]
                  * 15_000)
            ts = np.broadcast_to(ts, (len(keys), k)).reshape(-1).copy()
            s.add_rows_columnar(P.native.ColumnarRows(
                keybuf, np.repeat(koffs, k), np.repeat(klens, k),
                ts, _val(ts)))

        def leg_writer(i):
            ts = T0 + i * 15_000 + 7_000
            s.add_rows([({"__name__": "shleg", "i": str(j)}, ts,
                         float(ts % 1_000_000_000)) for j in range(8)])

        def reader(_i):
            cols = s.search_columns(
                P.filters_from_dict({"__name__": "shing"}),
                T0 - 10**6, T0 + 10**10)
            for r in range(cols.n_series):
                n = int(cols.counts[r])
                np.testing.assert_array_equal(cols.vals[r, :n],
                                              _val(cols.ts[r, :n]))

        def flusher(i):
            if i % 5 == 0:
                s.force_flush()

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.LockHeldTooLongWarning)
            threads = [threading.Thread(target=f, daemon=True)
                       for f in (guard(col_writer), guard(col_writer),
                                 guard(leg_writer), guard(reader),
                                 guard(flusher))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "sharded ingest stress wedged"
        if errors:
            raise errors[0]
        assert P.racetrace.reports() == [], "\n\n".join(
            r.format() for r in P.racetrace.reports())
        s.close()

    @needs_native
    def test_sharded_ingest_inline_under_scheduler(self, P, tmp_path,
                                                   race_on, monkeypatch):
        monkeypatch.setenv("VM_INGEST_SHARDS", "4")
        s = P.Storage(str(tmp_path / "sched"))

        def writer(w):
            for j in range(5):
                s.add_rows([({"__name__": "sw", "w": str(w), "j": str(j)},
                             T0 + j * 1000 + w, float(j))])

        sched = P.DeterministicScheduler(seed=77, change_prob=0.2)
        sched.spawn("w0", writer, 0)
        sched.spawn("w1", writer, 1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.LockHeldTooLongWarning)
            sched.run(timeout=120)
        assert P.racetrace.reports() == [], "\n\n".join(
            r.format() for r in P.racetrace.reports())
        res = s.search_series(P.filters_from_dict({"__name__": "sw"}),
                              T0 - 10**6, T0 + 10**9)
        assert len(res) == 10
        s.close()

    @needs_native
    def test_partition_and_mergeset_stress_clean_under_scheduler(
            self, P, tmp_path, race_on):
        part = P.partition.Partition(str(tmp_path / "p"), "2025_07")
        mtab = P.mergeset.Table(str(tmp_path / "m"))
        t0 = 1_753_700_000_000

        def writer(w):
            for i in range(6):
                tsid = P.tsid.TSID(metric_group_id=1, metric_id=w * 100 + i)
                part.add_rows([(tsid, t0 + i * 1000 + w, float(i))])
                mtab.add_items([b"k%02d_%03d" % (w, i)])

        def flusher():
            for _ in range(3):
                part.flush_to_disk()
                mtab.flush_to_disk()

        def reader():
            for _ in range(4):
                _ = part.rows
                list(part.iter_blocks())
                mtab.first_with_prefix(b"k00")
                list(mtab.search_prefix(b"k01"))

        sched = P.DeterministicScheduler(seed=4242, change_prob=0.2)
        sched.spawn("w0", writer, 0)
        sched.spawn("w1", writer, 1)
        sched.spawn("flush", flusher)
        sched.spawn("read", reader)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", P.LockHeldTooLongWarning)
            sched.run(timeout=120)
        assert P.racetrace.reports() == [], "\n\n".join(
            r.format() for r in P.racetrace.reports())
        part.flush_to_disk()
        assert part.rows == 12
        assert sum(1 for _ in mtab.iter_from(b"")) == 12
        part.close()
        mtab.close()


# -- one seed, one workload: the same schedule in both packages --------------

def _both(monkeypatch, run):
    out = []
    for P in (REF, PORT):
        was = _race_on(P, monkeypatch)
        try:
            out.append(run(P))
        finally:
            _race_off(P, was)
    return out


@pytest.mark.parametrize("seed", [1234, 7])
def test_racy_workload_same_schedule_and_reports_in_both(monkeypatch, seed):
    (rt, rp), (pt, pp) = _both(monkeypatch, lambda P: _racy_run(P, seed))
    assert pt == rt
    assert pp == rp and pp


def test_locked_workload_same_schedule_in_both(monkeypatch):
    (rt, rn, rr), (pt, pn, pr) = _both(monkeypatch,
                                       lambda P: _locked_run(P, 77))
    assert pt == rt and pn == rn == 18 and pr == rr == []


def test_workpool_same_schedule_in_both(monkeypatch):
    ref, port = _both(monkeypatch, lambda P: _pool_run(
        P, P.workpool.WorkPool(workers=4), 321))
    assert port[0] == ref[0] and port[1] == ref[1] == 12
    assert port[2] == ref[2] and port[3] == ref[3] == []


# -- the tenant gate under the scheduler (tests/test_tenant_gate.py) ---------

def _gate_stress(P, seed):
    P.racetrace.reset()
    sched = P.DeterministicScheduler(seed=seed, change_prob=0.2,
                                     step_timeout=2.0)
    gate = P.workpool.TenantGate(
        limit=2, max_queue_ms=60_000,
        quotas={(1, 0): P.workpool.TenantQuota(1),
                (2, 0): P.workpool.TenantQuota(1)})
    peak = {"global": 0, (1, 0): 0, (2, 0): 0}
    done = []
    lk = threading.Lock()

    def worker(tenant, tag):
        for _ in range(3):
            with gate.admit(tenant):
                g, per = gate.occupancy()
                with lk:
                    peak["global"] = max(peak["global"], g)
                    peak[tenant] = max(peak[tenant], per.get(tenant, 0))
        done.append(tag)

    for i in range(2):
        sched.spawn(f"a{i}", worker, (1, 0), f"a{i}")
        sched.spawn(f"b{i}", worker, (2, 0), f"b{i}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sched.run(timeout=60)
    return peak, sorted(done), P.racetrace.reports(), sched.trace


class TestTenantGateRace:
    def test_quota_never_exceeded_and_starvation_free(self, P, race_on):
        peak, done, reports, _ = _gate_stress(P, 31337)
        assert peak["global"] <= 2
        assert peak[(1, 0)] <= 1
        assert peak[(2, 0)] <= 1
        assert done == ["a0", "a1", "b0", "b1"]
        gate_races = [r for r in reports if "TenantGate" in str(r.field)]
        assert not gate_races, gate_races

    def test_same_seed_same_outcome(self, P, race_on):
        assert _gate_stress(P, 99)[:2] == _gate_stress(P, 99)[:2]


def test_tenant_gate_same_schedule_in_both(monkeypatch):
    ref, port = _both(monkeypatch, lambda P: _gate_stress(P, 99))
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[3] == ref[3]


# -- the port's smokes -------------------------------------------------------

# the overhead gates run at their 2 % in tools/lint_torch.sh; here (as
# tests/test_cost_profiler.py's tier-1 copy does) a loaded test box only
# checks that each harness works, at a loose budget
_LOOSE = {"VM_FLIGHT_SMOKE_PCT": "50", "VM_PROFILE_SMOKE_PCT": "50",
          "VM_SELFSCRAPE_SMOKE_PCT": "50", "VM_SELFSCRAPE_SMOKE_MS": "3000",
          "VM_MATSTREAM_SMOKE_MS": "50"}

SMOKES = ("flight_overhead", "profile_overhead", "matstream_overhead",
          "selfscrape_overhead", "downsample_smoke", "reshard_smoke",
          "compile_cache_smoke")


@pytest.mark.parametrize("smoke", SMOKES)
def test_port_smoke_exits_zero(smoke, tmp_path):
    env = dict(os.environ, **_LOOSE)
    env.pop("VMT_RACETRACE", None)
    p = subprocess.run(
        [sys.executable, "-m", f"victoriametrics_tpu_torch.devtools.{smoke}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    if smoke == "compile_cache_smoke" and \
            "build-cache smoke: SKIP" in p.stdout:
        assert "nvcc not found" in p.stdout     # the loud skip, no card
    else:
        assert "FAIL" not in p.stdout


# -- the rolling window under concurrent refreshes ---------------------------

def _roll_store(tmp_path, S=64, N=120):
    from victoriametrics_tpu_torch.storage.storage import Storage
    day = 86_400_000
    t0 = (int(time.time() * 1000) - 2 * day) // day * day
    rng = np.random.default_rng(31)
    rows = []
    for i in range(S):
        ts = t0 + np.arange(N, dtype=np.int64) * 15_000 + \
            rng.integers(-2000, 2001, N)
        vals = np.cumsum(rng.integers(0, 50, N)).astype(float)
        lab = {"__name__": "roll", "instance": f"h{i % 16}", "id": str(i)}
        rows.extend(zip([lab] * N, ts.tolist(), vals.tolist()))
    store = Storage(str(tmp_path / "roll"))
    store.add_rows(rows)
    return store, t0 + (N - 1) * 15_000, rng


def test_two_clients_rolling_one_window(tmp_path, monkeypatch):
    """Two refreshes of one resident window at once, one step and two
    steps on (two dashboard clients a scrape apart): each answer, and the
    window's later refresh, equals the host evaluator.  Both refreshes are
    held before their RingBlock commit until the other arrives, so that
    without the tile's lock (cuda_engine.RollingTile.lock) both shift the
    ring from the same state: the second commit's tail no longer fits
    (a 422 "could not broadcast") or lands on the wrong columns."""
    from victoriametrics_tpu_torch.query import cuda_engine as ce
    from victoriametrics_tpu_torch.query import rollup_result_cache as rrc
    store, last, rng = _roll_store(tmp_path)
    engine = ce.CUDAEngine(device="cpu", min_series=4)
    q = "sum by (instance)(rate(roll[5m]))"
    step, width = 60_000, 45 * 60_000

    def answer(end, tpu):
        ec = PORT.EvalConfig(start=end - width, end=end, step=step,
                             storage=store, tpu=tpu,
                             disable_cache=tpu is None)
        return {r.metric_name.to_dict()["instance"]: r.values
                for r in PORT.exec_query(ec, q)}

    def same(got, end):
        host = answer(end, None)
        assert sorted(got) == sorted(host)
        for k in host:
            np.testing.assert_allclose(got[k], host[k], rtol=1e-12,
                                       atol=0.0, equal_nan=True)

    try:
        end0 = last - last % step
        answer(end0, engine)                     # cold: K1 + K2, filed
        rows = []
        for i in range(64):
            t = last + 15_000 * np.arange(1, 9) + rng.integers(0, 2000)
            rows += [({"__name__": "roll", "instance": f"h{i % 16}",
                       "id": str(i)}, int(x), 1e4 + 7 * k)
                     for k, x in enumerate(t)]
        store.add_rows(rows)
        ends = (end0 + step, end0 + 2 * step)
        barrier = threading.Barrier(2, timeout=2.0)
        real = rrc.RingBlock.commit

        def commit(self, *a, **k):
            try:
                barrier.wait()
            except threading.BrokenBarrierError:
                pass                 # the other refresh waits on the lock
            return real(self, *a, **k)
        monkeypatch.setattr(rrc.RingBlock, "commit", commit)
        got, errors = [None, None], []

        def refresh(i):
            try:
                got[i] = answer(ends[i], engine)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)
        ths = [threading.Thread(target=refresh, args=(i,)) for i in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        monkeypatch.setattr(rrc.RingBlock, "commit", real)
        assert not errors, errors
        for g, end in zip(got, ends):
            same(g, end)
        same(answer(ends[1], engine), ends[1])
    finally:
        store.close()


# -- chip_smoke.py's tooling phase, rehearsed on the CPU ---------------------

_CPU_ATTACH = '''
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.utils import device_probe as dp


def probe_backend(timeout_s=600.0):
    r = dp.ProbeResult.__new__(dp.ProbeResult)
    r.platform, r.n, r.error, r.stack, r.elapsed_s, r.name = \\
        "cuda", 1, None, None, 0.0, "cpu"
    return r


class CPUEngine(ce.CUDAEngine):
    def __init__(self, *a, **k):
        k.pop("mesh", None)
        super().__init__(*a, device="cpu", min_series=4, **k)


dp.probe_backend = probe_backend
ce.CUDAEngine = CPUEngine
'''


def test_tooling_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """Part (b) of chip_smoke's tooling phase end to end on the CPU: the
    port's vmsingle as a process under VMT_LOCKTRACE=warn and
    VMT_RACETRACE=1, its attach swapped (through a sitecustomize on its
    PYTHONPATH) for an engine on the kernels' plain versions; the four
    clients, the writer and the flusher for 3 s; no cycle, no race
    report, K1's, K2's and K3's counters moved, the final panel equal to
    the host's one-by-one sum.  Part (a) needs nvcc and a card."""
    import chip_smoke
    (tmp_path / "sitecustomize.py").write_text(_CPU_ATTACH)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "tool_build_cache", lambda: {})
    monkeypatch.setattr(chip_smoke, "TOOL_ACTIVITY_S", 3.0)
    res = chip_smoke.phase_tooling()
    assert res["tracers"]["vm_locktrace_cycles_total"] == 0
    assert res["tracers"]["vm_race_reports_total"] == 0
    assert all(res["device_calls"].values())
    assert res["final_panel"]["series"] == chip_smoke.DASH_GROUPS
