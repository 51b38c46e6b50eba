"""The port's work pool and search gate (``utils/workpool``, whole now:
the serve sections, the tracer and cost tracker carried to pool workers,
and the per-tenant ``TenantGate``) held to the reference's tests: every
case of ``tests/test_workpool.py`` and the single-node cases of
``tests/test_tenant_gate.py`` (quota parsing, admission, the shed-load
and deny-partial HTTP surfaces), written once and run against both
packages (``pkg``).  Its cluster RPC cases are in
``tests/test_torch_cluster.py``; its deterministic-scheduler stress is
also run here as a real-thread stress (the scheduler's own cases, on both
packages, are in ``tests/test_torch_tracers.py``).  Beside them: the query tracer and cost
tracker seen inside pool tasks, and ``serving()`` holding merges back.
The stores' data sits in the last two months (inside the retention)."""

import datetime
import json
import os
import threading
import time
import types
from functools import partial

import numpy as np
import pytest


def _month_edge_t0() -> int:
    """Three days before the first of last month, 00:00 UTC (ms): ten
    days on crosses into the next monthly partition, in the past."""
    now = datetime.datetime.now(datetime.timezone.utc)
    first = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    prev = (first - datetime.timedelta(days=1)).replace(day=1)
    return int((prev - datetime.timedelta(days=3)).timestamp() * 1000)


T0 = _month_edge_t0()


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu import native
        from victoriametrics_tpu.devtools import faultinject
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.httpapi.server import HTTPServer
        from victoriametrics_tpu.ops import compress
        from victoriametrics_tpu.ops import decimal as dec
        from victoriametrics_tpu.storage.columnar import ColumnarSeries
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import filters_from_dict
        from victoriametrics_tpu.utils import costacc, flightrec, querytracer
        from victoriametrics_tpu.utils import metrics as metricslib
        from victoriametrics_tpu.utils import workpool
    else:
        from victoriametrics_tpu_torch import native
        from victoriametrics_tpu_torch.devtools import faultinject
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.httpapi.server import HTTPServer
        from victoriametrics_tpu_torch.ops import compress
        from victoriametrics_tpu_torch.ops import decimal as dec
        from victoriametrics_tpu_torch.storage.columnar import ColumnarSeries
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import \
            filters_from_dict
        from victoriametrics_tpu_torch.utils import (costacc, flightrec,
                                                     querytracer)
        from victoriametrics_tpu_torch.utils import metrics as metricslib
        from victoriametrics_tpu_torch.utils import workpool
    return types.SimpleNamespace(
        name=name, native=native, faultinject=faultinject,
        PrometheusAPI=PrometheusAPI, HTTPServer=HTTPServer,
        compress=compress, dec=dec, ColumnarSeries=ColumnarSeries,
        Storage=Storage, filters_from_dict=filters_from_dict,
        costacc=costacc, flightrec=flightrec, querytracer=querytracer,
        metricslib=metricslib, workpool=workpool,
        WorkPool=workpool.WorkPool, SearchGate=workpool.SearchGate,
        TenantGate=workpool.TenantGate, TenantQuota=workpool.TenantQuota,
        parse_tenant_quotas=workpool.parse_tenant_quotas,
        SearchLimitError=workpool.SearchLimitError)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    p = _package(request.param)
    yield p
    p.faultinject.configure("")


# -- pool semantics ----------------------------------------------------------

class TestWorkPool:
    def test_run_preserves_submit_order(self, pkg):
        pool = pkg.WorkPool(workers=4)
        try:
            def job(i):
                time.sleep(0.001 * (7 - i % 7))  # finish out of order
                return i * i
            assert pool.run([partial(job, i) for i in range(40)]) == \
                [i * i for i in range(40)]
        finally:
            pool.shutdown()

    def test_run_actually_uses_worker_threads(self, pkg):
        pool = pkg.WorkPool(workers=3)
        try:
            names = set()

            def job():
                names.add(threading.current_thread().name)
                time.sleep(0.02)
            pool.run([job for _ in range(6)])
            assert any(n.startswith("vm-workpool-") for n in names)
        finally:
            pool.shutdown()

    def test_exception_propagates_after_batch_drains(self, pkg):
        pool = pkg.WorkPool(workers=2)
        try:
            ran = []

            def ok(i):
                ran.append(i)

            def boom():
                raise ValueError("task failed")

            with pytest.raises(ValueError, match="task failed"):
                pool.run([partial(ok, 0), boom, partial(ok, 1),
                          partial(ok, 2)])
            # every sibling task still ran (no cancellation surprises)
            assert sorted(ran) == [0, 1, 2]
        finally:
            pool.shutdown()

    def test_nested_run_does_not_deadlock(self, pkg):
        """A task fanning out on the same pool (cluster fanout -> local
        table collect) must complete even when tasks outnumber workers:
        waiters help execute queued work."""
        pool = pkg.WorkPool(workers=2)
        try:
            def inner(i):
                return i + 1

            def outer(k):
                return pool.run([partial(inner, 10 * k + j)
                                 for j in range(4)])

            got = pool.run([partial(outer, k) for k in range(6)])
            assert got == [[10 * k + j + 1 for j in range(4)]
                           for k in range(6)]
        finally:
            pool.shutdown()

    def test_workers_1_runs_inline_without_threads(self, pkg, monkeypatch):
        monkeypatch.setenv("VM_SEARCH_WORKERS", "1")
        pool = pkg.WorkPool()
        tid = threading.get_ident()
        out = pool.run([lambda: threading.get_ident() for _ in range(5)])
        assert out == [tid] * 5
        assert pool._threads == []          # never lazily started
        assert not pool.parallel_enabled()

    def test_submit_pipelines_and_inline_mode(self, pkg, monkeypatch):
        pool = pkg.WorkPool(workers=2)
        try:
            fut = pool.submit(lambda: 42)
            assert fut.result() == 42
        finally:
            pool.shutdown()
        monkeypatch.setenv("VM_SEARCH_WORKERS", "1")
        inline = pkg.WorkPool()
        assert inline.submit(lambda: 7).result() == 7
        assert inline._threads == []

    def test_submit_error_reraises(self, pkg):
        pool = pkg.WorkPool(workers=2)
        try:
            fut = pool.submit(partial(int, "nope"))
            with pytest.raises(ValueError):
                fut.result()
        finally:
            pool.shutdown()

    def test_env_resize_default_is_cpu_count(self, pkg, monkeypatch):
        monkeypatch.delenv("VM_SEARCH_WORKERS", raising=False)
        assert pkg.workpool.configured_workers() == (os.cpu_count() or 1)
        monkeypatch.setenv("VM_SEARCH_WORKERS", "7")
        assert pkg.workpool.configured_workers() == 7
        monkeypatch.setenv("VM_SEARCH_WORKERS", "garbage")
        assert pkg.workpool.configured_workers() == (os.cpu_count() or 1)

    def test_lowered_worker_count_retires_excess_threads(self, pkg, monkeypatch):
        monkeypatch.setenv("VM_SEARCH_WORKERS", "4")
        pool = pkg.WorkPool()
        try:
            pool.run([(lambda: time.sleep(0.01)) for _ in range(8)])
            assert len(pool._threads) == 4
            monkeypatch.setenv("VM_SEARCH_WORKERS", "2")
            pool.run([(lambda: time.sleep(0.01)) for _ in range(8)])
            assert len(pool._threads) <= 2
        finally:
            pool.shutdown()

    def test_decompress_fallback_is_size_bounded(self, pkg):
        """The zlib fallback must cap allocation like the zstd path's
        max_output_size (a small frame must not balloon into RAM)."""
        import zlib

        compress = pkg.compress
        bomb = zlib.compress(b"\0" * (8 << 20))
        with pytest.raises(ValueError, match="exceeds"):
            compress.decompress(bomb, max_size=1 << 20)
        ok = zlib.compress(b"payload" * 100)
        assert compress.decompress(ok, max_size=1 << 20) == b"payload" * 100

    def test_tasks_total_metric_counts(self, pkg):
        c = pkg.metricslib.REGISTRY.counter("vm_workpool_tasks_total")
        before = c.get()
        pkg.workpool.POOL.run([lambda: None, lambda: None, lambda: None])
        assert c.get() >= before + 3


# -- search concurrency gate -------------------------------------------------

class TestSearchGate:
    def test_admits_up_to_limit_then_queues(self, pkg):
        gate = pkg.SearchGate(limit=2, max_queue_ms=5000)
        release = threading.Event()
        inside = []

        def hold():
            with gate:
                inside.append(1)
                release.wait(10)

        ts = [threading.Thread(target=hold, daemon=True) for _ in range(2)]
        for t in ts:
            t.start()
        for _ in range(100):
            if len(inside) == 2:
                break
            time.sleep(0.01)
        assert len(inside) == 2
        queued = pkg.metricslib.REGISTRY.counter(
            "vm_search_requests_queued_total")
        q_before = queued.get()
        t3 = threading.Thread(target=hold, daemon=True)
        t3.start()
        for _ in range(100):
            if queued.get() > q_before:
                break
            time.sleep(0.01)
        assert queued.get() == q_before + 1   # third caller had to queue
        release.set()
        t3.join(10)
        for t in ts:
            t.join(10)
        assert len(inside) == 3               # ... and then got admitted

    def test_rejects_after_queue_timeout_with_metric(self, pkg):
        gate = pkg.SearchGate(limit=1, max_queue_ms=50)
        rejected = pkg.metricslib.REGISTRY.counter(
            "vm_search_requests_rejected_total")
        r_before = rejected.get()
        release = threading.Event()

        def hold():
            with gate:
                release.wait(10)

        t = threading.Thread(target=hold, daemon=True)
        t.start()
        for _ in range(100):
            if gate._current.get() == 1:
                break
            time.sleep(0.01)
        with pytest.raises(pkg.SearchLimitError, match="concurrent searches"):
            with gate:
                pass
        assert rejected.get() == r_before + 1
        release.set()
        t.join(10)

    def test_current_gauge_tracks(self, pkg):
        gate = pkg.SearchGate(limit=3, max_queue_ms=1000)
        cur = gate._current
        base = cur.get()
        with gate:
            assert cur.get() == base + 1
        assert cur.get() == base

    def test_metrics_surface_in_exposition(self, pkg):
        txt = pkg.metricslib.REGISTRY.write_prometheus()
        for name in ("vm_search_concurrent_limit",
                     "vm_search_concurrent_current",
                     "vm_search_requests_queued_total",
                     "vm_search_requests_rejected_total",
                     "vm_workpool_tasks_total", "vm_workpool_workers",
                     "vm_workpool_queue_depth"):
            assert name in txt, name


# -- vectorized decimal fallback ---------------------------------------------

class TestDecimalBlocksFallback:
    def _reference(self, pkg, mants, goff, scales):
        dec = pkg.dec
        out = np.empty(mants.size, np.float64)
        for k in range(scales.size):
            a, b = int(goff[k]), int(goff[k + 1])
            out[a:b] = dec.decimal_to_float(mants[a:b], int(scales[k]))
        return out

    @pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 64), (3, 300)])
    def test_matches_per_block_reference(self, pkg, seed, k):
        dec = pkg.dec
        rng = np.random.default_rng(seed)
        cnts = rng.integers(0, 50, k)
        goff = np.concatenate([[0], np.cumsum(cnts)]).astype(np.int64)
        n = int(goff[-1])
        mants = rng.integers(-10**12, 10**12, n)
        # sprinkle specials
        for v in (dec.V_STALE_NAN, dec.V_NAN, dec.V_INF_POS, dec.V_INF_NEG):
            idx = rng.integers(0, n, max(n // 17, 1))
            mants[idx] = v
        scales = rng.integers(-6, 4, k)
        want = self._reference(pkg, mants, goff, scales)
        out = np.empty(n, np.float64)
        dec.decimal_to_float_blocks_py(mants, goff, scales, out)
        np.testing.assert_array_equal(
            out.view(np.int64), want.view(np.int64))  # bit-exact, NaN-safe

    def test_pool_split_is_bit_identical(self, pkg, monkeypatch):
        dec = pkg.dec
        monkeypatch.setattr(dec, "_BLOCKS_SPLIT_MIN", 64)
        rng = np.random.default_rng(9)
        k = 40
        cnts = rng.integers(1, 64, k)
        goff = np.concatenate([[0], np.cumsum(cnts)]).astype(np.int64)
        n = int(goff[-1])
        mants = rng.integers(-10**9, 10**9, n)
        scales = rng.integers(-3, 3, k)
        want = self._reference(pkg, mants, goff, scales)
        pool = pkg.WorkPool(workers=3)
        try:
            out = np.empty(n, np.float64)
            dec.decimal_to_float_blocks_py(mants, goff, scales, out,
                                           pool=pool)
            np.testing.assert_array_equal(out.view(np.int64),
                                          want.view(np.int64))
        finally:
            pool.shutdown()

    def test_search_columns_no_native_fallback(self, pkg, tmp_path, monkeypatch):
        """The fallback decode path (native unavailable) must return the
        same result as the native path — exercised through the full
        search_columns stack."""
        s = pkg.Storage(str(tmp_path / "s"))
        # distinct exponents per series: 0.5 vs 3.0 vs 1e-3 step values
        rows = []
        for i, scale in enumerate((0.5, 3.0, 0.001, 12345.0)):
            rows += [({"__name__": "fb", "i": str(i)},
                      T0 + j * 15_000, (j + 1) * scale) for j in range(40)]
        s.add_rows(rows)
        s.force_flush()
        flt = pkg.filters_from_dict({"__name__": "fb"})
        native_cols = s.search_columns(flt, T0 - 1, T0 + 10**7)
        native_mod = pkg.native
        monkeypatch.setattr(native_mod, "available", lambda: False)
        fb_cols = s.search_columns(flt, T0 - 1, T0 + 10**7)
        assert native_cols.ts.tobytes() == fb_cols.ts.tobytes()
        assert native_cols.vals.tobytes() == fb_cols.vals.tobytes()
        np.testing.assert_array_equal(native_cols.counts, fb_cols.counts)
        assert native_cols.raw_names == fb_cols.raw_names
        s.close()


# -- parallel vs sequential fetch equivalence --------------------------------

def _assert_cols_identical(a, b):
    assert a.n_series == b.n_series
    np.testing.assert_array_equal(a.metric_ids, b.metric_ids)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.ts.tobytes() == b.ts.tobytes()
    assert a.vals.tobytes() == b.vals.tobytes()
    assert a.raw_names == b.raw_names
    if a.stale_rows is None or b.stale_rows is None:
        assert a.stale_rows is None and b.stale_rows is None
    else:
        np.testing.assert_array_equal(a.stale_rows, b.stale_rows)


class TestParallelSequentialEquivalence:
    def _build_multipart(self, pkg, path, coalescing: bool):
        """Two monthly partitions; several file parts each; plus pending
        in-memory rows.  With coalescing=True each series spans many
        span-capped blocks per part (the coalesce branch in
        search_columns runs); with False every series is a single tiny
        block per part."""
        s = pkg.Storage(str(path))
        n_series = 12
        per_flush = 60 if not coalescing else 700  # 700*15s ≈ 2.9h: >2 span
        #                                            blocks after the merge
        for part_i in range(3):
            rows = []
            for i in range(n_series):
                base = T0 + part_i * per_flush * 15_000
                rows += [({"__name__": "eq", "i": str(i)},
                          base + j * 15_000 + i, float((i + 1) * (j + 1)))
                         for j in range(per_flush)]
            s.add_rows(rows)
            s.force_flush()
        if coalescing:
            s.force_merge()  # one part, many adjacent same-series blocks
        # second month partition + unflushed pending rows
        t1 = T0 + 10 * 86_400_000  # crosses into the next month
        s.add_rows([({"__name__": "eq", "i": str(i)}, t1 + j * 15_000,
                     float(i + j)) for i in range(n_series)
                    for j in range(30)])
        s.force_flush()
        s.add_rows([({"__name__": "eq", "i": str(i)}, t1 + 10**6 + i, 1.0)
                    for i in range(n_series)])  # stays pending/in-memory
        return s

    @pytest.mark.parametrize("coalescing", [False, True])
    def test_bitwise_equal_and_faster_path_used(self, pkg, tmp_path, monkeypatch,
                                                coalescing):
        s = self._build_multipart(pkg, tmp_path / f"s{coalescing}", coalescing)
        flt = pkg.filters_from_dict({"__name__": "eq"})
        lo, hi = T0 - 1, T0 + 20 * 86_400_000
        monkeypatch.setenv("VM_SEARCH_WORKERS", "4")
        tasks = pkg.metricslib.REGISTRY.counter("vm_workpool_tasks_total")
        before = tasks.get()
        par = s.search_columns(flt, lo, hi)
        assert tasks.get() > before, "pool was not used"
        monkeypatch.setenv("VM_SEARCH_WORKERS", "1")
        seq = s.search_columns(flt, lo, hi)
        _assert_cols_identical(par, seq)
        assert par.n_series == 12 and par.n_samples > 0
        s.close()

    def test_chunked_prefetch_equivalence(self, pkg, tmp_path, monkeypatch):
        # >64 series (the per-chunk floor) so the tiny sample budget
        # splits the fetch into several chunks and the prefetch pipeline
        # actually runs
        s = pkg.Storage(str(tmp_path / "sc"))
        for flush in range(2):
            s.add_rows([({"__name__": "eq", "i": str(i)},
                         T0 + (flush * 10 + j) * 15_000, float(i + j))
                        for i in range(150) for j in range(10)])
            s.force_flush()
        flt = pkg.filters_from_dict({"__name__": "eq"})
        lo, hi = T0 - 1, T0 + 3_600_000
        monkeypatch.setenv("VM_SEARCH_WORKERS", "4")
        par_chunks = list(s.search_columns_chunked(
            flt, lo, hi, max_chunk_samples=400))
        monkeypatch.setenv("VM_SEARCH_WORKERS", "1")
        seq_chunks = list(s.search_columns_chunked(
            flt, lo, hi, max_chunk_samples=400))
        assert len(par_chunks) == len(seq_chunks) > 1
        for a, b in zip(par_chunks, seq_chunks):
            _assert_cols_identical(a, b)
        s.close()

    def test_chunked_early_close_drains_prefetch(self, pkg, tmp_path,
                                                 monkeypatch):
        s = self._build_multipart(pkg, tmp_path / "se", False)
        flt = pkg.filters_from_dict({"__name__": "eq"})
        monkeypatch.setenv("VM_SEARCH_WORKERS", "4")
        gen = s.search_columns_chunked(flt, T0 - 1,
                                       T0 + 20 * 86_400_000,
                                       max_chunk_samples=400)
        next(gen)
        gen.close()  # must not leave a background fetch racing close()
        s.close()


# ---------------------------------------------------------------------------
# quota parsing
# ---------------------------------------------------------------------------

class TestQuotaParsing:
    def test_full_grammar(self, pkg):
        q = pkg.parse_tenant_quotas("0:0=8:5000:high;7=2:100:low;*=4")
        assert q[(0, 0)].limit == 8
        assert q[(0, 0)].queue_ms == 5000.0
        assert q[(0, 0)].priority == "high"
        assert q[(7, 0)].limit == 2 and q[(7, 0)].rank == 2
        assert q["*"].limit == 4
        assert q["*"].queue_ms is None  # inherits the gate default
        assert q["*"].priority == "normal"

    def test_malformed_entries_dropped_not_fatal(self, pkg):
        q = pkg.parse_tenant_quotas("1:0=2;garbage;x=y;3:0=nope;4:0=1:bad")
        assert list(q) == [(1, 0)]

    def test_negative_limit_dropped(self, pkg):
        # a negative cap would make the tenant permanently inadmissible
        assert pkg.parse_tenant_quotas("7=-1") == {}

    def test_empty_means_no_quotas(self, pkg):
        assert pkg.parse_tenant_quotas("") == {}

    def test_gate_rereads_env(self, pkg, monkeypatch):
        g = pkg.TenantGate(limit=4)
        monkeypatch.setenv("VM_TENANT_QUOTAS", "5:0=3")
        assert g.quota_for((5, 0)).limit == 3
        monkeypatch.setenv("VM_TENANT_QUOTAS", "5:0=1")
        assert g.quota_for((5, 0)).limit == 1
        monkeypatch.delenv("VM_TENANT_QUOTAS")
        assert g.quota_for((5, 0)).limit == 0  # back to global-only


# ---------------------------------------------------------------------------
# admission semantics
# ---------------------------------------------------------------------------

class TestTenantGate:
    def test_default_behaves_like_global_gate(self, pkg):
        g = pkg.TenantGate(limit=2, max_queue_ms=50, quotas={})
        with g.admit((1, 0)), g.admit((2, 0)):
            assert g.occupancy()[0] == 2
            t0 = time.perf_counter()
            with pytest.raises(pkg.SearchLimitError):
                with g.admit((3, 0)):
                    pass
            assert time.perf_counter() - t0 < 2.0
        assert g.occupancy() == (0, {})

    def test_tenant_quota_isolates(self, pkg):
        g = pkg.TenantGate(limit=4, max_queue_ms=5000,
                       quotas={(1, 0): pkg.TenantQuota(1, queue_ms=60)})
        with g.admit((1, 0)):
            # tenant 1 is at ITS cap: rejected within its queue budget
            t0 = time.perf_counter()
            with pytest.raises(pkg.SearchLimitError) as ei:
                with g.admit((1, 0)):
                    pass
            assert time.perf_counter() - t0 < 2.0
            assert "tenant quota" in str(ei.value)
            # other tenants sail through the remaining global capacity
            with g.admit((2, 0)), g.admit((2, 0)), g.admit((2, 0)):
                assert g.occupancy()[0] == 4

    def test_release_grants_queued_waiter(self, pkg):
        g = pkg.TenantGate(limit=1, max_queue_ms=5000, quotas={})
        got = []

        with g.admit((1, 0)):
            t = threading.Thread(
                target=lambda: got.append(g.admit((2, 0)).__enter__()))
            t.start()
            time.sleep(0.1)
            assert not got  # queued behind the held slot
        t.join(timeout=5)
        assert got  # released slot was handed over
        g._release((2, 0))
        assert g.occupancy() == (0, {})

    def test_priority_classes_order_grants(self, pkg):
        """When capacity frees up, a queued high-priority request is
        granted before an earlier-arrived low-priority one."""
        g = pkg.TenantGate(limit=1, max_queue_ms=5000,
                       quotas={(1, 0): pkg.TenantQuota(0, priority="low"),
                               (2, 0): pkg.TenantQuota(0, priority="high")})
        order = []
        threads = []

        def worker(tenant, tag):
            with g.admit(tenant):
                order.append(tag)
                time.sleep(0.05)

        with g.admit((9, 9)):  # hold the only slot
            for tenant, tag in (((1, 0), "low"), ((2, 0), "high")):
                t = threading.Thread(target=worker, args=(tenant, tag))
                t.start()
                threads.append(t)
                time.sleep(0.1)  # deterministic arrival order: low first
        for t in threads:
            t.join(timeout=5)
        assert order == ["high", "low"]

    def test_quota_capped_waiter_does_not_block_other_tenants(self, pkg):
        """A waiter blocked only by its OWN tenant quota must not
        head-of-line block later waiters of other tenants."""
        g = pkg.TenantGate(limit=2, max_queue_ms=3000,
                       quotas={(1, 0): pkg.TenantQuota(1)})
        passed = []
        with g.admit((1, 0)):  # tenant 1 at quota, one global slot free
            blocked = threading.Thread(
                target=lambda: passed.append(("t1", g.admit(
                    (1, 0)).__enter__())))
            blocked.daemon = True
            blocked.start()
            time.sleep(0.1)
            # tenant 2 must be admitted despite tenant 1 queued ahead
            t0 = time.perf_counter()
            with g.admit((2, 0)):
                assert time.perf_counter() - t0 < 1.0
        blocked.join(timeout=5)  # tenant 1's waiter gets the freed slot
        assert passed, "queued tenant-1 waiter never admitted"
        g._release((1, 0))
        assert g.occupancy() == (0, {})

    def test_tenant_metric_cardinality_bounded(self, pkg):
        """Tenant ids come from the URL path: iterating ids must fold
        past the cap into one shared 'other' label set without growing
        the memo per tenant."""
        g = pkg.TenantGate(limit=4, quotas={})
        g._MAX_TENANT_METRICS = 3
        for i in range(10):
            with g.admit((i, 0)):
                pass
        # 3 real tenants x 2 metric names + 1 shared "other" per name
        assert len(g._tenant_label_seen) == 3
        names = {k for k in g._tenant_metric_memo}
        other_keys = [k for k in names if k[1] == "other"]
        per_tenant_keys = [k for k in names if k[1] != "other"]
        assert {t for _, t in per_tenant_keys} == {(0, 0), (1, 0), (2, 0)}
        assert other_keys  # folded tenants share these
        # folding is sticky per tenant: repeat admits add no new keys
        before = len(g._tenant_metric_memo)
        with g.admit((9, 0)):
            pass
        assert len(g._tenant_metric_memo) == before

    def test_concurrent_metrics_and_rejection_counters(self, pkg):
        g = pkg.TenantGate(limit=1, max_queue_ms=30,
                       quotas={(8, 1): pkg.TenantQuota(1, queue_ms=30)})
        with g.admit((8, 1)):
            with pytest.raises(pkg.SearchLimitError):
                with g.admit((8, 1)):
                    pass
        text = pkg.metricslib.REGISTRY.write_prometheus()
        assert 'vm_tenant_search_requests_total{tenant="8:1"}' in text
        assert 'vm_tenant_search_rejected_total{tenant="8:1"}' in text



# ---------------------------------------------------------------------------
# HTTP surfaces: 429 shed load, deny_partial 503, slow-log linkage
# ---------------------------------------------------------------------------

class _ShedStorage:
    """Stub storage whose every search is shed by the gate."""

    last_partial = False

    def __init__(self, pkg):
        self._err = pkg.SearchLimitError

    def search_columns(self, *a, **kw):
        raise self._err("couldn't start the search: test shed")

    def search_series(self, *a, **kw):
        raise self._err("couldn't start the search: test shed")

    def metrics(self):
        return {}


class _PartialStorage:
    """Stub storage returning an empty-but-partial scatter-gather."""

    last_partial = True

    def __init__(self, pkg):
        self._columnar = pkg.ColumnarSeries

    def reset_partial(self):
        # sticky: simulates a fanout that keeps seeing a dead node
        self.last_partial = True

    def search_columns(self, *a, **kw):
        return self._columnar.empty()

    def search_series(self, *a, **kw):
        return []

    def metrics(self):
        return {}


def _api(pkg, storage):
    srv = pkg.HTTPServer("127.0.0.1", 0)
    api = pkg.PrometheusAPI(storage)
    api.register(srv, mode="all")
    srv.start()
    return srv, api


class TestShedLoadHTTP:
    def test_gate_rejection_is_429_with_retry_after(self, pkg):
        from tests.apptest_helpers import Client
        srv, api = _api(pkg, _ShedStorage(pkg))
        try:
            c = Client(srv.port)
            code, body = c.get("/api/v1/query", query="up",
                               time=str(T0 // 1000))
            assert code == 429
            res = json.loads(body)
            assert res["errorType"] == "too_many_requests"
            # rejected queries are linked into the slow-query log
            code, body = c.get("/api/v1/status/slow_queries")
            recs = json.loads(body)["data"]
            assert any(r.get("rejected") and r["query"] == "up"
                       for r in recs), recs
        finally:
            srv.stop()

    def test_faults_endpoint_is_opt_in(self, pkg, monkeypatch):
        """/internal/faults must not let an unauthenticated client
        stall a production process: 403 unless the process opted into
        chaos (VM_FAULT_INJECT=1 / VM_FAULTS)."""
        from tests.apptest_helpers import Client
        monkeypatch.delenv("VM_FAULT_INJECT", raising=False)
        srv, api = _api(pkg, _PartialStorage(pkg))
        try:
            c = Client(srv.port)
            code, _ = c.get("/internal/faults", set="rpc:*=stall")
            assert code == 403
            assert not pkg.faultinject.active()
            monkeypatch.setenv("VM_FAULT_INJECT", "1")
            code, body = c.get("/internal/faults",
                               set="rpc:x_v1=delay:5")
            assert code == 200
            assert json.loads(body)["faults"] == "rpc:x_v1=delay:5"
            code, _ = c.get("/internal/faults", clear="1")
            assert code == 200 and not pkg.faultinject.active()
        finally:
            srv.stop()

    def test_rejection_visible_in_flight_capture(self, pkg):
        """The gate:rejected instant lands in the flight ring, so an
        on-demand capture explains shed load at /status/flight."""
        flightrec = pkg.flightrec
        if not flightrec.enabled():
            pytest.skip("flight recorder disabled")
        gate = pkg.TenantGate(limit=1, max_queue_ms=20, quotas={})
        with gate.admit((0, 0)):
            with pytest.raises(pkg.SearchLimitError):
                with gate.admit((0, 0)):
                    pass
        cap = flightrec.RECORDER.capture("test_shed")
        events = [e for e in cap["trace"]["traceEvents"]
                  if e.get("name") == "gate:rejected"]
        assert events, "gate:rejected instant missing from capture"


class TestDenyPartial:
    def test_partial_counts_and_deny_flag_503(self, pkg, monkeypatch):
        from tests.apptest_helpers import Client
        ctr = pkg.metricslib.REGISTRY.counter("vm_partial_results_total")
        srv, api = _api(pkg, _PartialStorage(pkg))
        try:
            c = Client(srv.port)
            before = ctr.get()
            # default: partial served as isPartial=true 200
            code, body = c.get("/api/v1/query", query="up",
                               time=str(T0 // 1000))
            assert code == 200
            assert json.loads(body)["isPartial"] is True
            assert ctr.get() == before + 1
            # request flag: partial becomes a 503
            code, body = c.get("/api/v1/query", query="up",
                               time=str(T0 // 1000), deny_partial="1")
            assert code == 503
            assert json.loads(body)["errorType"] == "unavailable"
            # env default, overridable per request
            monkeypatch.setenv("VM_DENY_PARTIAL_RESPONSE", "1")
            code, _ = c.get("/api/v1/query", query="up",
                            time=str(T0 // 1000))
            assert code == 503
            code, _ = c.get("/api/v1/query", query="up",
                            time=str(T0 // 1000), deny_partial="0")
            assert code == 200
            # query_range path too
            monkeypatch.delenv("VM_DENY_PARTIAL_RESPONSE")
            code, body = c.get("/api/v1/query_range", query="up",
                               start=str(T0 // 1000),
                               end=str(T0 // 1000 + 600), step="15",
                               deny_partial="1", nocache="1")
            assert code == 503
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# beyond the reference's cases
# ---------------------------------------------------------------------------

class TestTenantGateStress:
    """The reference's race-marked TenantGate stress runs under its
    deterministic scheduler; here on real threads: the per-tenant and
    global caps hold at every observation and every worker finishes."""

    def test_quota_never_exceeded_and_starvation_free(self, pkg):
        gate = pkg.TenantGate(limit=2, max_queue_ms=60_000,
                              quotas={(1, 0): pkg.TenantQuota(1),
                                      (2, 0): pkg.TenantQuota(1)})
        peak = {"global": 0, (1, 0): 0, (2, 0): 0}
        done = []
        lk = threading.Lock()

        def worker(tenant, tag):
            for _ in range(20):
                with gate.admit(tenant):
                    g, per = gate.occupancy()
                    with lk:
                        peak["global"] = max(peak["global"], g)
                        peak[tenant] = max(peak[tenant],
                                           per.get(tenant, 0))
                    time.sleep(0.0005)
            done.append(tag)

        threads = [threading.Thread(target=worker, args=(t, f"{n}{i}"))
                   for i in range(3) for t, n in (((1, 0), "a"),
                                                  ((2, 0), "b"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert peak["global"] <= 2
        assert peak[(1, 0)] <= 1 and peak[(2, 0)] <= 1
        assert sorted(done) == ["a0", "a1", "a2", "b0", "b1", "b2"]
        assert gate.occupancy() == (0, {})


class TestPropagation:
    def test_tracer_and_cost_tracker_inside_pool_tasks(self, pkg):
        """A task on a pool worker sees the submitting query's tracer and
        cost tracker: its span lands in the query's trace, its lap in the
        query's cost summary."""
        pool = pkg.WorkPool(workers=3)
        try:
            tracer = pkg.querytracer.Tracer("query %s", "q")
            cost = pkg.costacc.CostTracker()
            prev_tr = pkg.querytracer.set_current(tracer)
            prev_cost = pkg.costacc.set_current(cost)
            try:
                def task(i):
                    time.sleep(0.01)
                    pkg.querytracer.current().printf("task %d", i)
                    pkg.costacc.lap("fetch:decode", 0.001)
                    return (threading.current_thread().name,
                            pkg.querytracer.current() is tracer and
                            pkg.costacc.current() is cost)
                seen = pool.run([partial(task, i) for i in range(6)])
            finally:
                pkg.costacc.set_current(prev_cost)
                pkg.querytracer.set_current(prev_tr)
            assert [ok for _, ok in seen] == [True] * 6
            # (the submitter helps with queued tasks; most run on workers)
            assert any(n.startswith("vm-workpool-") for n, _ in seen)
            msgs = json_messages(tracer.to_dict())
            assert sorted(m for m in msgs if m.startswith("task")) == \
                sorted(f"task {i}" for i in range(6))
            assert cost.summary()["wallMsByPhase"]["fetch:decode"] == \
                pytest.approx(6.0)
            # after the batch the workers hold no query's context
            assert pool.run([lambda: (pkg.querytracer.current() is tracer,
                                      pkg.costacc.current())]
                            * 3) == [(False, None)] * 3
        finally:
            pool.shutdown()

    def test_serving_holds_merges_back(self, pkg, monkeypatch):
        """While a serve section is open, a merge admission on a
        dedicated thread waits (up to VM_MERGE_YIELD_MS) and counts one
        yield; with nothing served it enters at once."""
        monkeypatch.setenv("VM_MERGE_YIELD_MS", "5000")
        gate = pkg.workpool.MergeGate(limit=1)
        t0 = time.perf_counter()
        with gate:
            pass
        assert time.perf_counter() - t0 < 0.1
        opened, close = threading.Event(), threading.Event()

        def serve():
            with pkg.workpool.serving():
                assert pkg.workpool.serving_busy()
                opened.set()
                close.wait(10)

        t = threading.Thread(target=serve)
        t.start()
        opened.wait(10)
        y0 = gate.yields
        threading.Timer(0.3, close.set).start()
        t0 = time.perf_counter()
        with gate:
            waited = time.perf_counter() - t0
        t.join(10)
        assert gate.yields == y0 + 1
        assert 0.25 <= waited < 4.0, waited
        assert not pkg.workpool.serving_busy()
        # a serving thread itself never yields to its own section
        with pkg.workpool.serving():
            t0 = time.perf_counter()
            with gate:
                pass
            assert time.perf_counter() - t0 < 0.1


def json_messages(d) -> list:
    out, todo = [], [d]
    while todo:
        x = todo.pop()
        out.append(x.get("message", ""))
        todo.extend(x.get("children", ()))
    return out
