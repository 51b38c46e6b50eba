"""The port's flight recorder (victoriametrics_tpu_torch/utils/flightrec.py,
a copy of the JAX package's) under the cases of the reference's
``tests/test_flightrec.py`` that need neither the HTTP layer nor the
slow-query log (both come with the port's HTTP slice) and do not depend
on test order.

The summary cases compare the port's ``summarize`` with the reference's
on the same events.  The gc case first gives the test's own thread a
ring (a collection is recorded only on a thread that already owns one),
so it passes when run alone, where the reference's
``TestGcVisibility::test_gc_pause_metrics_and_flight_event`` does not.
The port's work pool carries the flight context to its workers (not the
query tracer, which the reference's pool also carries); the propagation
case checks the context."""

from __future__ import annotations

import gc
import json
import threading
import time

import pytest

from victoriametrics_tpu.utils import flightrec as ref_flightrec
from victoriametrics_tpu_torch.utils import flightrec
from victoriametrics_tpu_torch.utils import metrics as metricslib


@pytest.fixture(autouse=True)
def _recorder_enabled(monkeypatch):
    """Every test starts with the recorder on and a clean thread ctx."""
    monkeypatch.delenv("VM_FLIGHTREC", raising=False)
    flightrec.reconfigure()
    flightrec.clear_ctx()
    yield
    flightrec.clear_ctx()
    monkeypatch.undo()
    flightrec.reconfigure()


def _events(cap, prefix):
    return [e for e in cap["trace"]["traceEvents"]
            if e["name"].startswith(prefix)]


def test_rec_and_capture_roundtrip():
    rec = flightrec.FlightRecorder(max_captures=4)
    t0 = time.perf_counter()
    time.sleep(0.002)
    flightrec.rec("t:roundtrip", t0, time.perf_counter() - t0, arg="hello")
    cap = rec.capture("test", window_s=5.0)
    evs = _events(cap, "t:roundtrip")
    assert evs
    assert evs[0]["ph"] == "X" and evs[0]["dur"] >= 2_000  # µs
    assert evs[0]["args"]["arg"] == "hello"
    assert cap["n_events"] >= 1 and cap["n_threads"] >= 1
    json.dumps(cap["trace"])


def test_instant_event_format():
    rec = flightrec.FlightRecorder(max_captures=4)
    flightrec.instant("t:decision", arg="rebuild")
    evs = _events(rec.capture("test", window_s=5.0), "t:decision")
    assert evs and evs[0]["ph"] == "i" and "dur" not in evs[0]
    assert evs[0]["s"] == "t"


def test_span_records_its_region():
    rec = flightrec.FlightRecorder(max_captures=2)
    with flightrec.span("t:span", arg=3):
        time.sleep(0.001)
    evs = _events(rec.capture("test", window_s=5.0), "t:span")
    assert evs and evs[0]["dur"] >= 1_000 and evs[0]["args"]["arg"] == 3


def test_ring_wraparound_keeps_newest(monkeypatch):
    monkeypatch.setenv("VM_FLIGHTREC_EVENTS", "8")
    out = {}

    def run():
        base = time.perf_counter()
        for k in range(20):
            flightrec.rec(f"wrap:{k}", base + k * 1e-7, 1e-8)
        out["ring"] = flightrec._tls.ring

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    ring = out["ring"]
    assert ring.cap == 8 and ring.i == 20
    # cap 8 keeps cursors 12..19; the seqlock filter drops the oldest
    # retained one too
    assert [e[2] for e in ring.snapshot(0.0)] == \
        [f"wrap:{k}" for k in range(13, 20)]
    dropped = metricslib.REGISTRY.counter("vm_flight_dropped_events_total")
    d0 = dropped.get()
    flightrec.FlightRecorder(max_captures=2).capture("test", window_s=60.0)
    assert dropped.get() - d0 >= 12


def test_taken_is_first_uncaptured_cursor(monkeypatch):
    monkeypatch.setenv("VM_FLIGHTREC_EVENTS", "8")
    out = {}

    def run():
        base = time.perf_counter()
        for k in range(6):
            flightrec.rec(f"taken:{k}", base + k * 1e-7, 1e-8)
        out["ring"] = flightrec._tls.ring

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    flightrec.FlightRecorder(max_captures=2).capture("test", window_s=60.0)
    assert out["ring"].i == 6 and out["ring"].taken == 6


def test_capture_merge_is_timestamp_ordered():
    now = time.perf_counter()
    offs = {"ordtest:a0": 1e-4, "ordtest:a1": 3e-4,
            "ordtest:b0": 0.0, "ordtest:b1": 2e-4}

    def writer(names):
        for n in names:
            flightrec.rec(n, now - 0.01 + offs[n], 1e-4)

    threads = [threading.Thread(target=writer, args=(names,)) for names in
               (["ordtest:a0", "ordtest:a1"], ["ordtest:b0", "ordtest:b1"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    cap = flightrec.FlightRecorder(max_captures=2).capture("test",
                                                           window_s=5.0)
    ours = _events(cap, "ordtest:")
    assert [e["name"] for e in ours] == \
        ["ordtest:b0", "ordtest:a0", "ordtest:b1", "ordtest:a1"]
    assert [e["ts"] for e in ours] == sorted(e["ts"] for e in ours)


def test_disabled_is_a_noop(monkeypatch):
    monkeypatch.setenv("VM_FLIGHTREC", "0")
    flightrec.reconfigure()
    assert not flightrec.enabled()
    n_rings = len(flightrec._rings)

    def run():
        flightrec.rec("off:span", time.perf_counter(), 1e-3)
        flightrec.instant("off:instant")

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    assert len(flightrec._rings) == n_rings
    assert flightrec.FlightRecorder(max_captures=2).capture("test") is None


def test_dead_thread_rings_are_reclaimed():
    old_t0 = time.perf_counter() - 7200.0
    fresh_t0 = time.perf_counter()
    rings = {}

    def run(key, t0):
        flightrec.rec(f"reclaim:{key}", t0, 1e-3)
        rings[key] = flightrec._tls.ring

    for key, t0 in (("fresh", fresh_t0), ("old", old_t0)):
        t = threading.Thread(target=run, args=(key, t0))
        t.start()
        t.join(10)
    with flightrec._rings_lock:
        assert rings["old"] in flightrec._rings
    flightrec.FlightRecorder(max_captures=2).capture("test", window_s=5.0)
    with flightrec._rings_lock:
        assert rings["old"] not in flightrec._rings
        assert rings["fresh"] in flightrec._rings


def test_capture_ring_is_bounded():
    rec = flightrec.FlightRecorder(max_captures=2)
    flightrec.instant("t:x")
    ids = [rec.capture("test", window_s=5.0)["id"] for _ in range(3)]
    assert [c["id"] for c in rec.list()] == [ids[2], ids[1]]
    assert rec.get(ids[0]) is None
    assert rec.get(ids[2])["id"] == ids[2]
    assert all("trace" not in c for c in rec.list())


_SUMMARY_EVENTS = [
    {"name": "serve:refresh", "ph": "X", "pid": 1, "tid": 1,
     "ts": 0.0, "dur": 100_000.0, "args": {"ctx": 7}},
    {"name": "merge:part", "ph": "X", "pid": 1, "tid": 2,
     "ts": 10_000.0, "dur": 50_000.0},
    {"name": "gc:gen0", "ph": "X", "pid": 1, "tid": 1,
     "ts": 40_000.0, "dur": 10_000.0},
    {"name": "fetch:rollup", "ph": "X", "pid": 1, "tid": 3,
     "ts": 0.0, "dur": 30_000.0, "args": {"ctx": 7}},
    {"name": "gc:gen2", "ph": "X", "pid": 1, "tid": 4,
     "ts": 95_000.0, "dur": 20_000.0},
    {"name": "rcache:inplace", "ph": "i", "pid": 1, "tid": 1,
     "ts": 5.0, "s": "t"},
    {"name": "merge:yield", "ph": "X", "pid": 1, "tid": 5,
     "ts": 0.0, "dur": 80_000.0},
    {"name": "fetch:queue_wait", "ph": "X", "pid": 1, "tid": 6,
     "ts": 20_000.0, "dur": 30_000.0},
    {"name": "flush:table", "ph": "X", "pid": 1, "tid": 7,
     "ts": 10_000.0, "dur": 60_000.0},
    {"name": "flush:part", "ph": "X", "pid": 1, "tid": 8,
     "ts": 15_000.0, "dur": 50_000.0},
]
_FOCUS_EVENTS = [
    {"name": "serve:refresh", "ph": "X", "pid": 1, "tid": 1,
     "ts": 0.0, "dur": 900_000.0, "args": {"ctx": 1}},
    {"name": "serve:refresh", "ph": "X", "pid": 1, "tid": 1,
     "ts": 1_000_000.0, "dur": 200_000.0, "args": {"ctx": 5}},
    {"name": "flush:part", "ph": "X", "pid": 1, "tid": 2,
     "ts": 1_050_000.0, "dur": 100_000.0},
]


def test_overlap_attribution_excludes_own_work():
    """Other-context work overlapping the serve window, by category, as
    the reference summarises it."""
    s = flightrec.summarize(_SUMMARY_EVENTS)
    assert s == ref_flightrec.summarize(_SUMMARY_EVENTS)
    assert s["slow_refresh"]["ms"] == 100.0 and s["slow_refresh"]["ctx"] == 7
    assert s["slow_refresh"]["overlap_ms_by_category"] == \
        {"merge": 50.0, "gc": 15.0, "flush": 60.0}
    assert s["slow_refresh"]["waiting_ms_by_name"] == \
        {"merge:yield": 80.0, "fetch:queue_wait": 30.0}
    assert s["span_ms_by_name"]["merge:part"] == 50.0


@pytest.mark.parametrize("focus, ctx", [(5, 5), (0, 1), (99, 1)])
def test_focus_ctx_pins_the_triggering_refresh(focus, ctx):
    s = flightrec.summarize(_FOCUS_EVENTS, focus_ctx=focus)
    assert s == ref_flightrec.summarize(_FOCUS_EVENTS, focus_ctx=focus)
    assert s["slow_refresh"]["ctx"] == ctx


def test_pool_worker_inherits_ctx(monkeypatch):
    """A task submitted to the shared pool runs under the submitting
    query's flight context: its spans and the pool's own task and queue
    wait spans come back from ctx_events and phase_split."""
    from victoriametrics_tpu_torch.utils import workpool
    monkeypatch.setenv("VM_SEARCH_WORKERS", "2")
    ctx = flightrec.new_ctx()
    prev_ctx = flightrec.set_ctx(ctx)
    started, release = threading.Event(), threading.Event()
    info = {}
    main_tid = threading.get_ident()

    def task():
        started.set()
        release.wait(10)
        info["tid"] = threading.get_ident()
        info["ctx"] = flightrec.get_ctx()
        with flightrec.span("t:worker"):
            time.sleep(0.001)
        return 42

    try:
        fut = workpool.POOL.submit(task)
        assert started.wait(10)
        release.set()
        assert fut.result() == 42
    finally:
        flightrec.set_ctx(prev_ctx)
    assert info["tid"] != main_tid and info["ctx"] == ctx
    evs = flightrec.ctx_events(ctx)
    names = {name for _t0, _dur, name, _tid in evs}
    assert {"t:worker", "pool:task", "pool:queue_wait"} <= names
    assert {tid for _t0, _dur, name, tid in evs if name == "t:worker"} == \
        {info["tid"]}
    assert flightrec.phase_split(ctx).get("t:worker", 0.0) > 0.0


def test_ctx_restored_after_task(monkeypatch):
    from victoriametrics_tpu_torch.utils import workpool
    monkeypatch.setenv("VM_SEARCH_WORKERS", "2")
    ctx = flightrec.new_ctx()
    prev = flightrec.set_ctx(ctx)
    try:
        workpool.POOL.run([lambda: None] * 4)
    finally:
        flightrec.set_ctx(prev)
    seen = []
    flightrec.clear_ctx()
    workpool.POOL.submit(lambda: seen.append(flightrec.get_ctx())).result()
    assert seen == [0]


def test_search_gate_wait_ticks_queue_wait_phase():
    from victoriametrics_tpu_torch.utils.workpool import SearchGate
    qw = metricslib.REGISTRY.float_counter(
        'vm_fetch_phase_seconds_total{phase="queue_wait"}')
    v0 = qw.get()
    gate = SearchGate(limit=1, max_queue_ms=5000)
    release, entered, done = (threading.Event() for _ in range(3))

    def hold():
        with gate:
            entered.set()
            release.wait(10)

    def queued():
        with gate:
            done.set()

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert entered.wait(10)
    t2 = threading.Thread(target=queued, daemon=True)
    t2.start()
    time.sleep(0.05)
    release.set()
    assert done.wait(10)
    t.join(10)
    t2.join(10)
    assert qw.get() - v0 >= 0.03
    cap = flightrec.FlightRecorder(max_captures=2).capture("test",
                                                           window_s=5.0)
    assert _events(cap, "fetch:queue_wait")


def test_gc_pause_metrics_and_flight_event():
    """A collection ticks vm_gc_pause_seconds_total and lands on the
    flight timeline of the thread that triggered it (which must own a
    ring: the instant below gives it one, so this holds run alone)."""
    pause = metricslib.REGISTRY.float_counter("vm_gc_pause_seconds_total")
    assert flightrec._gc_hook in metricslib.gc_pause_hooks
    metricslib.install_gc_metrics()  # idempotent
    assert gc.callbacks.count(metricslib._gc_pause_callback) == 1
    flightrec.instant("t:own_ring")
    p0 = pause.get()
    gc.collect()
    assert pause.get() > p0
    cap = flightrec.FlightRecorder(max_captures=2).capture("test",
                                                           window_s=5.0)
    assert _events(cap, "gc:gen")


def test_concurrent_writers_and_captures():
    """Writers fill their rings while captures walk them: no torn event,
    and every trace serialises."""
    errs = []
    stop = threading.Event()

    def writer(k):
        try:
            n = 0
            while not stop.is_set() and n < 5_000:
                with flightrec.span(f"race:w{k}", arg=n):
                    n += 1
                flightrec.instant(f"race:i{k}")
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(k,), daemon=True)
               for k in range(4)]
    rec = flightrec.FlightRecorder(max_captures=4)
    for t in threads:
        t.start()
    try:
        for _ in range(10):
            cap = rec.capture("race", window_s=5.0)
            json.dumps(cap["trace"])
            assert all(ev["ph"] in ("X", "i", "M")
                       for ev in cap["trace"]["traceEvents"])
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not errs


def test_histogram_keeps_vmrange_buckets():
    """The port's self-metrics histograms now keep the reference's vmrange
    buckets beside their sum and count."""
    from victoriametrics_tpu.query.vmhistogram import vmrange_for
    h = metricslib.Histogram("t_hist_seconds")
    for v in (0.0, 1e-3, 1e-3, 2.5, 7e5, float("nan"), -1.0):
        h.update(v)
    want = {}
    for v in (0.0, 1e-3, 1e-3, 2.5, 7e5):
        want[vmrange_for(v)] = want.get(vmrange_for(v), 0) + 1
    assert h.buckets() == want
    assert h.get_count() == 5 and h.get_sum() == pytest.approx(700002.502,
                                                               rel=1e-15)
