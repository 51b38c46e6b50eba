"""The port's rollup result cache (victoriametrics_tpu_torch/query/
rollup_result_cache.py) against the JAX package's.

The cases of the reference's ``tests/test_result_cache_ring.py`` and
``tests/test_refresh_suffix_guard.py`` run on both sides with the same
puts, gets and merges: a port ``Storage`` and a reference ``Storage`` fed
the same rows, each refreshed through the serving layer's cached range
executor (``serve`` below: the host half of the reference's
``PrometheusAPI._exec_range_cached_serving``, which the port's HTTP slice
has not brought yet) with the same ``now``.  Every refresh must give

  * the same rows as the other side, bit for bit, and as a cold
    ``disable_cache`` evaluation on its own side;
  * the same entries, hits, misses, in-place merges and rebuilds (the
    cache's own counters, compared as deltas).

The wall clock is frozen for each refresh pair, so the volatile-tail clip
(``now - OFFSET_MS``) cuts both sides at the same step.  The direct cases
(partial suffixes, the byte bound, the identity reuse) call both caches
with the same rows; ``RingBlock`` is held against the reference's at
every column count of ``try_advance``/``commit``."""

import contextlib
import hashlib
import os
import time

import numpy as np
import pytest

from test_torch_exec import Pair, same_rows
from victoriametrics_tpu.query import eval as ref_eval
from victoriametrics_tpu.query import exec as ref_exec
from victoriametrics_tpu.query import rollup_result_cache as ref_rrc
from victoriametrics_tpu.query import types as ref_types
from victoriametrics_tpu.storage.metric_name import MetricName as RefName
from victoriametrics_tpu.utils import metrics as ref_metrics
from victoriametrics_tpu_torch.query import eval as port_eval
from victoriametrics_tpu_torch.query import exec as port_exec
from victoriametrics_tpu_torch.query import rollup_result_cache as port_rrc
from victoriametrics_tpu_torch.query import types as port_types
from victoriametrics_tpu_torch.storage.metric_name import MetricName
from victoriametrics_tpu_torch.utils import metrics as port_metrics

STEP = 60_000
SCRAPE = 15_000
N0 = 400          # initial scrapes per series
NS = 12           # series
DUR = 40 * STEP   # query window
QUERIES = ["sum by (g)(rate(ringm[5m]))", "rate(ringm[5m])"]

_PORT = dict(exec=port_exec, rrc=port_rrc, eval=port_eval, types=port_types,
             metrics=port_metrics)
_REF = dict(exec=ref_exec, rrc=ref_rrc, eval=ref_eval, types=ref_types,
            metrics=ref_metrics)
_COUNTERS = ("vm_rollup_cache_inplace_total", "vm_rollup_cache_rebuild_total",
             "vm_rollup_cache_put_identity_reused_total")


@contextlib.contextmanager
def frozen(now_s: float):
    real = time.time
    time.time = lambda: now_s
    try:
        yield
    finally:
        time.time = real


def serve(side, store, ec, q, now_ms):
    """The reference serving layer's cached range executor, host path
    (httpapi/prometheus_api.py _exec_range_cached_serving)."""
    rcache = side["rrc"].GLOBAL
    exec_query = side["exec"].exec_query
    if ec.n_points <= 1:
        return exec_query(ec, q)
    cached, new_start = rcache.get(ec, q, now_ms)
    if cached is not None and new_start > ec.end:
        rows = [r for r in cached.rows() if not np.isnan(r.values).all()]
        rows.sort(key=lambda ts: ts.raw)
        return rows
    if cached is not None:
        sub_start, trim = side["eval"].suffix_child_bounds(ec, new_start)
        sub = ec.child(start=sub_start)
        sub.no_device_roll = True
        sub.no_eval_cache = True
        fresh = exec_query(sub, q)
        if trim:
            fresh = side["eval"].trim_suffix_rows(fresh)
        rows = rcache.merge(cached, fresh, ec, new_start, trust_raw=False,
                            now_ms=now_ms)
        rows = [r for r in rows if not np.isnan(r.values).all()]
        rows.sort(key=lambda ts: ts.raw)
        trust = True
    else:
        rows = exec_query(ec, q)
        trust = False
    if not getattr(store, "last_partial", False):
        rcache.put(ec, q, rows, now_ms, trust_raw=trust)
    return rows


def _counts(side):
    st = side["rrc"].GLOBAL.stats()
    reg = side["metrics"].REGISTRY
    return ((st["entries"], st["hits"], st["misses"]) +
            tuple(reg.counter(n).get() for n in _COUNTERS))


def _sha(rows) -> str:
    h = hashlib.sha256()
    for ts in sorted(rows, key=lambda t: t.metric_name.marshal()):
        h.update(bytes(ts.metric_name.marshal()))
        h.update(np.ascontiguousarray(ts.values).tobytes())
    return h.hexdigest()


class Ring:
    """One dashboard over a Pair of live-anchored stores (fresh scrapes
    land inside the OFFSET_MS volatile window, as in production)."""

    def __init__(self, path):
        now = int(time.time() * 1000)
        t0 = (now - (N0 - 1) * SCRAPE) // STEP * STEP
        self.pair = Pair(path, [
            ({"__name__": "ringm", "i": str(i), "g": f"g{i % 3}"},
             t0 + j * SCRAPE, float(j + i))
            for i in range(NS) for j in range(N0)])
        self.end0 = t0 + ((N0 - 1) * SCRAPE // STEP + 1) * STEP
        self.c0 = (_counts(_PORT), _counts(_REF))

    def close(self):
        self.pair.close()

    def ingest(self, end_ms, lo=0, hi=NS, bump=0.0):
        self.pair.add([({"__name__": "ringm", "i": str(i), "g": f"g{i % 3}"},
                        end_ms - STEP + (k + 1) * SCRAPE,
                        float(2000 + bump + i + k))
                       for i in range(lo, hi) for k in range(4)],
                      flush=False)

    def refresh(self, q, start, end, check_cold=True):
        """Serve [start, end] on both sides at one frozen now; the rows,
        and the cache's counters since the start, agree."""
        now_s = time.time()
        now_ms = int(now_s * 1000)
        with frozen(now_s):
            ec_p, ec_r = self.pair.ecs(start=start, end=end)
            got = serve(_PORT, self.pair.port, ec_p, q, now_ms)
            want = serve(_REF, self.pair.ref, ec_r, q, now_ms)
        same_rows(got, want, f"{q} [{start}, {end}]")
        dp = np.subtract(_counts(_PORT), self.c0[0])
        dr = np.subtract(_counts(_REF), self.c0[1])
        assert dp.tolist() == dr.tolist(), (q, dp, dr)
        if check_cold:
            assert _sha(got) == _sha(self.cold(q, start, end)), \
                f"{q} [{start}, {end}] diverged from cold"
        return got, ec_p, ec_r

    def cold(self, q, start, end):
        ec_p, _ = self.pair.ecs(start=start, end=end, disable_cache=True)
        return port_exec.exec_query(ec_p, q)


@pytest.fixture(autouse=True)
def _fresh_cache():
    port_rrc.GLOBAL.reset()
    ref_rrc.GLOBAL.reset()
    yield
    port_rrc.GLOBAL.reset()
    ref_rrc.GLOBAL.reset()
    os.environ.pop("VM_RESULT_CACHE_RING", None)


@pytest.fixture()
def ring(tmp_path):
    r = Ring(tmp_path)
    yield r
    r.close()


def _inplace(side):
    return side["metrics"].REGISTRY.counter(
        "vm_rollup_cache_inplace_total").get()


@pytest.mark.parametrize("q", QUERIES)
def test_rolling_refreshes(ring, q):
    inp0 = _inplace(_PORT)
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    for r in range(4):
        end += STEP
        ring.ingest(end, bump=r)
        ring.refresh(q, end - DUR, end)
    assert _inplace(_PORT) > inp0


def test_new_series_appears_and_vanishes(ring):
    q = QUERIES[0]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    # series i=0 vanishes, i=NS..NS+3 appear mid-window
    for r in range(3):
        end += STEP
        ring.ingest(end, lo=1, hi=NS + 4, bump=10 * r)
        ring.refresh(q, end - DUR, end)


def test_backfill_resets_and_recovers(ring):
    q = QUERIES[0]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    # a backfill far behind the OFFSET window resets both caches
    ring.pair.add([({"__name__": "ringm", "i": "0", "g": "g0"},
                    end - 3 * DUR, 1.0)], flush=False)
    assert port_rrc.GLOBAL.stats()["entries"] == 0
    assert ref_rrc.GLOBAL.stats()["entries"] == 0
    for r in range(2):
        end += STEP
        ring.ingest(end, bump=50 + r)
        ring.refresh(q, end - DUR, end)


@pytest.mark.parametrize("q", QUERIES)
def test_ring_on_off_identical_rows(tmp_path, q):
    """VM_RESULT_CACHE_RING=0 and =1 give identical rows for the same
    refresh sequence, on both sides."""
    shas = {}
    for flag in ("0", "1"):
        os.environ["VM_RESULT_CACHE_RING"] = flag
        port_rrc.GLOBAL.reset()
        ref_rrc.GLOBAL.reset()
        r = Ring(tmp_path / f"ring{flag}")
        try:
            end = r.end0
            r.refresh(q, end - DUR, end)
            seq = []
            for k in range(3):
                end += STEP
                r.ingest(end, bump=k)
                seq.append(_sha(r.refresh(q, end - DUR, end)[0]))
            shas[flag] = seq
        finally:
            r.close()
    assert shas["0"] == shas["1"]


def test_views_stay_valid_across_compaction(ring):
    """A merge that compacts into a fresh buffer leaves the rows of the
    previous merge intact (the old buffer is not written)."""
    q = QUERIES[0]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    prev = prev_copy = None
    for r in range(port_rrc.COL_HEADROOM + 4):
        end += STEP
        ring.ingest(end, bump=r)
        served = ring.refresh(q, end - DUR, end, check_cold=r % 8 == 0)[0]
        if prev is not None:
            for ts, want in zip(prev, prev_copy):
                np.testing.assert_array_equal(ts.values, want)
        prev = served
        prev_copy = [ts.values.copy() for ts in served]


def test_held_rows_survive_next_merge_with_changed_tail(ring):
    q = QUERIES[0]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    end += STEP
    ring.ingest(end)
    held = ring.refresh(q, end - DUR, end)[0]
    held_copy = [ts.values.copy() for ts in held]
    # a late sample in the volatile tail: newer than the entry's coverage
    # (no backfill reset) but inside held's window
    ring.pair.add([({"__name__": "ringm", "i": "0", "g": "g0"},
                    end - 2 * STEP + 7_000, 99_999.0)], flush=False)
    end += STEP
    ring.ingest(end, bump=3)
    ring.refresh(q, end - DUR, end)
    for ts, want in zip(held, held_copy):
        np.testing.assert_array_equal(ts.values, want)


def test_nonlive_window_refresh_stays_o_suffix(ring):
    """A window ending before now - OFFSET gets a single-column tail per
    refresh, widened to a 2-point sub-evaluation that must not clobber
    the evaluation-level entries."""
    q = QUERIES[0]
    end = ring.end0 - 20 * STEP
    dur = 60 * STEP
    ec_p, _ = ring.pair.ecs(start=end - dur, end=end, disable_cache=True)
    port_exec.exec_query(ec_p, q)
    cold_samples = ec_p.samples_scanned
    assert cold_samples > 0
    ring.refresh(q, end - dur, end)
    for r in range(3):
        end += STEP
        _, ec_p, ec_r = ring.refresh(q, end - dur, end)
        assert ec_p.samples_scanned == ec_r.samples_scanned
        assert ec_p.samples_scanned < 0.3 * cold_samples
        ev_p, ev_r = ring.pair.ecs(start=end - dur, end=end)
        same_rows(port_exec.exec_query(ev_p, q), ref_exec.exec_query(ev_r, q))
        assert ev_p.samples_scanned == ev_r.samples_scanned
        assert ev_p.samples_scanned < 0.3 * cold_samples, r


def test_full_hit_after_noop_put_is_filtered_and_sorted(ring):
    q = "rate(ringm[5m])"
    end0 = ring.end0
    # a series that exists only just after the initial window end: rolling
    # over it appends its row at the end of the ring entry, while its
    # label sorts first
    ring.pair.add([({"__name__": "ringm", "i": "!!", "g": "g0"},
                    end0 - 19 * STEP + k * SCRAPE, float(k))
                   for k in range(8)])
    end = end0 - 20 * STEP
    dur = 30 * STEP
    ring.refresh(q, end - dur, end)
    for _ in range(3):
        end += STEP
        ring.refresh(q, end - dur, end)
    full = ring.refresh(q, end - dur, end)[0]
    raws = [ts.raw for ts in full]
    assert any(b"!!" in r for r in raws)
    assert raws == sorted(raws)
    assert not any(np.isnan(ts.values).all() for ts in full)


def test_merged_rows_are_read_only_views(ring):
    q = QUERIES[0]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    end += STEP
    ring.ingest(end)
    served = ring.refresh(q, end - DUR, end)[0]
    assert served and not served[0].values.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        served[0].values[0] = 1.0


def test_read_only_views_survive_group_join_dup_merge():
    """group_left with duplicate joined names merges the 'one' side in
    place; the destination owns its values, so read-only inputs (a ring
    hit's views) are left untouched -- as in the reference."""
    from victoriametrics_tpu.query.binary_op import \
        eval_binary_op as ref_binop
    from victoriametrics_tpu.query.metricsql.ast import \
        ModifierExpr as RefModifier
    from victoriametrics_tpu.query.types import Timeseries as RefSeries
    from victoriametrics_tpu_torch.query.binary_op import eval_binary_op
    from victoriametrics_tpu_torch.query.metricsql.ast import ModifierExpr
    from victoriametrics_tpu_torch.query.types import Timeseries

    def ro(vals):
        a = np.array(vals)
        a.setflags(write=False)
        return a

    def run(series_cls, name_cls, binop, modifier):
        many = [series_cls(name_cls(b"m", [(b"instance", b"a")]),
                           ro([1.0, 2.0, 3.0, 4.0]))]
        one = [series_cls(name_cls(b"o", [(b"instance", b"a"),
                                          (b"le", b"x")]),
                          ro([1.0, np.nan, np.nan, np.nan])),
               series_cls(name_cls(b"o", [(b"instance", b"a"),
                                          (b"le", b"y")]),
                          ro([np.nan, 2.0, 2.0, 2.0]))]
        out = binop("*", many, one, False,
                    modifier(op="on", args=["instance"]),
                    modifier(op="group_left"), False)
        np.testing.assert_array_equal(one[0].values,
                                      [1.0, np.nan, np.nan, np.nan])
        return out

    got = run(Timeseries, MetricName, eval_binary_op, ModifierExpr)
    want = run(RefSeries, RefName, ref_binop, RefModifier)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].values, [1.0, 4.0, 6.0, 8.0])
    same_rows(got, want)


class _St:
    def __init__(self, token):
        self.cache_token = token


def _mk_rows(side, n, label=b"0"):
    r = [side["types"].new_series(np.arange(n, dtype=np.float64),
                                  labels=[(b"i", label)])]
    for ts in r:
        ts.raw = ts.metric_name.marshal()
    return r


def _grid():
    now = int(time.time() * 1000)
    start = (now - 3600_000) // STEP * STEP
    return now, start, start + 10 * STEP


def test_partial_results_never_committed_inplace():
    """A partial suffix takes the rebuild path and the entry keeps its
    pre-merge coverage, on both sides."""
    now, start, end = _grid()
    out = []
    for side in (_PORT, _REF):
        c = side["rrc"].RollupResultCache(max_entries=8)
        EC = side["types"].EvalConfig
        ec = EC(start=start, end=end, step=STEP, storage=_St(991201))
        c.put(ec, "q", _mk_rows(side, ec.n_points), now)
        ec2 = EC(start=start + STEP, end=end + STEP, step=STEP,
                 storage=_St(991201))
        hit, new_start = c.get(ec2, "q", now)
        assert hit is not None and new_start == end + STEP
        gen0, c_end0 = hit.entry.gen, hit.entry.c_end
        ec2._partial[0] = True
        rows = c.merge(hit, _mk_rows(side, 1), ec2, new_start, now_ms=now)
        assert len(rows) == 1
        assert hit.entry.gen == gen0 and hit.entry.c_end == c_end0
        out.append(rows)
    same_rows(*out)


def test_compaction_prunes_vanished_series_rows(ring):
    """Series churn does not grow a hot entry's rows without bound: rows
    whose remaining prefix is all-NaN drop at compaction, on both sides
    at the same refresh."""
    q = QUERIES[1]
    end = ring.end0
    ring.refresh(q, end - DUR, end)
    rounds = 2 * (port_rrc.COL_HEADROOM + DUR // STEP) + 8
    for r in range(rounds):
        end += STEP
        ring.ingest(end, lo=r + 1, hi=r + 1 + NS, bump=r)
        ring.refresh(q, end - DUR, end, check_cold=r % 32 == 0)
    rows = []
    for side, store in ((_PORT, ring.pair.port), (_REF, ring.pair.ref)):
        g = side["rrc"].GLOBAL
        with g._lock:
            e = g._cache.get((store.cache_token, (0, 0), q, STEP))
        assert e is not None
        assert e.n_rows < NS + DUR // STEP + port_rrc.COL_HEADROOM + 16
        assert e.n_rows < NS + rounds
        rows.append((e.n_rows, e.col_off, e.c_start, e.c_end))
    assert rows[0] == rows[1]


def test_byte_bound_evicts_lru():
    now, start, end = _grid()
    for side in (_PORT, _REF):
        c = side["rrc"].RollupResultCache(max_entries=100, max_bytes=1)
        for i in range(5):
            ec = side["types"].EvalConfig(start=start, end=end, step=STEP,
                                          storage=_St(991199))
            c.put(ec, f"q{i}", _mk_rows(side, ec.n_points,
                                        str(i).encode()), now)
        # every entry is over the 1-byte budget: only the MRU one stays
        assert c.entry_count() == 1
        assert c.size_bytes() > 0
        assert c.max_bytes == 1
    assert port_rrc.RollupResultCache(max_entries=1).max_bytes == \
        ref_rrc.RollupResultCache(max_entries=1).max_bytes


def test_put_identity_skip_counts_inplace():
    now, start, end = _grid()
    for side in (_PORT, _REF):
        c = side["rrc"].RollupResultCache(max_entries=8)
        ec = side["types"].EvalConfig(start=start, end=end, step=STEP,
                                      storage=_St(991200))
        rows = _mk_rows(side, ec.n_points)
        ctr = side["metrics"].REGISTRY.counter(
            "vm_rollup_cache_put_identity_reused_total")
        r0 = ctr.get()
        c.put(ec, "q", rows, now)
        c.put(ec, "q", rows, now)
        assert ctr.get() == r0 + 1


def test_refresh_fetches_only_the_suffix(tmp_path):
    """A rolling refresh through the cached executor scans only the
    uncovered suffix, on both sides, the same samples."""
    nn, ns = 1500, 8
    q = "sum by (g)(rate(guard[2m]))"
    now = int(time.time() * 1000)
    t0 = (now - (nn - 1) * SCRAPE) // STEP * STEP
    rng = np.random.default_rng(3)
    rows = []
    for i in range(ns):
        vals = np.cumsum(rng.integers(0, 30, nn)).astype(np.float64)
        rows.extend((({"__name__": "guard", "i": str(i), "g": f"g{i % 2}"},
                      t0 + j * SCRAPE, float(vals[j])) for j in range(nn)))
    r = Ring.__new__(Ring)
    r.pair = Pair(tmp_path, rows)
    r.c0 = (_counts(_PORT), _counts(_REF))
    try:
        end = t0 + ((nn - 1) * SCRAPE // STEP + 1) * STEP
        dur = (nn - 1) * SCRAPE // STEP * STEP - 10 * STEP
        ec_p, _ = r.pair.ecs(start=end - dur, end=end, disable_cache=True)
        port_exec.exec_query(ec_p, q)
        cold_samples = ec_p.samples_scanned
        assert cold_samples > 0
        r.refresh(q, end - dur, end)
        inp0 = _inplace(_PORT)
        phase = port_metrics.REGISTRY.float_counter(
            'vm_fetch_phase_seconds_total{phase="index_search"}')
        phase0 = phase.get()
        for k in range(3):
            end += STEP
            r.pair.add([({"__name__": "guard", "i": str(i),
                          "g": f"g{i % 2}"},
                         end - STEP + (j + 1) * SCRAPE, float(10_000 + k + j))
                        for i in range(ns) for j in range(4)], flush=False)
            served, ec_p, ec_r = r.refresh(q, end - dur, end)
            assert len(served) == 2
            assert ec_p.samples_scanned == ec_r.samples_scanned
            assert ec_p.samples_scanned < 0.05 * cold_samples, k
        assert phase.get() >= phase0
        assert _inplace(_PORT) > inp0
    finally:
        r.close()


def _ring_pair(G, T, seed):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((G, T))
    out[rng.random((G, T)) < 0.1] = np.nan
    start, step, window = 3_600_000, STEP, 300_000
    end = start + (T - 1) * step
    return (port_rrc.RingBlock(out, start, end, step, window),
            ref_rrc.RingBlock(out, start, end, step, window), rng)


def _same_block(pb, rb, got, want):
    assert (pb.G, pb.T, pb.col_off, pb.start, pb.end) == \
        (rb.G, rb.T, rb.col_off, rb.start, rb.end)
    assert len(got) == len(want) == pb.G
    for a, b in zip(got, want):
        assert not a.flags.writeable and not b.flags.writeable
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_new", list(range(0, 12)))
def test_ring_block_advances_as_the_reference(n_new):
    """RingBlock.try_advance / commit at each column count: the same
    number of tail columns, the same buffer offsets and the same rows,
    through enough advances to compact the headroom (and with the
    previous rows held alive, which forces a fresh buffer)."""
    T = 12
    pb, rb, rng = _ring_pair(5, T, 100 + n_new)
    held = []
    for k in range(port_rrc.COL_HEADROOM // max(n_new, 1) + 3):
        start, end = pb.start + n_new * STEP, pb.end + n_new * STEP
        a = pb.try_advance(start, end, STEP, 300_000)
        b = rb.try_advance(start, end, STEP, 300_000)
        assert a == b
        if n_new >= T:
            assert a is None
            return
        assert a == n_new
        tail = rng.standard_normal((5, n_new))
        got = pb.commit(start, end, tail if n_new else None)
        want = rb.commit(start, end, tail if n_new else None)
        _same_block(pb, rb, got, want)
        if k % 3 == 0:
            held.append(got)  # an in-flight response keeps its views
        else:
            held.clear()


def test_ring_block_declines_as_the_reference():
    T = 10
    pb, rb, _ = _ring_pair(3, T, 5)
    s, e = pb.start, pb.end
    for args in [(s + STEP, e + STEP, 2 * STEP, 300_000),   # another step
                 (s + STEP, e + STEP, STEP, 600_000),       # another window
                 (s - STEP, e - STEP, STEP, 300_000),       # backwards
                 (s + STEP, e + 2 * STEP, STEP, 300_000),   # grows
                 (s + T * STEP, e + T * STEP, STEP, 300_000),  # disjoint
                 (s + 30_000, e + 30_000, STEP, 300_000)]:  # off phase
        assert pb.try_advance(*args) is None
        assert rb.try_advance(*args) is None
    out = np.arange(3 * T, dtype=np.float64).reshape(3, T)
    pb.reset(out, s, e, STEP, 300_000)
    rb.reset(out, s, e, STEP, 300_000)
    _same_block(pb, rb, pb.rows(), rb.rows())
