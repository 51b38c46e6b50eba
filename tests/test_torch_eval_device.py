"""The port's evaluator on its device engine (``EvalConfig(tpu=
CUDAEngine(device="cpu"))``: the plain versions of the kernels) against
the JAX package's evaluator on ``TPUEngine(value_dtype=np.float64,
mesh=None)``, each over its own Storage fed the same rows (anchored two
days or less before the wall clock).

Mirrors, beside a reference engine:

  * ``tests/test_rolling_tile.py``: rolling advances, a repeat without
    ingest, late data, a new series and a delete forcing a rebuild,
    old-history truncation, advances until capacity (and on a mesh);
  * ``tests/test_device_residency.py``: the tail-only upload of a
    refresh, the ``VM_DEVICE_RESIDENT=0`` oracle, the window slide with
    K4, ``compact_window`` past int32, and the churn backoff of
    ``device_window_ready``;
  * ``tests/test_served_device_path.py``: both grid edges advancing,
    direct and through the serving layer's cached executor;
  * ``tests/test_exec_query_mesh.py``: a port ``make_mesh(8, 1,
    ["cpu"] * 8)`` against the unsharded port and the reference's
    8-device run.

Beyond mirroring, every device route is asserted by its kernel calls
(``cuda_engine.timed_kernel_call`` counted by kernel name, and the
columns of each K2/B8 output): cold (K1 + K2, or K1 + B5 + B8), warm aux
(K2 alone, no store fetch), rolling tail (K3 + K2 over the new columns
and one more), pure shift (no kernel), rebuild (K1 again), per-series
(B5), topk (B5 + B6 + take_rows) and topk_<kind> (B5 + B7 + take_rows).
Values: the port's device rows equal the reference's device rows at rtol
1e-12, and the port's host rows (a ``disable_cache`` evaluation) at rtol
1e-12, stddev/stdvar at tests/test_torch_device_rollup.py's allowance for
the reference's cancellation (rtol 1e-9)."""

import collections
import time

import numpy as np
import pytest
import torch

from test_torch_exec import Pair, close_rows, named
from test_torch_rollup_result_cache import serve as cached_serve
from victoriametrics_tpu.query import exec as ref_exec
from victoriametrics_tpu.query import rollup_result_cache as ref_rrc
from victoriametrics_tpu.query.tpu_engine import TPUEngine
from victoriametrics_tpu.storage.tag_filters import TagFilter as RefFilter
from victoriametrics_tpu_torch.models import tile_cache as tclib
from victoriametrics_tpu_torch.ops.device_rollup import TS_PAD
from victoriametrics_tpu_torch.parallel.mesh import make_mesh
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import eval as port_eval
from victoriametrics_tpu_torch.query import exec as port_exec
from victoriametrics_tpu_torch.query import fleet
from victoriametrics_tpu_torch.query import rollup_result_cache as port_rrc
from victoriametrics_tpu_torch.query.metricsql import parse
from victoriametrics_tpu_torch.storage.tag_filters import TagFilter
from victoriametrics_tpu_torch.utils import metrics as metricslib

DAY = 86_400_000
STEP = 60_000
SCRAPE = 15_000
# the reference tests' T0 grid, two days back
T0 = (int(time.time() * 1000) - 2 * DAY) // STEP * STEP + 20_000


def _ref_engine(**kw):
    return TPUEngine(min_series=4, value_dtype=np.float64,
                     mesh=kw.pop("mesh", None), **kw)


def _port_engine(**kw):
    return ce.CUDAEngine(device="cpu", min_series=4, **kw)


class Calls:
    """Kernel dispatches by kernel name (every engine dispatch goes through
    cuda_engine.timed_kernel_call), the output columns of each K2 and B8
    call, and the port store's fetches."""

    def __init__(self):
        self.n = collections.Counter()
        self.cols = []
        self.fetches = 0

    def take(self):
        n, cols, f = dict(self.n), list(self.cols), self.fetches
        self.n.clear()
        self.cols.clear()
        self.fetches = 0
        return n, cols, f


@pytest.fixture()
def calls(monkeypatch):
    c = Calls()
    real = ce.timed_kernel_call

    def counting(kernel, fn, *a, **kw):
        out = real(kernel, fn, *a, **kw)
        c.n[kernel] += 1
        if kernel in ("rollup_aggregate_tile", "rollup_quantile_tile",
                      "sharded_rollup_aggregate"):
            c.cols.append(int(out.shape[-1]))
        return out

    monkeypatch.setattr(ce, "timed_kernel_call", counting)
    monkeypatch.setattr(fleet, "timed_kernel_call", counting)
    return c


def watch_fetches(monkeypatch, store, calls):
    """Count the store's searches (a search_series that reads through
    search_columns counts once)."""
    depth = [0]
    for name in ("search_series", "search_columns"):
        real = getattr(store, name)

        def wrapped(*a, _real=real, **kw):
            calls.fetches += depth[0] == 0
            depth[0] += 1
            try:
                return _real(*a, **kw)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(store, name, wrapped)


def _rtol(q):
    return 1e-9 if ("stddev" in q or "stdvar" in q) else 1e-12


class Dash:
    """A Pair of stores with a port and a reference engine."""

    def __init__(self, pair, port_engine=None, ref_engine=None):
        self.pair = pair
        self.port_engine = port_engine or _port_engine()
        self.ref_engine = ref_engine or _ref_engine()

    def run(self, q, start, end, drift_tail=None, **kw):
        """(port device rows, reference device rows): the two agree, and
        the port's rows equal its host oracle (a full recompute).  With
        `drift_tail` = n the rows are a rolling refresh whose first
        columns the ring reused: the last n columns still equal the
        oracle, the reused ones may keep the scrape-interval estimates
        they were computed under (drift_close)."""
        ec_p, ec_r = self.pair.ecs(start=start, end=end,
                                   port_tpu=self.port_engine,
                                   ref_tpu=self.ref_engine, **kw)
        got = port_exec.exec_query(ec_p, q)
        want = ref_exec.exec_query(ec_r, q)
        close_rows(got, want, f"{q} port vs reference device", _rtol(q))
        host = self.host(q, start, end)
        if drift_tail is None:
            close_rows(got, host, f"{q} device vs host", _rtol(q))
        else:
            drift_close(got, host, drift_tail, q)
        return got, want

    def host(self, q, start, end):
        ec_p, _ = self.pair.ecs(start=start, end=end, disable_cache=True)
        return port_exec.exec_query(ec_p, q)


def drift_close(got, host, tail, ctx=""):
    """A rolling refresh against a cold evaluation: the last `tail`
    columns (computed now) at rtol 1e-12; the columns the ring reused
    kept the scrape-interval estimates of the refresh that computed them,
    and a jittered scrape may flip one window's previous-sample gate
    since.  That is the reference's contract (its rollupResultCache
    tail-merge, rollup_result_cache.go:283), bounded as
    tests/test_served_device_path.py bounds it: under 6 % relative, on
    under 5 % of the cells."""
    assert [k for k, _ in named(got)] == [k for k, _ in named(host)], ctx
    rel_all = []
    for (k, a), (_, b) in zip(named(got), named(host)):
        np.testing.assert_allclose(a[-tail:], b[-tail:], rtol=1e-12,
                                   equal_nan=True, err_msg=f"{ctx} {k!r}")
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(a)
        rel_all.append(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-9))
    rel = np.concatenate(rel_all)
    assert float(rel.max()) < 0.06, (ctx, float(rel.max()))
    assert (rel > 1e-4).mean() < 0.05, ctx


def _rt_rows(n_series, n_samples, seed=21, name="rt"):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_series):
        base = np.arange(n_samples, dtype=np.int64) * SCRAPE + T0 - 600_000
        ts = np.sort(base + rng.integers(-2000, 2001, n_samples))
        vals = np.cumsum(rng.integers(0, 30, n_samples)).astype(float)
        lab = {"__name__": name, "instance": f"h{i % 8}", "job": f"j{i % 3}"}
        rows.extend(zip([lab] * n_samples, ts.tolist(), vals.tolist()))
    return rows


def _rt_newer(t_lo, n=4, n_series=80):
    # seeded by the offset from T0, so every run gets the same data
    rng = np.random.default_rng(int(t_lo - T0) % 2**31)
    rows = []
    for i in range(n_series):
        ts = t_lo + np.arange(n, dtype=np.int64) * SCRAPE + \
            rng.integers(0, 2000)
        vals = (1000 + np.cumsum(rng.integers(0, 30, n))).astype(float)
        lab = {"__name__": "rt", "instance": f"h{i % 8}", "job": f"j{i % 3}"}
        rows.extend(zip([lab] * n, ts.tolist(), vals.tolist()))
    return rows


def _rolling_tiles(engine):
    from victoriametrics_tpu.query.tpu_engine import RollingTile
    wc = engine._wcache
    vals = list(wc._entries.values()) if wc is not None else []
    return [v for v in vals if isinstance(v, (ce.RollingTile, RollingTile))]


@pytest.fixture()
def dash(tmp_path):
    pair = Pair(tmp_path, _rt_rows(80, 60))
    yield Dash(pair)
    pair.close()


ROLL_QUERIES = [
    "sum by (instance)(rate(rt[5m]))",
    "avg by (job)(increase(rt[3m]))",
    "quantile(0.9, rate(rt[5m])) by (instance)",
]


def _cold_route(q):
    if q.startswith("quantile"):
        return {"decode_tiles": 1, "rollup_tile": 1,
                "rollup_quantile_tile": 1}
    return {"decode_tiles": 1, "rollup_aggregate_tile": 1}


def _tail_route(q):
    if q.startswith("quantile"):
        return {"append_tile": 1, "rollup_tile": 1,
                "rollup_quantile_tile": 1}
    return {"append_tile": 1, "rollup_aggregate_tile": 1}


@pytest.mark.parametrize("q", ROLL_QUERIES)
def test_rolling_advance_matches_host(dash, calls, q):
    dash.run(q, T0 - 300_000, T0)
    assert calls.take()[0] == _cold_route(q)
    rts = _rolling_tiles(dash.port_engine)
    assert len(rts) == 1
    # live ingest newer than the covered range, the window one step on:
    # the slice is appended (K3) and only the new column runs, with one
    # leading column (the ring tail)
    dash.pair.add(_rt_newer(T0 + 10_000))
    dash.run(q, T0 - 240_000, T0 + STEP)
    n, cols, _ = calls.take()
    assert n == _tail_route(q), n
    assert cols[-1] == 2
    assert rts[0].appends == 1
    dash.pair.add(_rt_newer(T0 + 80_000))
    dash.run(q, T0 - 180_000, T0 + 2 * STEP)
    n, cols, _ = calls.take()
    assert n == _tail_route(q) and cols[-1] == 2
    assert rts[0].appends == 2
    assert _rolling_tiles(dash.ref_engine)[0].appends == 2


def test_repeat_without_ingest_served_from_tile(dash, calls):
    q = ROLL_QUERIES[0]
    dash.run(q, T0 - 300_000, T0)
    rts = _rolling_tiles(dash.port_engine)
    calls.take()
    # the same end, a later start: inside the coverage, no append; the
    # grid does not slide by whole columns of the ring, so K2 runs over
    # the full grid on the resident tile (no K1)
    dash.run(q, T0 - 240_000, T0)
    n, cols, _ = calls.take()
    assert n == {"rollup_aggregate_tile": 1} and cols == [5]
    assert rts[0].appends == 0
    # the same grid again: a pure shift, no kernel at all
    dash.run(q, T0 - 240_000, T0)
    assert calls.take()[0] == {}
    # the end past the covered bound with no new ingest: the data beyond
    # the old fetch bound is still sliced in
    dash.run(q, T0 - 240_000, T0 + STEP)
    assert calls.take()[0] == {"append_tile": 1, "rollup_aggregate_tile": 1}
    assert rts[0].appends == 1


def test_warm_aux_path_skips_the_fetch(dash, calls, monkeypatch):
    """The same query on unchanged data: K2 on the cached tile with the
    cached groups, no K1 and no store fetch."""
    watch_fetches(monkeypatch, dash.pair.port, calls)
    q = ROLL_QUERIES[0]
    ec = dash.pair.ecs(start=T0 - 300_000, end=T0,
                       port_tpu=dash.port_engine)[0]
    cold = port_exec.exec_query(ec, q)
    n, _, fetches = calls.take()
    assert n == _cold_route(q) and fetches == 1
    ec2 = dash.pair.ecs(start=T0 - 300_000, end=T0,
                        port_tpu=dash.port_engine)[0]
    warm = port_exec.exec_query(ec2, q)
    n, cols, fetches = calls.take()
    assert n == {"rollup_aggregate_tile": 1} and cols == [6]
    assert fetches == 0
    assert ec2.samples_scanned == ec.samples_scanned
    close_rows(warm, cold, q)


@pytest.mark.parametrize("q, route", [
    ("rate(rt[5m])", {"decode_tiles": 1, "rollup_tile": 1}),
    ("topk(3, rate(rt[5m]))",
     {"decode_tiles": 1, "rollup_tile": 1, "topk_select_tile": 1,
      "take_rows": 1}),
    ("bottomk(2, increase(rt[3m]))",
     {"decode_tiles": 1, "rollup_tile": 1, "topk_select_tile": 1,
      "take_rows": 1}),
    ("topk_max(3, rate(rt[5m]))",
     {"decode_tiles": 1, "rollup_tile": 1, "rank_tile": 1, "take_rows": 1}),
    ("bottomk_median(4, rate(rt[5m]))",
     {"decode_tiles": 1, "rollup_tile": 1, "rank_tile": 1, "take_rows": 1}),
    ("median(rate(rt[5m])) by (job)",
     {"decode_tiles": 1, "rollup_tile": 1, "rollup_quantile_tile": 1}),
    ("stddev by (job)(avg_over_time(rt[5m]))",
     {"decode_tiles": 1, "rollup_aggregate_tile": 1}),
])
def test_cold_routes(dash, calls, q, route):
    dash.run(q, T0 - 300_000, T0)
    assert calls.take()[0] == route


@pytest.mark.parametrize("q", [
    "sum by (instance)(rate(rt[5m]))",  # below min_series: declined
    "sum(holt_winters(rt[5m], 0.5, 0.5))",  # not a device func
])
def test_declines_run_no_kernel(tmp_path, calls, q):
    pair = Pair(tmp_path, _rt_rows(80, 60))
    try:
        d = Dash(pair, port_engine=_port_engine() if "holt" in q else
                 ce.CUDAEngine(device="cpu", min_series=1000),
                 ref_engine=_ref_engine() if "holt" in q else
                 TPUEngine(min_series=1000, value_dtype=np.float64,
                           mesh=None))
        d.run(q, T0 - 300_000, T0)
        assert calls.take()[0] == {}
    finally:
        pair.close()


def _rebuild_after(dash, calls, mutate):
    q = ROLL_QUERIES[0]
    dash.run(q, T0 - 300_000, T0)
    rts = _rolling_tiles(dash.port_engine)
    calls.take()
    mutate()
    dash.run(q, T0 - 240_000, T0 + STEP)
    n, _, _ = calls.take()
    assert n == _cold_route(q), n
    assert rts[0].appends == 0
    assert dash.port_engine.last_roll_decline
    return dash.port_engine.last_roll_decline


def test_late_data_forces_rebuild(dash, calls):
    lab = {"__name__": "rt", "instance": "h0", "job": "j0"}
    why = _rebuild_after(dash, calls, lambda: dash.pair.add(
        [(lab, T0 - 450_000 + 7, 123.0)]))
    assert why == "late data landed inside the covered range"


def test_new_series_forces_rebuild(dash, calls):
    lab = {"__name__": "rt", "instance": "hNEW", "job": "jNEW"}
    ts = T0 + 10_000 + np.arange(4, dtype=np.int64) * SCRAPE
    why = _rebuild_after(dash, calls, lambda: dash.pair.add(
        [(lab, int(t), float(i)) for i, t in enumerate(ts)]))
    assert why == "new series appeared"


def test_delete_forces_rebuild(dash, calls):
    def delete():
        dash.pair.port.delete_series(
            [TagFilter(b"instance", b"h7", False, False)])
        dash.pair.ref.delete_series(
            [RefFilter(b"instance", b"h7", False, False)])
    why = _rebuild_after(dash, calls, delete)
    assert why == "deletes/retention changed visible data"


def test_rolling_on_mesh(tmp_path, calls):
    pair = Pair(tmp_path, _rt_rows(81, 60))  # 81 rows: the pad path
    try:
        d = Dash(pair, port_engine=_port_engine(
            mesh=make_mesh(8, 1, ["cpu"] * 8)))
        q = ROLL_QUERIES[0]
        d.run(q, T0 - 300_000, T0)
        assert calls.take()[0] == {"decode_tiles": 1,
                                   "sharded_rollup_aggregate": 1}
        rts = _rolling_tiles(d.port_engine)
        assert isinstance(rts[0].tiles[0], list)
        assert len(rts[0].tiles[0]) == 8
        pair.add(_rt_newer(T0 + 10_000, n_series=81))
        d.run(q, T0 - 240_000, T0 + STEP)
        assert calls.take()[0] == {"append_tile": 1,
                                   "sharded_rollup_aggregate": 1}
        assert rts[0].appends == 1
    finally:
        pair.close()


def test_old_history_prev_sample_truncation(tmp_path, calls):
    """A rolling tile keeps more history than a later query fetches: the
    funcs seeded by the sample before the window behave as if it were
    cut at the query's fetch bound (the kernels' min_ts gate)."""
    rows = []
    for i in range(70):
        lab = {"__name__": "gap", "instance": f"h{i % 7}"}
        rows.append((lab, T0 - 550_000 + i, 100.0 + i))
        for k in range(12):
            rows.append((lab, T0 - 180_000 + k * SCRAPE + i, 200.0 + k + i))
    pair = Pair(tmp_path, rows)
    try:
        d = Dash(pair)
        for q in ("sum by (instance)(delta(gap[4m]))",
                  "sum by (instance)(increase(gap[4m]))",
                  "sum by (instance)(changes(gap[4m]))"):
            d.run(q, T0 - 300_000, T0)
            d.run(q, T0 + 60_000, T0 + 120_000)
        rts = _rolling_tiles(d.port_engine)
        assert rts and all(rt.appends <= 1 for rt in rts)
        assert "decode_tiles" in calls.n
    finally:
        pair.close()


def test_many_advances_until_capacity(tmp_path, calls):
    """Advance until the headroom runs out: the tile is rebuilt where the
    reference's is, for the reason the reference gives, every step equals
    the reference's, and the host's as a rolling refresh does
    (drift_close: this data flips one reused column's gate, in the
    reference as in the port)."""
    pair = Pair(tmp_path, _rt_rows(70, 60))
    try:
        d = Dash(pair)
        q = ROLL_QUERIES[0]
        d.run(q, T0 - 300_000, T0)
        calls.take()
        end = T0
        frontier = T0 + 285_000 + SCRAPE
        declines = []
        for _ in range(12):
            pair.add(_rt_newer(frontier, n=8, n_series=70))
            frontier += 8 * SCRAPE
            end += STEP * 2
            d.port_engine.last_roll_decline = ""
            d.ref_engine.last_roll_decline = ""
            d.run(q, end - 300_000, end, drift_tail=2)
            assert d.port_engine.last_roll_decline == \
                d.ref_engine.last_roll_decline
            n = calls.take()[0]
            declines.append(d.port_engine.last_roll_decline)
            if declines[-1]:
                assert n == _cold_route(q), n
            else:
                assert n == _tail_route(q), n
        assert "column headroom exhausted" in declines
        assert declines.count("") >= 6
    finally:
        pair.close()


# -- residency (tests/test_device_residency.py) ------------------------------

NS = 64
RESG = "sum by (g)(rate(resg[5m]))"


def _resg_rows(n_samples, seed=5):
    now = int(time.time() * 1000)
    t0 = (now - (n_samples - 1) * SCRAPE) // STEP * STEP
    rng = np.random.default_rng(seed)
    rows = []
    vals0 = np.empty(NS)
    for i in range(NS):
        ts = np.sort(np.arange(n_samples, dtype=np.int64) * SCRAPE + t0 +
                     rng.integers(-2000, 2001, n_samples))
        vals = np.cumsum(rng.integers(0, 30, n_samples)).astype(np.float64)
        vals0[i] = vals[-1]
        rows.extend(zip([{"__name__": "resg", "i": str(i),
                          "g": f"g{i % 4}"}] * n_samples,
                        ts.tolist(), vals.tolist()))
    end0 = t0 + -(-((n_samples - 1) * SCRAPE + 2000) // STEP) * STEP
    return rows, end0, vals0, rng


def _resg_ingest(rng, vals0, end, k=4):
    rows = []
    for i in range(NS):
        incr = np.cumsum(rng.integers(0, 30, k))
        ts = end - (np.arange(k, dtype=np.int64)[::-1]) * SCRAPE - \
            rng.integers(0, 2000)
        rows.extend(zip([{"__name__": "resg", "i": str(i),
                          "g": f"g{i % 4}"}] * k,
                        ts.tolist(), (vals0[i] + incr).tolist()))
        vals0[i] += incr[-1]
    return rows


def serve(side_engine, store, ec, q, now_ms, exec_mod, eval_mod, rrc_mod):
    """The serving layer's cached range executor with its device shortcut:
    a shape whose rolling window is resident runs the full evaluation."""
    if ec.tpu is not None and \
            eval_mod.device_window_ready(ec, port_exec.parse_cached(q)
                                         if exec_mod is port_exec else
                                         ref_exec.parse_cached(q)):
        rows = exec_mod.exec_query(ec, q)
        rrc_mod.GLOBAL.put(ec, q, rows, now_ms, trust_raw=False)
        return rows
    side = {"exec": exec_mod, "eval": eval_mod, "rrc": rrc_mod}
    return cached_serve(side, store, ec, q, now_ms)


def _serve_both(pair, pe, re_, q, start, end, **kw):
    from victoriametrics_tpu.query import eval as ref_eval
    ec_p, ec_r = pair.ecs(start=start, end=end, port_tpu=pe, ref_tpu=re_,
                          **kw)
    got = serve(pe, pair.port, ec_p, q, end, port_exec, port_eval, port_rrc)
    want = serve(re_, pair.ref, ec_r, q, end, ref_exec, ref_eval, ref_rrc)
    close_rows(got, want, f"{q} [{start}, {end}]")
    return got


@pytest.fixture(autouse=True)
def _fresh_caches():
    port_rrc.GLOBAL.reset()
    ref_rrc.GLOBAL.reset()
    yield


def _hits():
    return metricslib.REGISTRY.counter(
        "vm_device_window_cache_hits_total").get()


def test_refresh_uploads_only_tail_on_mesh(tmp_path, calls):
    rows, end, vals0, rng = _resg_rows(1440)
    pair = Pair(tmp_path, rows)
    try:
        pe = _port_engine(mesh=make_mesh(8, 1, ["cpu"] * 8))
        re_ = _ref_engine()
        dur = 1439 * SCRAPE // STEP * STEP - 10 * STEP
        up0 = tclib.bytes_uploaded()
        _serve_both(pair, pe, re_, RESG, end - dur, end)
        cold_upload = tclib.bytes_uploaded() - up0
        assert cold_upload > 0
        calls.take()
        hits0 = _hits()
        for _ in range(3):
            end += STEP
            pair.add(_resg_ingest(rng, vals0, end), flush=False)
            up_r = tclib.bytes_uploaded()
            served = _serve_both(pair, pe, re_, RESG, end - dur, end)
            assert len(served) == 4
            assert tclib.bytes_uploaded() - up_r < 0.05 * cold_upload
            n, cols, _ = calls.take()
            assert n == {"append_tile": 1, "sharded_rollup_aggregate": 1}
            assert cols == [2]
        assert _hits() >= hits0 + 3
        rts = _rolling_tiles(pe)
        assert rts and len(rts[0].tiles[0]) == 8
    finally:
        pair.close()


def _run_sequence(path, mesh, churn=False):
    rows, end, vals0, rng = _resg_rows(240)
    pair = Pair(path, rows)
    try:
        port_rrc.GLOBAL.reset()
        ref_rrc.GLOBAL.reset()
        pe, re_ = _port_engine(mesh=mesh), _ref_engine()
        dur = 239 * SCRAPE // STEP * STEP - 10 * STEP
        _serve_both(pair, pe, re_, RESG, end - dur, end)
        out, churn_pair = [], None
        for r in range(3):
            end += STEP
            pair.add(_resg_ingest(rng, vals0, end), flush=False)
            if churn and r == 2:
                pair.add([({"__name__": "resg", "i": "new", "g": "g0"},
                           end - 7_000, 1.0)], flush=False)
            got = _serve_both(pair, pe, re_, RESG, end - dur, end)
            out.append(got)
            if churn and r == 2:
                ec, _ = pair.ecs(start=end - dur, end=end, port_tpu=pe,
                                 disable_cache=True)
                churn_pair = (got, port_exec.exec_query(ec, RESG))
        return out, churn_pair
    finally:
        pair.close()


def test_churn_falls_back_and_matches_oracle(tmp_path, monkeypatch):
    mesh = make_mesh(8, 1, ["cpu"] * 8)
    got, (served, cold) = _run_sequence(tmp_path / "a", mesh, churn=True)
    # the rebuild after churn is the cold full-upload evaluation
    assert [k for k, _ in named(served)] == [k for k, _ in named(cold)]
    for (_, a), (_, b) in zip(named(served), named(cold)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("VM_DEVICE_RESIDENT", "0")
    want, _ = _run_sequence(tmp_path / "b", mesh, churn=True)
    for r, (g, w) in enumerate(zip(got, want)):
        close_rows(g, w, str(r))


def test_oracle_disables_resident_reuse(tmp_path, monkeypatch, calls):
    monkeypatch.setenv("VM_DEVICE_RESIDENT", "0")
    hits0 = _hits()
    _run_sequence(tmp_path, make_mesh(8, 1, ["cpu"] * 8))
    assert _hits() == hits0
    n = calls.n
    assert "append_tile" not in n and "compact_tile" not in n


def test_window_slide_compaction_keeps_rolling(tmp_path, calls):
    rows, end, vals0, rng = _resg_rows(80)
    pair = Pair(tmp_path, rows)
    try:
        pe, re_ = _port_engine(), _ref_engine()
        q = "sum by (g)(rate(resg[2m]))"
        dur = 10 * STEP
        _serve_both(pair, pe, re_, q, end - dur, end)
        comp0 = metricslib.REGISTRY.counter(
            "vm_device_window_compactions_total").get()
        hits0 = _hits()
        calls.take()
        for r in range(6):
            end += 5 * STEP
            pair.add(_resg_ingest(rng, vals0, end, k=20), flush=False)
            served = _serve_both(pair, pe, re_, q, end - dur, end)
            ec, _ = pair.ecs(start=end - dur, end=end, port_tpu=pe,
                             disable_cache=True)
            close_rows(served, port_exec.exec_query(ec, q), str(r))
        assert metricslib.REGISTRY.counter(
            "vm_device_window_compactions_total").get() > comp0
        assert _hits() >= hits0 + 6
        assert calls.n["compact_tile"] >= 1
        assert calls.n["decode_tiles"] == 6  # the cold oracles only
    finally:
        pair.close()


def test_compact_window_declines_past_int32():
    engine = _port_engine()
    ts = torch.full((2, 8), TS_PAD, dtype=torch.int32)
    ts[:, :3] = torch.arange(3, dtype=torch.int32) * 1000
    rt = ce.RollingTile(
        tiles=(ts, torch.zeros((2, 8), dtype=torch.float64),
               torch.full((2,), 3, dtype=torch.int32)),
        base_ms=1_000_000, n_cap=8, lo_ms=990_000, hi_ms=1_002_000,
        version=1, structural=0, counts_host=np.full(2, 3, np.int64),
        row_of_raw={}, n_samples=6, adopted_key=None)
    assert ce.compact_window(engine, rt, 1_000_000 + 2**31 + 5) is False
    assert rt.base_ms == 1_000_000 and rt.n_samples == 6
    assert ce.compact_window(engine, rt, 1_000_000 + 1_500) is True
    assert rt.base_ms == 1_001_500 and int(rt.counts_host.sum()) == 2


def test_persistent_churn_backs_off_to_host_suffix(tmp_path, calls):
    """Two rolling declines in a row send the shape to the host suffix
    path (device_window_ready False) until the periodic retry: no further
    full-window device rebuild, on both sides at the same refresh."""
    from victoriametrics_tpu.query import eval as ref_eval
    rows, end, vals0, rng = _resg_rows(720)
    pair = Pair(tmp_path, rows)
    try:
        pe, re_ = _port_engine(), _ref_engine()
        dur = 719 * SCRAPE // STEP * STEP - 10 * STEP
        up0 = tclib.bytes_uploaded()
        _serve_both(pair, pe, re_, RESG, end - dur, end)
        cold_upload = tclib.bytes_uploaded() - up0
        inpl = metricslib.REGISTRY.counter("vm_rollup_cache_inplace_total")
        inpl0 = inpl.get()
        ready = []
        for r in range(5):
            end += STEP
            pair.add(_resg_ingest(rng, vals0, end), flush=False)
            pair.add([({"__name__": "resg", "i": f"new{r}", "g": "g0"},
                       end - 7_000, 1.0)], flush=False)
            ec_p, ec_r = pair.ecs(start=end - dur, end=end, port_tpu=pe,
                                  ref_tpu=re_)
            ready.append((
                port_eval.device_window_ready(ec_p, parse(RESG)),
                ref_eval.device_window_ready(ec_r,
                                             ref_exec.parse_cached(RESG))))
            calls.take()
            u0 = tclib.bytes_uploaded()
            _serve_both(pair, pe, re_, RESG, end - dur, end)
            n, cols, _ = calls.take()
            if r >= 2:
                # the host ring cache's suffix evaluation (no_device_roll)
                # runs K1 + K2 on the suffix's own small tile only: the
                # columns from the volatile tail (now - OFFSET_MS) on
                assert tclib.bytes_uploaded() - u0 < 0.3 * cold_upload
                assert n == {"decode_tiles": 1, "rollup_aggregate_tile": 1}
                assert cols == [port_rrc.OFFSET_MS // STEP + 1], cols
            else:
                assert n == {"decode_tiles": 1, "rollup_aggregate_tile": 1}
                assert cols == [dur // STEP + 1], cols
        assert [p for p, _ in ready] == [r for _, r in ready]
        assert [p for p, _ in ready] == [True, True, False, False, False]
        assert inpl.get() > inpl0
    finally:
        pair.close()


# -- both grid edges advancing (tests/test_served_device_path.py) -------------

def _dv_rows(name, n_series, nn, seed):
    now = int(time.time() * 1000)
    t0 = (now - (nn - 1) * SCRAPE) // STEP * STEP
    rng = np.random.default_rng(seed)
    base = np.arange(nn, dtype=np.int64) * SCRAPE + t0
    ts2 = np.sort(base[None, :] + rng.integers(-2000, 2001, (n_series, nn)),
                  axis=1)
    vals2 = np.cumsum(rng.integers(0, 50, (n_series, nn)),
                      axis=1).astype(np.float64)
    labs = [{"__name__": name, "idx": str(i), "instance": f"h-{i % 16}"}
            for i in range(n_series)]
    rows = [(labs[i], int(ts2[i, j]), float(vals2[i, j]))
            for j in range(nn) for i in range(n_series)]
    end = t0 + -(-((nn - 1) * SCRAPE + 2000) // STEP) * STEP
    return rows, labs, vals2[:, -1].copy(), rng, end


def _dv_ingest(labs, last, rng, end):
    n = len(labs)
    v2 = last[:, None] + np.cumsum(rng.integers(0, 50, (n, 4)), axis=1)
    last[:] = v2[:, -1]
    tsf = np.sort(end - STEP + (np.arange(4, dtype=np.int64) + 1)[None, :] *
                  SCRAPE + rng.integers(-2000, 2001, (n, 4)), axis=1)
    return [(labs[i], int(tsf[i, j]), float(v2[i, j]))
            for j in range(4) for i in range(n)]


def test_direct_advancing_refresh_matches_reference(tmp_path, calls):
    """Direct full evaluations with both grid edges advancing take the
    rolling path with the ring's tail: the port serves what the reference
    serves (rtol 1e-12), reused columns equal the previously served ones
    bit for bit, and the drift against a cold evaluation stays inside the
    reference test's bound (reused columns keep the scrape-interval
    estimates they were computed under)."""
    nn = 360
    rows, labs, last, rng, end = _dv_rows("da", 256, nn, 1)
    pair = Pair(tmp_path, rows)
    try:
        d = Dash(pair)
        q = "sum by (instance)(rate(da[5m]))"
        dur = (nn - 1) * SCRAPE - 300_000
        ec_p, ec_r = pair.ecs(start=end - dur, end=end,
                              port_tpu=d.port_engine, ref_tpu=d.ref_engine)
        close_rows(port_exec.exec_query(ec_p, q),
                   ref_exec.exec_query(ec_r, q))
        prev = None
        for _ in range(3):
            end += STEP
            pair.add(_dv_ingest(labs, last, rng, end), flush=False)
            calls.take()
            ec_p, ec_r = pair.ecs(start=end - dur, end=end,
                                  port_tpu=d.port_engine,
                                  ref_tpu=d.ref_engine)
            warm = port_exec.exec_query(ec_p, q)
            n, cols, _ = calls.take()
            assert n == {"append_tile": 1, "rollup_aggregate_tile": 1}
            assert cols == [2]
            close_rows(warm, ref_exec.exec_query(ec_r, q), "vs reference")
            cold = d.host(q, end - dur, end)
            for (_, vw), (_, vc) in zip(named(warm), named(cold)):
                np.testing.assert_array_equal(np.isnan(vw), np.isnan(vc))
                m = ~np.isnan(vw)
                rel = np.abs(vw[m] - vc[m]) / np.maximum(np.abs(vc[m]),
                                                         1e-9)
                assert float(rel.max()) < 0.06
                assert (rel > 1e-4).mean() < 0.05
            if prev is not None:
                for (_, a), (_, b) in zip(named(warm), named(prev)):
                    mm = ~np.isnan(a[:-1]) & ~np.isnan(b[1:])
                    np.testing.assert_array_equal(a[:-1][mm], b[1:][mm])
            prev = warm
    finally:
        pair.close()


def test_served_refresh_matches_reference(tmp_path):
    """Through the serving layer's cached executor (the suffix evaluation
    sets no_device_roll: fresh tiles), the port serves what the reference
    serves, and the last refresh matches a cold evaluation at the
    reference test's bound."""
    nn = 360
    rows, labs, last, rng, end = _dv_rows("dv", 256, nn, 0)
    pair = Pair(tmp_path, rows)
    try:
        pe, re_ = _port_engine(), _ref_engine()
        q = "sum by (instance)(rate(dv[5m]))"
        dur = (nn - 1) * SCRAPE - 300_000
        _serve_both(pair, pe, re_, q, end - dur, end)
        for _ in range(3):
            end += STEP
            pair.add(_dv_ingest(labs, last, rng, end), flush=False)
            got = _serve_both(pair, pe, re_, q, end - dur, end)
        ec, _ = pair.ecs(start=end - dur, end=end, port_tpu=pe,
                         disable_cache=True)
        cold = port_exec.exec_query(ec, q)
        for (_, va), (_, vb) in zip(named(got), named(cold)):
            np.testing.assert_array_equal(np.isnan(va), np.isnan(vb))
            m = ~np.isnan(va)
            np.testing.assert_allclose(va[m], vb[m], rtol=1e-4)
    finally:
        pair.close()


# -- the mesh (tests/test_exec_query_mesh.py) ---------------------------------

EXACT_QUERIES = [
    "sum by (instance)(last_over_time(mq[2m]))",
    "count(last_over_time(mq[2m]))",
    "max by (job)(last_over_time(mq[2m]))",
    "min by (instance,job)(last_over_time(mq[2m]))",
    "sum by (job)(delta(mq[4m]))",
]
CLOSE_QUERIES = [
    "sum by (instance)(rate(mq[5m]))",
    "avg by (job)(increase(mq[3m]))",
    "stddev by (job)(avg_over_time(mq[5m]))",
    "quantile(0.9, rate(mq[5m])) by (instance)",
    "median(increase(mq[3m])) by (instance)",
]


@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("torch_meshq"),
             _rt_rows(97, 60, seed=11, name="mq"))
    yield p
    p.close()


def _mesh_run(pair, q, port_engine, ref_engine=None):
    ec_p, ec_r = pair.ecs(start=T0 - 300_000, end=T0, port_tpu=port_engine,
                          ref_tpu=ref_engine)
    got = port_exec.exec_query(ec_p, q)
    want = ref_exec.exec_query(ec_r, q) if ref_engine is not None else None
    return got, want


@pytest.mark.parametrize("q", EXACT_QUERIES)
def test_bit_equal_1_vs_8_devices(mesh_pair, q):
    one = _mesh_run(mesh_pair, q, _port_engine())[0]
    eight = _mesh_run(mesh_pair, q,
                      _port_engine(mesh=make_mesh(8, 1, ["cpu"] * 8)))[0]
    assert one
    assert [k for k, _ in named(one)] == [k for k, _ in named(eight)]
    for (_, a), (_, b) in zip(named(one), named(eight)):
        np.testing.assert_array_equal(b, a, err_msg=q)


@pytest.mark.parametrize("q", EXACT_QUERIES + CLOSE_QUERIES)
def test_mesh_matches_reference_mesh_and_host(mesh_pair, q, calls):
    import jax

    from victoriametrics_tpu.parallel.mesh import make_mesh as ref_mesh
    devs = jax.devices()
    assert len(devs) >= 8  # tests/conftest.py forces 8 host devices
    got, want = _mesh_run(
        mesh_pair, q, _port_engine(mesh=make_mesh(8, 1, ["cpu"] * 8)),
        TPUEngine(min_series=4, value_dtype=np.float64,
                  mesh=ref_mesh(n_series=8, n_time=1, devices=devs[:8])))
    assert got
    close_rows(got, want, q, _rtol(q))
    ec, _ = mesh_pair.ecs(start=T0 - 300_000, end=T0, disable_cache=True)
    close_rows(got, port_exec.exec_query(ec, q), q + " vs host", _rtol(q))
    assert calls.n["decode_tiles"] == 1


def test_mesh_warm_path(mesh_pair, calls):
    engine = _port_engine(mesh=make_mesh(8, 1, ["cpu"] * 8))
    q = "sum by (instance)(rate(mq[5m]))"
    cold = _mesh_run(mesh_pair, q, engine)[0]
    assert calls.take()[0] == {"decode_tiles": 1,
                               "sharded_rollup_aggregate": 1}
    warm = _mesh_run(mesh_pair, q, engine)[0]
    assert calls.take()[0] == {"sharded_rollup_aggregate": 1}
    close_rows(warm, cold, q)
    tiles = list(engine.cache()._entries.values())
    assert tiles and len(tiles[0][0]) == 8
    assert sum(int(t.shape[0]) for t in tiles[0][0]) % 8 == 0
