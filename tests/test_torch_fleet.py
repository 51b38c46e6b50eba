"""Port parity for the fleet plane (victoriametrics_tpu_torch/query/fleet.py)
as a whole, on the CPU (plain versions of B9-B11), over a real JAX-package
Storage.

  * the bucket ladder (the reference's regression test, ported);
  * adoption crops a stream's window to its fetch bound and rebases it;
  * the fleet against the port's per-stream rolling path (the
    VM_DEVICE_FLEET=0 oracle: advance_rolling + run_fused_on_tiles) over
    five intervals, one of which slides a bucket's window (B11), with one
    launch per bucket per interval; each interval the bucket's device
    planes equal its host mirrors bit for bit, and each member's rows equal
    the reference's jitted fleet_rollup_aggregate_tile run on the port's
    own mirrors;
  * swap-remove eviction and churn re-adoption;
  * the rows-share cost split sums to the launch;
  * the shapes the fleet declines;
  * the slice as a whole: the reference's PrometheusAPI + StreamClient
    sequence with TPUEngine(mesh=None) (tests/test_device_fleet.py:180-227,
    panels over fl_m on mixed grids) and the port's FleetPlane driven from
    the same Storage, held together every interval.

Values are compared at rtol 1e-12 (summation order: the reference sums a
group through a one-hot matmul or segment_sum, the port in row order);
the device planes and mirrors bit for bit."""

import re
import time

import jax.numpy as jnp
import numpy as np
import pytest

from victoriametrics_tpu.ops import device_rollup as ref_dr
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.query.eval import filters_from_metric_expr
from victoriametrics_tpu.query.metricsql import parse
from victoriametrics_tpu.storage.storage import Storage
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import fleet
from victoriametrics_tpu_torch.storage.storage import SeriesData
from victoriametrics_tpu_torch.utils.metrics import REGISTRY

STEP = 60_000
SCRAPE = 15_000
NS = 16
NN = 240
DUR = 20 * STEP
WINDOW = 300_000
PANELS = [
    ("sum by (g)(rate(fl_m[5m]))", DUR),       # rate, G 4 -> 8: bucket A
    ("max by (g)(rate(fl_m[5m]))", DUR),       # bucket A
    ("count by (g)(rate(fl_m[5m]))", DUR),     # bucket A
    ("sum by (i)(rate(fl_m[5m]))", DUR),       # G 16: bucket B
    ("avg by (g)(increase(fl_m[5m]))", 30 * STEP),    # T 31 -> 32
    ("stddev by (g)(max_over_time(fl_m[5m]))", DUR),
]
_Q = re.compile(r"(\w+) by \((\w+)\)\((\w+)\((\w+)\[5m\]\)\)")


def _seed(s: Storage, t0: int, names=("fl_m",), n: int = NN, seed: int = 7):
    rng = np.random.default_rng(seed)
    rows = []
    last = {}
    for name in names:
        for i in range(NS):
            vals = np.cumsum(rng.integers(0, 30, n)).astype(np.float64)
            last[name, i] = vals[-1]
            rows.extend((({"__name__": name, "i": str(i), "g": f"g{i % 4}"},
                          t0 + j * SCRAPE, float(vals[j])) for j in range(n)))
    s.add_rows(rows)
    s.force_flush()
    return last, rng


def _ingest(s: Storage, rng, last, end: int, k: int = 4):
    """k scrapes per series in (end - k * 15 s, end]."""
    rows = []
    for (name, i) in sorted(last):
        incr = np.cumsum(rng.integers(0, 30, k))
        rows.extend((({"__name__": name, "i": str(i), "g": f"g{i % 4}"},
                      end - k * SCRAPE + (j + 1) * SCRAPE,
                      float(last[name, i] + incr[j])) for j in range(k)))
        last[name, i] += incr[-1]
    s.add_rows(rows)


def _grid_t0(n: int = NN) -> int:
    # the data ends now, inside the storage's retention
    now = int(time.time() * 1000)
    return (now - (n - 1) * SCRAPE) // STEP * STEP


def _end0(t0: int, n: int = NN) -> int:
    return t0 + ((n - 1) * SCRAPE // STEP + 1) * STEP


class _Stream:
    """A standing query as the plane reads it (the reference's MatStream,
    duck-typed): grid, tenant, parsed shape, and due() until served."""

    def __init__(self, q, duration, shape, tenant=(0, 0)):
        self.q, self.step, self.duration = q, STEP, duration
        self.shape, self.tenant = shape, tenant
        self.end = None

    def due(self, now_ms):
        return self.end is None or now_ms // self.step * self.step > self.end


class _API:
    def __init__(self, storage, engine, streams):
        self.storage, self.engine = storage, engine
        self.matstreams = self
        self._streams = streams

    def streams(self):
        return list(self._streams)


def _shape(q, **kw):
    aggr, label, func, metric = _Q.fullmatch(q).groups()
    return fleet.StreamShape(
        selector=metric, filters=filters_from_metric_expr(parse(metric)),
        func=func, aggr=aggr, window=WINDOW, grouping=(label,), **kw)


def _register(engine, storage, st, end):
    """The stream's cold device evaluation: fetch, K2, and its rolling
    window filed under its roll-state key (register_window)."""
    sh = st.shape
    start = end - st.duration - sh.offset
    cfg = RollupConfig(start, end - sh.offset, st.step, sh.window)
    fetch_lo = start - cfg.lookback - sh.lookback_delta
    ver = storage.data_version
    found = storage.search_series(sh.filters, fetch_lo, end - sh.offset)
    keys = [tuple((g, sd.metric_name.to_dict().get(g, ""))
                  for g in sh.grouping) for sd in found]
    group_keys = list(dict.fromkeys(keys))
    gid_of = {k: g for g, k in enumerate(group_keys)}
    gids = np.array([gid_of[k] for k in keys], np.int32)
    series = [SeriesData(sd.metric_name, sd.timestamps, sd.values,
                         sd.raw_name) for sd in found]
    key = ("tile", st.q, start)
    out = ce.try_aggr_rollup(engine, sh.aggr, sh.func, series, gids,
                             len(group_keys), cfg, cache_key=key)
    assert out is not None
    skey, tkey = ce.device_roll_keys(sh.selector, st.tenant, sh.func,
                                     sh.aggr, sh.phi, sh.grouping,
                                     sh.without, sh.max_series, sh.window)
    assert ce.register_window(engine, skey, tkey, gids, group_keys,
                              tile_key=key, series=series, cfg=cfg,
                              fetch_info=(fetch_lo, end - sh.offset, ver),
                              structural=storage.structural_version)
    return skey


def _oracle(engine, storage, st, skey, end):
    """The per-stream rolling path on the stream's own window."""
    sh = st.shape
    rt, groups, _ = engine.window_cache().get(skey)
    start = end - st.duration - sh.offset
    cfg = RollupConfig(start, end - sh.offset, st.step, sh.window)
    fetch_lo = start - cfg.lookback - sh.lookback_delta
    assert ce.advance_rolling(engine, rt, storage, sh.filters, start,
                              fetch_lo, end - sh.offset, sh.max_series,
                              st.tenant, True), engine.last_roll_decline
    return ce.run_fused_on_tiles(engine, sh.aggr, sh.func, rt.tiles, groups,
                                 cfg, start - rt.base_ms, fetch_lo - start)


def _compactions():
    return REGISTRY.counter("vm_device_window_compactions_total").get()


def _mirrors_hold(plane):
    """Every bucket's device planes equal its host mirrors, bit for bit."""
    for b in plane._buckets.values():
        assert np.array_equal(b.dev["ts"].numpy(), b.ts_h)
        assert np.array_equal(b.dev["vals"].numpy().view(np.int64),
                              b.vals_h.view(np.int64))
        assert np.array_equal(b.dev["counts"].numpy(), b.counts_h)
        assert np.array_equal(b.dev["layout"].gids.numpy(), b.gids_h)
        assert np.array_equal(b.dev["aggr"].numpy(), b.aggr_h)


def _reference_rows(plane, end):
    """The reference's jitted fleet kernel on each bucket's mirrors ->
    {skey: [G, T]}."""
    out = {}
    for b in plane._buckets.values():
        shift = np.zeros(b.B_pad, np.int32)
        min_ts = np.zeros(b.B_pad, np.int32)
        for m in b.members:
            shift[m.slot] = end - m.duration - m.offset - m.base_ms
            min_ts[m.slot] = -(m.lookback + m.lookback_delta)
        cfg = RefConfig(b.cfg.start, b.cfg.end, b.cfg.step, b.cfg.window)
        got = np.asarray(ref_dr.fleet_rollup_aggregate_tile(
            b.func, cfg, b.G_b, jnp.asarray(b.ts_h), jnp.asarray(b.vals_h),
            jnp.asarray(b.counts_h), jnp.asarray(b.gids_h),
            jnp.asarray(b.aggr_h), jnp.asarray(shift), jnp.asarray(min_ts),
            jnp.asarray(b.v0_h)))
        for m in b.members:
            out[m.skey] = got[m.slot, :m.G, :m.T]
    return out


def _close(got, want, ctx=""):
    assert got.shape == want.shape, ctx
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True,
                               err_msg=ctx)


def _setup(tmp_path, names=("fl_m",), panels=PANELS):
    s = Storage(str(tmp_path / "s"))
    t0 = _grid_t0()
    last, rng = _seed(s, t0, names)
    end = _end0(t0)
    streams = [_Stream(q, d, _shape(q)) for q, d in panels]
    eng = ce.CUDAEngine(device="cpu", min_series=4)
    oracle = ce.CUDAEngine(device="cpu", min_series=4)
    skeys = [_register(eng, s, st, end) for st in streams]
    for st in streams:
        _register(oracle, s, st, end)
        st.end = end
    return s, last, rng, end, streams, eng, oracle, skeys


def test_bucket_up_ladder_makes_progress_from_floor_one():
    # regression: cumulative floored multiplies stalled forever at b=1
    # (1*3//2 == 1), hanging any 1-device mesh or VM_FLEET_LADDER_MIN=1
    assert [fleet.bucket_up(n, 1) for n in range(1, 10)] == \
        [1, 2, 3, 4, 6, 6, 8, 8, 12]
    # rungs for floors >= 2 are the documented {1, 1.5} * 2^k ladder
    assert [fleet.bucket_up(n, 2) for n in (2, 3, 5, 7, 13, 17)] == \
        [2, 3, 6, 8, 16, 24]
    assert [fleet.bucket_up(n, 8) for n in (1, 9, 17, 25)] == \
        [8, 12, 24, 32]
    for m in (1, 2, 8):
        prev = 0
        for n in range(1, 600):
            b = fleet.bucket_up(n, m)
            assert b >= n and b >= prev
            prev = b


def test_adoption_crops_and_rebases_the_window(tmp_path):
    s, last, rng, end, streams, eng, _, skeys = _setup(tmp_path,
                                                       panels=PANELS[:1])
    try:
        st, skey = streams[0], skeys[0]
        rt = eng.window_cache().peek(skey)[0]
        ts0 = rt.tiles[0].numpy().copy()
        counts0 = rt.counts_host.copy()
        base0 = rt.base_ms
        end += STEP
        _ingest(s, rng, last, end)
        api = _API(s, eng, streams)
        assert eng.fleet().run(api, end) == 1
        m = eng.fleet()._members[skey]
        assert eng.window_cache().peek(skey) is None  # moved to the fleet
        fetch_lo = end - DUR - WINDOW - 300_000  # this interval's bound
        assert m.base_ms == fetch_lo
        b = m.bucket
        # the slot holds the window's samples at or after fetch_lo, rebased
        for r in range(m.S):
            abs_ts = ts0[r, :counts0[r]].astype(np.int64) + base0
            keep = abs_ts[abs_ts >= fetch_lo] - fetch_lo
            got = b.ts_h[m.slot, r, :keep.size]
            np.testing.assert_array_equal(got, keep.astype(np.int32))
            assert b.counts_h[m.slot, r] == keep.size + 4  # + the append
            assert (b.ts_h[m.slot, r, keep.size + 4:] == fleet.TS_PAD).all()
        assert b.key == ("rate", STEP, WINDOW, 16, 192, 24, 8)
        assert b.ts_h[m.slot + 1:].min() == fleet.TS_PAD  # padded slots
    finally:
        s.close()


def test_fleet_matches_the_per_stream_path(tmp_path):
    s, last, rng, end, streams, eng, oracle, skeys = _setup(tmp_path)
    try:
        api = _API(s, eng, streams)
        plane = eng.fleet()
        c0 = _compactions()
        # four one-step intervals, then a 25-minute resume (100 scrapes)
        # that overruns the buckets' column headroom and slides them
        for k in (4, 4, 4, 4, 100):
            end += k * SCRAPE
            _ingest(s, rng, last, end, k)
            st0 = plane.stats()
            n = plane.run(api, end)
            st1 = plane.stats()
            assert n == st1["buckets"] == 4
            assert st1["members"] == len(PANELS) and st1["evictions"] == 0
            assert st1["launches"] - st0["launches"] == 4
            _mirrors_hold(plane)
            ref_rows = _reference_rows(plane, end)
            for st, skey in zip(streams, skeys):
                r = plane._results[skey]
                want = _oracle(oracle, s, st, skey, end)
                _close(r.rows, want, f"{st.q} at {end}")
                _close(r.rows, ref_rows[skey], f"{st.q} vs reference")
                assert np.isfinite(r.rows).any()
                st.end = end
        assert _compactions() - c0 >= 1
    finally:
        s.close()


def test_eviction_swap_removes_and_churn_readopts(tmp_path):
    panels = [("sum by (g)(rate(fl_m[5m]))", DUR),
              ("sum by (g)(rate(fl_n[5m]))", DUR),
              ("max by (g)(rate(fl_m[5m]))", DUR)]
    s, last, rng, end, streams, eng, oracle, skeys = _setup(
        tmp_path, names=("fl_m", "fl_n"), panels=panels)
    try:
        api = _API(s, eng, streams)
        plane = eng.fleet()
        end += STEP
        _ingest(s, rng, last, end)
        plane.run(api, end)
        b = plane._members[skeys[0]].bucket
        assert [m.skey for m in b.members] == skeys
        last_slot, last_counts = b.ts_h[2].copy(), b.counts_h[2].copy()
        for st in streams:
            st.end = end
        # a new fl_n series: its member's slice fetch finds a row it does
        # not hold and the member is evicted; the last slot moves in
        s.add_rows([({"__name__": "fl_n", "i": "99", "g": "g0"},
                     end + SCRAPE, 1.0)])
        last["fl_n", 99] = 1.0
        end += STEP
        _ingest(s, rng, last, end)
        plane.run(api, end)
        assert plane.stats()["evictions"] == 1
        assert plane.last_decline == "new series appeared"
        assert skeys[1] not in plane._members
        assert [m.skey for m in b.members] == [skeys[0], skeys[2]]
        assert plane._members[skeys[2]].slot == 1
        for r, c in enumerate(last_counts):  # then 4 appended samples
            np.testing.assert_array_equal(b.ts_h[1, r, :c], last_slot[r, :c])
        np.testing.assert_array_equal(b.counts_h[1], last_counts + 4)
        assert (b.counts_h[2] == 0).all() and (b.ts_h[2] == fleet.TS_PAD).all()
        assert fleet.resident(eng, skeys[1])  # one rebuild is wanted
        # churn: the evicted stream's own evaluation re-registers its
        # window (now 17 series), and the next interval re-adopts it
        streams[1].end = end
        _register(eng, s, streams[1], end)
        for st in streams:
            st.end = end
        end += STEP
        _ingest(s, rng, last, end)
        assert plane.run(api, end) >= 1
        assert plane.stats()["adoptions"] == 4
        # the oracle's fl_n window, too, is rebuilt over the 17 series
        _register(oracle, s, streams[1], end - STEP)
        for st, skey in zip(streams, skeys):
            want = _oracle(oracle, s, st, skey, end)
            _close(plane._results[skey].rows, want, st.q)
    finally:
        s.close()


class _EC:
    """The evaluation context take() reads, recording what it charges."""

    def __init__(self, engine, storage, start, end):
        self.engine, self.storage = engine, storage
        self.start, self.end, self.step = start, end, STEP
        self.lookback_delta = 300_000
        self.samples = 0
        self.charged = []

    def count_samples(self, n):
        self.samples += n

    def charge_device(self, exec_s, up_s, up_b):
        self.charged.append((exec_s, up_s, up_b))


class _Clock:
    """perf_counter in steps of 0.25 s: every wall the plane measures is
    exact."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def test_cost_split_sums_to_the_launch(tmp_path, monkeypatch):
    s, last, rng, end, streams, eng, _, skeys = _setup(tmp_path,
                                                       panels=PANELS[:3])
    try:
        monkeypatch.setattr(fleet, "time", _Clock())
        api = _API(s, eng, streams)
        plane = eng.fleet()
        for interval in range(2):
            end += STEP
            _ingest(s, rng, last, end)
            assert plane.run(api, end) == 1
            b = plane._members[skeys[0]].bucket
            # the launch wall is 0.25 s (two clock reads), and so is the
            # upload (first interval) or the append (second)
            up_bytes = sum(a.nbytes for a in (
                b.ts_h, b.vals_h, b.counts_h, b.gids_h, b.v0_h, b.aggr_h)) \
                if interval == 0 else b.B_pad * b.S_b * (8 * 12 + 4)
            ecs = [_EC(eng, s, end - DUR, end) for _ in streams]
            for ec, skey in zip(ecs, skeys):
                assert fleet.take(ec, skey) is not None
                assert fleet.take(ec, skey) is not None  # shares once
            shares = [c for ec in ecs for c in ec.charged]
            assert len(shares) == 6
            assert sum(x[0] for x in shares) == 0.25
            assert sum(x[1] for x in shares) == 0.25
            assert sum(x[2] for x in shares) == up_bytes
            assert all(ec.samples > 0 for ec in ecs)
            for st in streams:
                st.end = end
        # a grid the result does not cover is not served
        assert fleet.take(_EC(eng, s, end - DUR - STEP, end - STEP),
                          skeys[0]) is None
    finally:
        s.close()


@pytest.mark.parametrize("q,kw", [
    ("sum by (g)(rate(fl_m[5m]))", {"phi": 0.9}),           # quantile
    ("topk by (g)(rate(fl_m[5m]))", {}),                    # not a fleet aggr
    ("sum by (g)(timestamp(fl_m[5m]))", {}),                # time-valued
    ("sum by (g)(tlast_over_time(fl_m[5m]))", {}),
    ("sum by (g)(lifetime(fl_m[5m]))", {}),
    ("sum by (g)(rate(fl_m[5m]))", {"window": 0}),          # adjustable
    ("sum by (g)(default_rollup(fl_m[5m]))", {"window": 0}),
    ("sum by (g)(holt_winters(fl_m[5m]))", {}),             # not core
])
def test_shapes_the_fleet_declines(q, kw):
    aggr, label, func, metric = _Q.fullmatch(q).groups()
    shape = fleet.StreamShape(**{**dict(
        selector=metric, filters=None, func=func, aggr=aggr, window=WINDOW,
        grouping=(label,)), **kw})
    plane = ce.CUDAEngine(device="cpu").fleet()
    assert plane._analyze(None, _Stream(q, DUR, shape)) is None


def test_prepass_survives_a_fault_and_honours_the_switch(monkeypatch,
                                                         capsys):
    eng = ce.CUDAEngine(device="cpu")

    class _Broken:
        engine = eng
        storage = matstreams = property(lambda self: 1 / 0)

    assert fleet.prepass(_Broken(), 0) == 0
    assert "fleet prepass failed" in capsys.readouterr().err
    monkeypatch.setenv("VM_DEVICE_FLEET", "0")
    assert not fleet.enabled() and fleet.prepass(_Broken(), 0) == 0
    assert not fleet.resident(eng, ("roll-aggr",))


def test_slice_matches_the_reference_plane(tmp_path):
    """The reference's serving sequence (PrometheusAPI + StreamClient,
    TPUEngine(min_series=4, mesh=None)) and the port's FleetPlane on
    CUDAEngine(device="cpu"), from the same Storage: every stream, every
    interval, at rtol 1e-12 against what the reference serves."""
    from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
    from victoriametrics_tpu.query import rollup_result_cache as rrc
    from victoriametrics_tpu.query.matstream import StreamClient
    from victoriametrics_tpu.query.tpu_engine import TPUEngine

    rrc.GLOBAL.reset()
    panels = [("sum by (g)(rate(fl_m[5m]))", DUR),
              ("max by (i)(rate(fl_m[5m]))", 30 * STEP),
              ("count by (g)(rate(fl_m[5m]))", DUR),
              ("avg by (g)(increase(fl_m[5m]))", DUR)]
    s = Storage(str(tmp_path / "s"))
    try:
        t0 = _grid_t0()
        last, rng = _seed(s, t0)
        end = _end0(t0)
        api = PrometheusAPI(s, TPUEngine(min_series=4, mesh=None))
        subs = [api.matstreams.subscribe(q, STEP, d) for q, d in panels]
        clis = [StreamClient() for _ in panels]
        for sub, cli in zip(subs, clis):
            cli.apply(sub.next_frame(timeout_s=10.0, now_ms=end))
        # the port's streams: the reference's analysis of each (its
        # filters, lookback delta and roll-state key), on the port's side
        ref_plane = api.tpu.fleet()
        streams = []
        for st in (sub.stream for sub in subs):
            info = ref_plane._analyze(api, st)
            skey = info["skey"]
            shape = fleet.StreamShape(
                selector=str(info["me"]),
                filters=filters_from_metric_expr(info["me"], s),
                func=info["func"], aggr=info["aggr"], window=info["window"],
                offset=info["offset"], grouping=skey[6], without=skey[7],
                lookback_delta=info["lookback_delta"],
                max_series=info["max_series"])
            streams.append(_Stream(st.q, st.duration, shape, st.tenant))
        eng = ce.CUDAEngine(device="cpu", min_series=4)
        port_skeys = [_register(eng, s, st, end) for st in streams]
        for st in streams:
            st.end = end
        port_api = _API(s, eng, streams)
        for interval in range(4):
            end += STEP
            _ingest(s, rng, last, end)
            for sub, cli in zip(subs, clis):
                f = sub.next_frame(timeout_s=10.0, now_ms=end)
                assert f is not None
                cli.apply(f)
            assert eng.fleet().run(port_api, end) == 3
            for (q, d), cli, st, skey in zip(panels, clis, streams,
                                             port_skeys):
                r = eng.fleet()._results[skey]
                grid = (end - d + np.arange(r.rows.shape[1]) * STEP) / 1e3
                got = {}
                for key, row in zip(r.group_keys, r.rows):
                    live = ~np.isnan(row)
                    if live.any():
                        got[tuple(sorted(dict(key).items()))] = \
                            np.stack([grid[live], row[live]], axis=1)
                want = {tuple(sorted((k, v) for k, v in e["metric"].items()
                                     if k != "__name__")):
                        np.array([[float(t), float(v)]
                                  for t, v in e["values"]])
                        for e in cli.result()}
                assert want and set(got) == set(want), (interval, q)
                for k in want:
                    _close(got[k], want[k], f"interval {interval} {q} {k}")
                st.end = end
        assert ref_plane.stats()["launches"] > 0
        assert eng.fleet().stats()["members"] == len(panels)
    finally:
        s.close()


def test_one_expression_on_two_grids_shares_one_member(tmp_path):
    """The roll-state key names no grid (the reference's): the second grid
    of one expression is not a member of its own, and take() refuses it
    the first grid's rows."""
    q = "sum by (g)(rate(fl_m[5m]))"
    s, last, rng, end, streams, eng, _, skeys = _setup(
        tmp_path, panels=[(q, DUR), (q, 30 * STEP)])
    try:
        assert skeys[0] == skeys[1]
        end += STEP
        _ingest(s, rng, last, end)
        assert eng.fleet().run(_API(s, eng, streams), end) == 1
        assert eng.fleet().stats()["members"] == 1
        first = fleet.take(_EC(eng, s, end - DUR, end), skeys[0])
        assert first is not None and first[0].shape[1] == DUR // STEP + 1
        assert fleet.take(_EC(eng, s, end - 30 * STEP, end), skeys[1]) \
            is None
    finally:
        s.close()
