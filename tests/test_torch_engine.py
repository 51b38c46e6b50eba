"""Port parity for the device query engine as a whole: the port's
CUDAEngine (plain PyTorch versions, device="cpu") against the JAX
TPUEngine (float64 tiles), cold and rolling, on the same series.

The rolling test drives both engines' advance_rolling against one real
Storage (duck-typed, as the evaluator does), ingests between refreshes,
slides the window once with compact_window, and holds every served
result against the JAX engine and against a cold rebuild of the same
window (the served == cold contract), all at rtol=1e-12."""

import numpy as np
import pytest

from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.query import tpu_engine as ref
from victoriametrics_tpu_torch.models import tile_cache
from victoriametrics_tpu_torch.ops.device_rollup import group_layout
from victoriametrics_tpu_torch.ops.rollup_np import CORE_SUPPORTED, RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.storage.storage import SeriesData

T0 = 1_753_700_000_000
STEP = 60_000
WINDOW = 300_000
LOOKBACK_DELTA = 300_000
N_SERIES = 80
N_INSTANCES = 8


def _rcfg(cfg):
    return RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)


def _close(got, want, aggr="sum"):
    if aggr == "stddev":  # held through its square, see the rollup tests
        got, want = got * got, want * want
    tol = dict(rtol=1e-9, atol=1e-9) if aggr in ("stddev", "stdvar") else \
        dict(rtol=1e-12, atol=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, equal_nan=True, **tol)


def _synth_series(seed=5, n_series=N_SERIES, n=90):
    """Jittered 15 s counters, a third with resets, grouped by instance."""
    from victoriametrics_tpu.storage.storage import SeriesData as RefSD
    rng = np.random.default_rng(seed)
    ref_series, series = [], []
    for i in range(n_series):
        k = int(rng.integers(n // 2, n))
        ts = np.sort(T0 - 1_200_000 + np.arange(k, dtype=np.int64) * 15_000 +
                     rng.integers(-2000, 2001, k))
        v = np.cumsum(rng.integers(0, 50, k)).astype(np.float64)
        if i % 3 == 0:
            v[k // 2:] -= v[k // 2]
        raw = b"rt{instance=\"h%d\",i=\"%d\"}" % (i % N_INSTANCES, i)
        ref_series.append(RefSD(None, ts, v, raw_name=raw))
        series.append(SeriesData(None, ts, v, raw_name=raw))
    gids = (np.arange(n_series) % N_INSTANCES).astype(np.int32)
    return ref_series, series, gids


@pytest.mark.parametrize("aggr", ["sum", "avg", "max", "stddev"])
@pytest.mark.parametrize("func", ["rate", "increase", "irate"])
def test_cold_query_matches_jax_engine(func, aggr):
    ref_series, series, gids = _synth_series()
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng = ref.TPUEngine(value_dtype=np.float64, min_series=4)
    peng = ce.CUDAEngine(device="cpu", min_series=4)
    want = ref.try_aggr_rollup_tpu(jeng, aggr, func, ref_series, gids,
                                   N_INSTANCES, _rcfg(cfg))
    up0 = tile_cache.bytes_uploaded()
    got = ce.try_aggr_rollup(peng, aggr, func, series, gids, N_INSTANCES,
                             cfg)
    assert got is not None and np.isfinite(got).any()
    _close(got, want, aggr)
    # the cold upload shipped compact planes, not a dense 12 B/sample tile
    n_samples = sum(sd.timestamps.size for sd in series)
    assert 0 < tile_cache.bytes_uploaded() - up0 < 12 * n_samples
    # warm: the resident tile answers again without another upload
    up1 = tile_cache.bytes_uploaded()
    again = ce.try_aggr_rollup(peng, aggr, func, series, gids, N_INSTANCES,
                               cfg)
    assert tile_cache.bytes_uploaded() == up1
    np.testing.assert_array_equal(again, got)


def test_unsupported_shapes_return_none():
    _, series, gids = _synth_series(n_series=8)
    peng = ce.CUDAEngine(device="cpu", min_series=4)
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    # every CORE_SUPPORTED func is fused now; one outside the set is not
    assert ce.try_aggr_rollup(peng, "sum", "quantile_over_time", series,
                              gids, N_INSTANCES, cfg) is None
    assert ce.try_aggr_rollup(peng, "quantile", "rate", series, gids,
                              N_INSTANCES, cfg) is None
    assert ce.try_aggr_rollup(ce.CUDAEngine(device="cpu"), "sum", "rate",
                              series, gids, N_INSTANCES, cfg) is None


class _Store:
    """A real JAX-package Storage holding N_SERIES jittered counters, and
    the ingest that continues every counter strictly later in time."""

    def __init__(self, tmp_path):
        from victoriametrics_tpu.query.eval import filters_from_metric_expr
        from victoriametrics_tpu.query.metricsql import parse
        from victoriametrics_tpu.storage.storage import Storage
        self.s = Storage(str(tmp_path / "s"))
        self.filters = filters_from_metric_expr(parse("rt"))
        self.rng = np.random.default_rng(21)
        self.last = np.zeros(N_SERIES)
        self._add(T0 - 1_200_000, 80)

    def _add(self, t_lo, n):
        rows = []
        for i in range(N_SERIES):
            ts = t_lo + np.arange(n, dtype=np.int64) * 15_000 + \
                self.rng.integers(0, 2000, n)
            vals = self.last[i] + np.cumsum(self.rng.integers(0, 30, n))
            self.last[i] = vals[-1]
            lab = {"__name__": "rt", "instance": f"h{i % N_INSTANCES}",
                   "job": f"j{i % 3}", "i": str(i)}
            rows.extend(zip([lab] * n, ts.tolist(), vals.astype(float)))
        self.s.add_rows(rows)
        self.s.force_flush()

    def ingest_newer(self, t_lo, n=4):
        self._add(t_lo, n)

    def fetch(self, start, end):
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        ver = self.s.data_version
        series = self.s.search_series(self.filters, fetch_lo, end)
        keys = [sd.metric_name.to_dict()["instance"] for sd in series]
        order = {k: g for g, k in enumerate(dict.fromkeys(keys))}
        gids = np.array([order[k] for k in keys], np.int32)
        return series, gids, len(order), (fetch_lo, end, ver)


def _port_series(series):
    return [SeriesData(sd.metric_name, sd.timestamps, sd.values, sd.raw_name)
            for sd in series]


def _rolling_tile(cls, tiles, series, cfg, fetch_info, structural, key):
    return cls(tiles=tiles, base_ms=cfg.start, n_cap=int(tiles[0].shape[1]),
               lo_ms=fetch_info[0], hi_ms=fetch_info[1],
               version=fetch_info[2], structural=structural,
               counts_host=np.array([sd.timestamps.size for sd in series],
                                    np.int64),
               row_of_raw={sd.raw_name: i for i, sd in enumerate(series)},
               n_samples=sum(sd.timestamps.size for sd in series),
               adopted_key=key)


def test_rolling_refresh_matches_jax_engine_and_cold(tmp_path):
    import jax.numpy as jnp

    st = _Store(tmp_path)
    try:
        jeng = ref.TPUEngine(value_dtype=np.float64, min_series=4)
        peng = ce.CUDAEngine(device="cpu", min_series=4)
        start, end = T0 - 600_000, T0
        series, gids, G, finfo = st.fetch(start, end)
        cfg = RollupConfig(start, end, STEP, WINDOW)
        key = ("tile-under-test", start)
        want = ref.try_aggr_rollup_tpu(jeng, "sum", "rate", series, gids, G,
                                       _rcfg(cfg), cache_key=key)
        got = ce.try_aggr_rollup(peng, "sum", "rate", _port_series(series),
                                 gids, G, cfg, cache_key=key)
        _close(got, want)
        structural = st.s.structural_version
        jrt = _rolling_tile(ref.RollingTile, jeng.cache().get(key), series,
                            cfg, finfo, structural, key)
        prt = _rolling_tile(ce.RollingTile, peng.cache().get(key), series,
                            cfg, finfo, structural, key)
        jgids = jnp.asarray(gids)
        groups = group_layout(gids, G, "cpu")
        adv = 4 * STEP  # per refresh; the third slides past the tile base
        for r in range(3):
            st.ingest_newer(end + 5_000, n=adv // 15_000)
            start, end = start + adv, end + adv
            fetch_lo = start - WINDOW - LOOKBACK_DELTA
            if r == 2:
                # slide the window on device in both engines
                assert ref.compact_window(jeng, jrt, fetch_lo)
                assert ce.compact_window(peng, prt, fetch_lo)
                for a, b in zip(prt.tiles, jrt.tiles[:3]):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                assert prt.base_ms == jrt.base_ms == fetch_lo
            up0 = tile_cache.bytes_uploaded()
            assert ref.advance_rolling(jeng, jrt, st.s, st.filters, start,
                                       fetch_lo, end, None, (0, 0), True)
            assert ce.advance_rolling(peng, prt, st.s, st.filters, start,
                                      fetch_lo, end, None, (0, 0), True)
            steady_up = tile_cache.bytes_uploaded() - up0
            assert prt.appends == jrt.appends == r + 1
            np.testing.assert_array_equal(prt.counts_host, jrt.counts_host)
            cfg = RollupConfig(start, end, STEP, WINDOW)
            sh, mt = start - prt.base_ms, fetch_lo - start
            want = ref.run_fused_on_tiles(jeng, "sum", "rate", jrt.tiles,
                                          jgids, G, _rcfg(cfg), sh, mt)
            got = ce.run_fused_on_tiles(peng, "sum", "rate", prt.tiles,
                                        groups, cfg, sh, mt)
            _close(got, want)
            # served == cold: a fresh engine over a fresh fetch
            series2, gids2, G2, _ = st.fetch(start, end)
            np.testing.assert_array_equal(gids2, gids)
            cold = ce.try_aggr_rollup(ce.CUDAEngine(device="cpu",
                                                    min_series=4),
                                      "sum", "rate", _port_series(series2),
                                      gids2, G2, cfg)
            _close(got, cold)
            # a refresh uploads only the appended columns: K_pad new
            # (int32 ts, float64 value) pairs and one int32 count per row
            k_pad = (adv // 15_000 + 7) // 8 * 8
            assert steady_up == N_SERIES * (k_pad * 12 + 4)
    finally:
        st.s.close()


def test_warmup_runs_the_fused_queries():
    # the reference's defaults: rate, increase and default_rollup, each
    # per series (try_rollup) and fused with sum (try_aggr_rollup)
    assert ce.warmup(ce.CUDAEngine(device="cpu")) == 6


def test_aux_cache_is_a_bounded_lru():
    peng = ce.CUDAEngine(device="cpu")
    for i in range(5):
        ce.aux_put(peng, i, str(i), cap=3)
    assert ce.aux_get(peng, 0) is None and ce.aux_get(peng, 1) is None
    assert ce.aux_get(peng, 2) == "2"   # touched: now most recent
    ce.aux_put(peng, 5, "5", cap=3)
    assert ce.aux_get(peng, 3) is None and ce.aux_get(peng, 2) == "2"


def test_cuda_engine_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ce.CUDAEngine()


def test_tile_cache_is_a_byte_bounded_lru():
    import torch
    tile = (torch.zeros(10, dtype=torch.float64),)  # 80 bytes
    cache = tile_cache.TileCache(capacity_bytes=200)
    cache.put_device("a", tile)
    cache.put_device("b", tile)
    assert cache.get("a") is tile          # touch: "b" is now the oldest
    cache.put_device("c", tile)
    assert cache.get("b") is None and cache.get("a") is tile
    assert cache.size_bytes == 160 and cache.entry_count() == 2
    big = (torch.zeros(100, dtype=torch.float64),)
    assert cache.put_device("a", big) is big  # too big: served, not kept
    assert cache.get("a") is None and cache.size_bytes == 80


def test_window_cache_evicts_the_least_recent():
    from victoriametrics_tpu_torch.utils.metrics import REGISTRY
    ev = REGISTRY.counter("vm_device_window_cache_evictions_total")
    before = ev.get()
    wc = tile_cache.DeviceWindowCache(cap=2)
    wc.put("a", 1)
    wc.put("b", 2)
    assert wc.get("a") == 1
    wc.put("c", 3)
    assert wc.get("b") is None and wc.get("a") == 1 and wc.get("c") == 3
    assert ev.get() == before + 1


# ---------------------------------------------------------------------------
# Per-series, topk and quantile entry points (slice 2).
# ---------------------------------------------------------------------------

EXACT_FUNCS = {"count_over_time", "present_over_time", "first_over_time",
               "last_over_time", "default_rollup", "tfirst_over_time",
               "tlast_over_time", "timestamp", "min_over_time",
               "max_over_time", "changes"}


def _engines():
    return (ref.TPUEngine(value_dtype=np.float64, min_series=4),
            ce.CUDAEngine(device="cpu", min_series=4))


@pytest.fixture(scope="module")
def synth():
    return _synth_series()


@pytest.mark.parametrize("func", sorted(CORE_SUPPORTED))
def test_try_rollup_matches_jax_engine(synth, func):
    ref_series, series, _ = synth
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng = _engines()
    want = np.array(ref.try_rollup_tpu(jeng, func, ref_series, _rcfg(cfg),
                                       ()))
    got = np.array(ce.try_rollup(peng, func, series, cfg, ()))
    assert got.shape == want.shape == (N_SERIES, 11)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if func in EXACT_FUNCS:
        np.testing.assert_array_equal(got, want)
    elif func == "stddev_over_time":  # through its square, as elsewhere
        np.testing.assert_allclose(got * got, want * want, rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    else:
        tol = 1e-9 if func in ("deriv", "stdvar_over_time") else 1e-12
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol if tol > 1e-12 else 0,
                                   equal_nan=True)


# the reference's tests/test_device_rollup.py topk queries as (name, k,
# func, window)
TOPK_QUERIES = [
    ("topk", 3, "rate", 300_000), ("bottomk", 3, "rate", 300_000),
    ("topk", 5, "default_rollup", 300_000),
    ("bottomk", 120, "rate", 300_000),  # k > S: keep everything
    ("topk_max", 4, "rate", 300_000), ("topk_min", 4, "increase", 180_000),
    ("topk_avg", 6, "rate", 300_000), ("topk_median", 4, "rate", 300_000),
    ("topk_last", 4, "last_over_time", 120_000),
    ("bottomk_max", 4, "rate", 300_000), ("bottomk_avg", 3, "rate", 300_000),
    ("topk", 0, "rate", 300_000),
]


@pytest.mark.parametrize("name,k,func,window", TOPK_QUERIES)
def test_try_topk_rollup_matches_jax_engine(synth, name, k, func, window):
    ref_series, series, _ = synth
    cfg = RollupConfig(T0 - 600_000, T0, STEP, window)
    jeng, peng = _engines()
    want = ref.try_topk_rollup_tpu(jeng, name, k, func, ref_series,
                                   _rcfg(cfg))
    got = ce.try_topk_rollup(peng, name, k, func, series, cfg)
    assert got is not None and want is not None
    assert [i for i, _ in got] == [i for i, _ in want]
    assert (len(got) == 0) == (k == 0)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True)


# (phi, func, window, grouping): the reference's quantile panels
QUANTILE_QUERIES = [
    (0.9, "rate", 300_000, "instance"), (0.25, "last_over_time", 120_000,
                                         "job"),
    (1.5, "rate", 300_000, "job"), (0.5, "increase", 180_000, "instance"),
    (0.5, "rate", 300_000, "none"), (-0.5, "rate", 300_000, "instance"),
]


def _grouping(kind):
    i = np.arange(N_SERIES)
    if kind == "instance":
        return (i % N_INSTANCES).astype(np.int32), N_INSTANCES
    if kind == "job":
        return (i % 3).astype(np.int32), 3
    return np.zeros(N_SERIES, np.int32), 1


@pytest.mark.parametrize("phi,func,window,grouping", QUANTILE_QUERIES)
def test_try_quantile_rollup_matches_jax_engine(synth, phi, func, window,
                                                grouping):
    ref_series, series, _ = synth
    gids, G = _grouping(grouping)
    cfg = RollupConfig(T0 - 600_000, T0, STEP, window)
    jeng, peng = _engines()
    slots, max_group = ce.group_slots(gids, G)
    want = ref.try_quantile_rollup_tpu(jeng, phi, func, ref_series, gids, G,
                                       _rcfg(cfg), slots, max_group)
    got = ce.try_quantile_rollup(peng, phi, func, series, gids, G, cfg,
                                 max_group)
    assert got is not None and got.shape == want.shape == (G, 11)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


# the three fused queries of the reference's test_fused_matches_host that
# the port's K2 declined before it ran every CORE_SUPPORTED func
@pytest.mark.parametrize("aggr,func,window,grouping", [
    ("avg", "avg_over_time", 300_000, "job"),
    ("count", "last_over_time", 120_000, "none"),
    ("max", "delta", 240_000, "instance")])
def test_try_aggr_rollup_runs_every_core_func(synth, aggr, func, window,
                                              grouping):
    ref_series, series, _ = synth
    gids, G = _grouping(grouping)
    cfg = RollupConfig(T0 - 600_000, T0, STEP, window)
    jeng, peng = _engines()
    want = ref.try_aggr_rollup_tpu(jeng, aggr, func, ref_series, gids, G,
                                   _rcfg(cfg))
    got = ce.try_aggr_rollup(peng, aggr, func, series, gids, G, cfg)
    assert got is not None and np.isfinite(got).any()
    _close(got, want, aggr)


def _decline_case(case, ref_series, series):
    """(reference result, port result) for one query both must decline."""
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng = _engines()
    gids, G = _grouping("instance")
    slots, max_group = ce.group_slots(gids, G)
    if case == "func_outside_core":
        return (ref.try_rollup_tpu(jeng, "quantile_over_time", ref_series,
                                   _rcfg(cfg), ()),
                ce.try_rollup(peng, "quantile_over_time", series, cfg, ()))
    if case == "args":
        return (ref.try_rollup_tpu(jeng, "rate", ref_series, _rcfg(cfg),
                                   (1,)),
                ce.try_rollup(peng, "rate", series, cfg, (1,)))
    if case == "below_min_series":
        jeng.min_series = peng.min_series = N_SERIES + 1
        return (ref.try_topk_rollup_tpu(jeng, "topk", 3, "rate", ref_series,
                                        _rcfg(cfg)),
                ce.try_topk_rollup(peng, "topk", 3, "rate", series, cfg))
    if case == "unknown_rank_kind":
        return (ref.try_topk_rollup_tpu(jeng, "topk_sum", 3, "rate",
                                        ref_series, _rcfg(cfg)),
                ce.try_topk_rollup(peng, "topk_sum", 3, "rate", series, cfg))
    if case == "quantile_over_budget":
        # a dense [G, M, T] of 2^26 float64 elements, over the 512 MiB cap
        big = RollupConfig(T0 - 600_000, T0 - 600_000 + 15 * (1 << 20),
                           15, WINDOW)
        return (ref.try_quantile_rollup_tpu(
                    jeng, 0.5, "rate", ref_series, gids, G, _rcfg(big),
                    slots, 1 << 3),
                ce.try_quantile_rollup(peng, 0.5, "rate", series, gids, G,
                                       big, 1 << 3))
    if case == "span_over_int32":
        wide = RollupConfig(T0 - 2**31, T0, STEP, WINDOW)
        return (ref.try_rollup_tpu(jeng, "rate", ref_series, _rcfg(wide),
                                   ()),
                ce.try_rollup(peng, "rate", series, wide, ()))
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "func_outside_core", "args", "below_min_series", "unknown_rank_kind",
    "quantile_over_budget", "span_over_int32"])
def test_declines_where_the_jax_engine_declines(synth, case):
    ref_series, series, _ = synth
    want, got = _decline_case(case, ref_series, series)
    assert want is None and got is None


@pytest.mark.parametrize("func", ["timestamp", "tfirst_over_time"])
def test_time_valued_funcs_refuse_a_rolling_shift(synth, func):
    _, series, _ = synth
    peng = ce.CUDAEngine(device="cpu", min_series=4)
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    tiles = ce._upload_tiles(peng, series, cfg)
    groups = group_layout(*_grouping("instance"), "cpu")
    with pytest.raises(ValueError):
        ce.run_quantile_on_tiles(peng, 0.5, func, tiles, groups, cfg, 60_000)
    with pytest.raises(ValueError):
        ce.run_fused_on_tiles(peng, "sum", func, tiles, groups, cfg, 60_000)


def test_rolling_quantile_matches_jax_engine_and_cold(tmp_path):
    import jax.numpy as jnp

    st = _Store(tmp_path)
    try:
        jeng, peng = _engines()
        start, end = T0 - 600_000, T0
        series, gids, G, finfo = st.fetch(start, end)
        slots, max_group = ce.group_slots(gids, G)
        cfg = RollupConfig(start, end, STEP, WINDOW)
        key = ("quantile-tile", start)
        want = ref.try_quantile_rollup_tpu(jeng, 0.9, "rate", series, gids,
                                           G, _rcfg(cfg), slots, max_group,
                                           cache_key=key)
        got = ce.try_quantile_rollup(peng, 0.9, "rate", _port_series(series),
                                     gids, G, cfg, max_group, cache_key=key)
        _close(got, want)
        structural = st.s.structural_version
        jrt = _rolling_tile(ref.RollingTile, jeng.cache().get(key), series,
                            cfg, finfo, structural, key)
        prt = _rolling_tile(ce.RollingTile, peng.cache().get(key), series,
                            cfg, finfo, structural, key)
        groups = group_layout(gids, G, "cpu")
        adv = 4 * STEP
        for r in range(3):
            st.ingest_newer(end + 5_000, n=adv // 15_000)
            start, end = start + adv, end + adv
            fetch_lo = start - WINDOW - LOOKBACK_DELTA
            if r == 2:
                assert ref.compact_window(jeng, jrt, fetch_lo)
                assert ce.compact_window(peng, prt, fetch_lo)
            assert ref.advance_rolling(jeng, jrt, st.s, st.filters, start,
                                       fetch_lo, end, None, (0, 0), True)
            assert ce.advance_rolling(peng, prt, st.s, st.filters, start,
                                      fetch_lo, end, None, (0, 0), True)
            cfg = RollupConfig(start, end, STEP, WINDOW)
            sh, mt = start - prt.base_ms, fetch_lo - start
            want = ref.run_quantile_on_tiles(
                jeng, 0.9, "rate", jrt.tiles, jnp.asarray(gids),
                jnp.asarray(slots), G, max_group, _rcfg(cfg), sh, mt)
            got = ce.run_quantile_on_tiles(peng, 0.9, "rate", prt.tiles,
                                           groups, cfg, sh, mt)
            _close(got, want)
            series2, gids2, G2, _ = st.fetch(start, end)
            np.testing.assert_array_equal(gids2, gids)
            cold = ce.try_quantile_rollup(
                ce.CUDAEngine(device="cpu", min_series=4), 0.9, "rate",
                _port_series(series2), gids2, G2, cfg, max_group)
            _close(got, cold)  # served == cold
    finally:
        st.s.close()


def test_warmup_runs_per_series_and_fused(monkeypatch):
    calls = []
    for name in ("try_rollup", "try_aggr_rollup"):
        real = getattr(ce, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[1] if _name == "try_rollup" else a[2]))
            return _real(*a, **kw)
        monkeypatch.setattr(ce, name, counted)
    assert ce.warmup(ce.CUDAEngine(device="cpu")) == 6
    assert sorted(calls) == sorted(
        [(n, f) for f in ("rate", "increase", "default_rollup")
         for n in ("try_rollup", "try_aggr_rollup")])
