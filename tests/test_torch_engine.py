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
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
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
    assert ce.try_aggr_rollup(peng, "sum", "deriv", series, gids,
                              N_INSTANCES, cfg) is None
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
    assert ce.warmup(ce.CUDAEngine(device="cpu")) == 2


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
