"""The slice as a whole on the CPU: the port's CUDAEngine (plain PyTorch
versions, device="cpu") over the port's Storage against the JAX package's
TPUEngine over the JAX package's Storage, both fed the same seeded rows
(anchored to the wall clock, inside the default retention) through
``add_rows``.

``sum by (instance)(rate(m[5m]))`` cold from each store agrees at rtol
1e-12; after another scrape in each store the port's ``advance_rolling``
on its resident tile (reading the port store's ``data_version``,
``min_appended_since`` and ``search_columns``) equals a cold rebuild at
1e-12, with the new scrape pending or flushed; a late row inside the
covered range and a delete make it decline, and the cold rebuild that
follows equals the reference's."""

import time

import numpy as np
import pytest

from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.query import tpu_engine as ref
from victoriametrics_tpu.storage import storage as ref_storage
from victoriametrics_tpu.storage import tag_filters as ref_tf
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.storage import storage as port_storage
from victoriametrics_tpu_torch.storage import tag_filters as port_tf

HOUR = 3_600_000
STEP, WINDOW, LOOKBACK_DELTA, SCRAPE = 60_000, 300_000, 300_000, 15_000
S, INSTANCES = 64, 8
# a fixed hour two days back: every sample lies in the past and inside
# the default retention
T0 = (int(time.time() * 1000) - 48 * HOUR) // HOUR * HOUR
START, END = T0 + 20 * 60_000, T0 + 40 * 60_000


class Pair:
    """The same rows in a reference and a port Storage."""

    def __init__(self, tmp_path):
        self.ref = ref_storage.Storage(str(tmp_path / "ref"))
        try:
            self.port = port_storage.Storage(str(tmp_path / "port"))
        except BaseException:
            self.ref.close()
            raise
        self.filters = {"ref": [ref_tf.TagFilter(b"", b"rt")],
                        "port": [port_tf.TagFilter(b"", b"rt")]}
        self.rng = np.random.default_rng(17)
        self.last = np.zeros(S)
        self.add(T0, 160)  # 40 minutes of history

    def close(self):
        self.ref.close()
        self.port.close()

    def rows(self, t_lo, n):
        """n more scrapes per series from t_lo, jittered, continuing each
        counter (a third reset once); several scrapes per call."""
        ts = t_lo + np.arange(n)[None, :] * SCRAPE + \
            self.rng.integers(0, 2001, (S, n))
        inc = self.rng.integers(0, 30, (S, n))
        vals = self.last[:, None] + np.cumsum(inc, axis=1)
        if n > 40:
            vals[::3, n // 2:] -= vals[::3, n // 2:n // 2 + 1]
        self.last = vals[:, -1].copy()
        out = []
        for j in range(n):
            for i in range(S):
                out.append(({"__name__": "rt", "instance": f"h{i % INSTANCES}",
                             "job": f"j{i % 3}", "i": str(i)},
                            int(ts[i, j]), float(vals[i, j])))
        return out

    def add(self, t_lo, n, flush=True):
        rows = self.rows(t_lo, n)
        for st in (self.ref, self.port):
            for a in range(0, len(rows), S * 20):
                st.add_rows(rows[a:a + S * 20])
            if flush:
                st.force_flush()

    def fetch(self, impl, start, end):
        st = getattr(self, impl)
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        ver = st.data_version
        series = st.search_series(self.filters[impl], fetch_lo, end)
        keys = [sd.metric_name.get_label(b"instance") for sd in series]
        order = {k: g for g, k in enumerate(dict.fromkeys(keys))}
        gids = np.array([order[k] for k in keys], np.int32)
        return series, gids, len(order), (fetch_lo, end, ver)


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    try:
        yield p
    finally:
        p.close()


def close12(got, want):
    assert got is not None and got.shape == want.shape
    assert np.isfinite(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               equal_nan=True)


def cold_pair(pair, start, end):
    """The reference's and the port's cold answers, each from its store."""
    rs, rg, rG, _ = pair.fetch("ref", start, end)
    ps, pg, pG, _ = pair.fetch("port", start, end)
    assert [sd.raw_name for sd in rs] == [sd.raw_name for sd in ps]
    np.testing.assert_array_equal(rg, pg)
    want = ref.try_aggr_rollup_tpu(
        ref.TPUEngine(value_dtype=np.float64, min_series=4), "sum", "rate",
        rs, rg, rG, RefConfig(start, end, STEP, WINDOW))
    got = ce.try_aggr_rollup(ce.CUDAEngine(device="cpu", min_series=4),
                             "sum", "rate", ps, pg, pG,
                             RollupConfig(start, end, STEP, WINDOW))
    return got, want


def test_cold_query_through_the_stores_matches_the_reference(pair):
    got, want = cold_pair(pair, START, END)
    assert got.shape == (INSTANCES, (END - START) // STEP + 1)
    close12(got, want)


def _resident(pair, eng):
    """A cold query on the port's store, its tile filed as the rolling
    window."""
    series, gids, G, finfo = pair.fetch("port", START, END)
    cfg = RollupConfig(START, END, STEP, WINDOW)
    key = ("storage-slice", START)
    assert ce.try_aggr_rollup(eng, "sum", "rate", series, gids, G, cfg,
                              cache_key=key) is not None
    rt = ce.register_window(
        eng, ("state",), ("tile",), gids, [(g,) for g in range(G)],
        tile_key=key, series=series, cfg=cfg, fetch_info=finfo,
        structural=pair.port.structural_version)
    assert rt is not None
    return rt


def _advance(pair, eng, rt, start, end):
    fetch_lo = start - WINDOW - LOOKBACK_DELTA
    ok = ce.advance_rolling(eng, rt, pair.port, pair.filters["port"], start,
                            fetch_lo, end, None, (0, 0), True)
    if not ok:
        return None
    _, groups, _, _, _ = eng.window_cache().get(("state",))
    return ce.run_fused_on_tiles(eng, "sum", "rate", rt.tiles, groups,
                                 RollupConfig(start, end, STEP, WINDOW),
                                 start - rt.base_ms, fetch_lo - start)


@pytest.mark.parametrize("flush", [False, True])
def test_rolling_refresh_equals_cold_rebuild(pair, flush):
    eng = ce.CUDAEngine(device="cpu", min_series=4)
    rt = _resident(pair, eng)
    start, end = START, END
    for r in range(2):
        v0 = pair.port.data_version
        pair.add(end + 1, 4, flush=flush)  # one more minute, all newer
        assert pair.port.data_version == v0 + 1
        start, end = start + STEP, end + STEP
        served = _advance(pair, eng, rt, start, end)
        assert served is not None, eng.last_roll_decline
        assert rt.appends == r + 1
        got, want = cold_pair(pair, start, end)
        close12(got, want)
        close12(served, got)
        close12(served, want)


@pytest.mark.parametrize("change", ["late_row", "delete"])
def test_rolling_refresh_declines_then_rebuilds(pair, change):
    eng = ce.CUDAEngine(device="cpu", min_series=4)
    rt = _resident(pair, eng)
    if change == "late_row":
        late = [({"__name__": "rt", "instance": "h0", "job": "j0",
                  "i": "0"}, START + 7_000, 5.0)]
        pair.ref.add_rows(late)
        pair.port.add_rows(late)
        reason = "late data landed inside the covered range"
    else:
        for impl in ("ref", "port"):
            mod = ref_tf if impl == "ref" else port_tf
            n = getattr(pair, impl).delete_series(
                [mod.TagFilter(b"", b"rt"), mod.TagFilter(b"i", b"5")])
            assert n == 1
        reason = "deletes/retention changed visible data"
    pair.add(END + 1, 4)
    start, end = START + STEP, END + STEP
    assert _advance(pair, eng, rt, start, end) is None
    assert eng.last_roll_decline == reason
    got, want = cold_pair(pair, start, end)
    close12(got, want)
