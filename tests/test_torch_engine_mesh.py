"""Port parity for the engine and the fleet on a mesh, as a whole: the
port's CUDAEngine(device="cpu", mesh=make_mesh(8, 1, ["cpu"] * 8)) (plain
PyTorch versions, series-sharded over 8 logical shards) against the JAX
TPUEngine(mesh=make_mesh(n_series=8)) on the 8 forced host devices of
tests/conftest.py, and against the port's own unsharded engine.

  * a cold fused query over 75 series (not a multiple of 8: the tiles pad
    to 80 rows), the per-series, topk and quantile panels;
  * a rolling refresh with a compaction (K3 and K4 per shard, B13), held
    against the JAX mesh engine and against a cold rebuild;
  * the fleet sequence of tests/test_device_fleet.py:180-221 (its mixed
    grids) through the port's plane on a mesh (stream-sharded buckets,
    B14) against the reference's serving on its 8-device mesh;
  * QueryPipeline.sharded, and auto_mesh's one-card rule.

Tolerances as tests/test_torch_engine.py: rtol 1e-12, the variance at
1e-9 (stddev through its square); against the port's unsharded engine,
count, group, min and max and the per-series rows are equal."""

import numpy as np
import pytest
import torch

from test_torch_engine import (N_INSTANCES, STEP, T0, WINDOW, LOOKBACK_DELTA,
                               _close, _port_series, _rcfg, _Store,
                               _synth_series)
from victoriametrics_tpu.parallel import mesh as ref_mesh
from victoriametrics_tpu.query import tpu_engine as ref
from victoriametrics_tpu_torch.models import tile_cache
from victoriametrics_tpu_torch.models.rollup_pipeline import (QueryPipeline,
                                                              synth_workload)
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.parallel import mesh as ml
from victoriametrics_tpu_torch.parallel.partition import host_rows
from victoriametrics_tpu_torch.query import cuda_engine as ce

CPU8 = ["cpu"] * 8
S_ODD = 75


def _mesh_engines():
    return (ref.TPUEngine(value_dtype=np.float64, min_series=4,
                          mesh=ref_mesh.make_mesh(n_series=8)),
            ce.CUDAEngine(device="cpu", min_series=4,
                          mesh=ml.make_mesh(8, 1, CPU8)),
            ce.CUDAEngine(device="cpu", min_series=4))


@pytest.fixture(scope="module")
def odd():
    return _synth_series(n_series=S_ODD)


@pytest.mark.parametrize("aggr", ["sum", "count", "min", "max", "avg",
                                  "stddev"])
def test_cold_fused_query_on_a_mesh(odd, aggr):
    ref_series, series, gids = odd
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng, flat = _mesh_engines()
    want = ref.try_aggr_rollup_tpu(jeng, aggr, "rate", ref_series, gids,
                                   N_INSTANCES, _rcfg(cfg))
    got = ce.try_aggr_rollup(peng, aggr, "rate", series, gids, N_INSTANCES,
                             cfg, cache_key=("mesh", aggr))
    assert got is not None and np.isfinite(got).any()
    _close(got, want, aggr)
    # the tile: 8 row shards of 10 (75 rows padded to 80), padded rows
    # empty
    ts, v, counts = peng.cache().get(("mesh", aggr))
    assert isinstance(ts, list) and len(ts) == 8
    assert [int(t.shape[0]) for t in ts] == [10] * 8
    assert host_rows(counts)[S_ODD:].tolist() == [0] * 5
    # the cache bounds the entry by the bytes of all its shards
    assert peng.cache().size_bytes == sum(
        t.numel() * t.element_size() for part in (ts, v, counts)
        for t in part) > 0
    unsharded = ce.try_aggr_rollup(flat, aggr, "rate", series, gids,
                                   N_INSTANCES, cfg)
    if aggr in ("count", "min", "max"):
        np.testing.assert_array_equal(got, unsharded)
    else:
        _close(got, unsharded, aggr)


@pytest.mark.parametrize("func", ["rate", "max_over_time", "timestamp",
                                  "stddev_over_time"])
def test_per_series_panel_on_a_mesh(odd, func):
    ref_series, series, _ = odd
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng, flat = _mesh_engines()
    want = np.array(ref.try_rollup_tpu(jeng, func, ref_series, _rcfg(cfg),
                                       ()))
    got = np.array(ce.try_rollup(peng, func, series, cfg, ()))
    assert got.shape == want.shape == (S_ODD, 11)
    # each row rolls up on its own shard exactly as unsharded
    np.testing.assert_array_equal(
        got, np.array(ce.try_rollup(flat, func, series, cfg, ())))
    if func == "stddev_over_time":
        np.testing.assert_allclose(got * got, want * want, rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("name,k", [("topk", 3), ("bottomk", 79),
                                    ("topk_median", 4), ("bottomk_avg", 3)])
def test_topk_panel_on_a_mesh(odd, name, k):
    ref_series, series, _ = odd
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng, flat = _mesh_engines()
    want = ref.try_topk_rollup_tpu(jeng, name, k, "rate", ref_series,
                                   _rcfg(cfg))
    got = ce.try_topk_rollup(peng, name, k, "rate", series, cfg)
    same = ce.try_topk_rollup(flat, name, k, "rate", series, cfg)
    assert got and [i for i, _ in got] == [i for i, _ in want] == \
        [i for i, _ in same]
    assert all(i < S_ODD for i, _ in got)  # no padded row comes back
    for (_, g), (_, w), (_, u) in zip(got, want, same):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True)
        np.testing.assert_array_equal(g, u)


@pytest.mark.parametrize("phi,grouping", [(0.9, "instance"), (0.5, "none")])
def test_quantile_panel_on_a_mesh(odd, phi, grouping):
    ref_series, series, gids = odd
    if grouping == "none":
        gids = np.zeros(S_ODD, np.int32)
    G = int(gids.max()) + 1
    cfg = RollupConfig(T0 - 600_000, T0, STEP, WINDOW)
    jeng, peng, flat = _mesh_engines()
    slots, max_group = ce.group_slots(gids, G)
    want = ref.try_quantile_rollup_tpu(jeng, phi, "rate", ref_series, gids,
                                       G, _rcfg(cfg), slots, max_group)
    got = ce.try_quantile_rollup(peng, phi, "rate", series, gids, G, cfg,
                                 max_group)
    assert got is not None and got.shape == want.shape == (G, 11)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_array_equal(got, ce.try_quantile_rollup(
        flat, phi, "rate", series, gids, G, cfg, max_group))


def test_rolling_refresh_on_a_mesh(tmp_path):
    import jax.numpy as jnp

    st = _Store(tmp_path)
    try:
        jeng, peng, _ = _mesh_engines()
        start, end = T0 - 600_000, T0
        series, gids, G, finfo = st.fetch(start, end)
        pseries = _port_series(series)
        cfg = RollupConfig(start, end, STEP, WINDOW)
        key = ("mesh-rolling", start)
        want = ref.try_aggr_rollup_tpu(jeng, "sum", "rate", series, gids, G,
                                       _rcfg(cfg), cache_key=key)
        got = ce.try_aggr_rollup(peng, "sum", "rate", pseries, gids, G, cfg,
                                 cache_key=key)
        _close(got, want)
        structural = st.s.structural_version
        jrt = ref.RollingTile(
            tiles=jeng.cache().get(key), base_ms=cfg.start,
            n_cap=int(jeng.cache().get(key)[0].shape[1]), lo_ms=finfo[0],
            hi_ms=finfo[1], version=finfo[2], structural=structural,
            counts_host=np.array([sd.timestamps.size for sd in series],
                                 np.int64),
            row_of_raw={sd.raw_name: i for i, sd in enumerate(series)},
            n_samples=sum(sd.timestamps.size for sd in series),
            adopted_key=key)
        skey, tkey = ce.device_roll_keys("rt", None, "rate", "sum", None,
                                         ("instance",), False, None, WINDOW)
        group_keys = [(("instance", f"h{g}"),) for g in range(G)]
        prt = ce.register_window(peng, skey, tkey, gids, group_keys,
                                 tile_key=key, series=pseries, cfg=cfg,
                                 fetch_info=finfo, structural=structural)
        _, groups, _, qx, rb = peng.window_cache().get(skey)
        assert qx is None and rb is None
        assert isinstance(groups, ce.MeshGroups) and len(groups.shards) == 8
        jgids = jnp.asarray(gids)
        slots, max_group = ce.group_slots(gids, G)
        adv = 4 * STEP
        for r in range(3):
            st.ingest_newer(end + 5_000, n=adv // 15_000)
            start, end = start + adv, end + adv
            fetch_lo = start - WINDOW - LOOKBACK_DELTA
            if r == 2:
                # K4 per shard, every shard at the same cutoff
                assert ref.compact_window(jeng, jrt, fetch_lo)
                assert ce.compact_window(peng, prt, fetch_lo)
                for a, b in zip(prt.tiles, jrt.tiles[:3]):
                    np.testing.assert_array_equal(host_rows(a),
                                                  np.asarray(b))
            up0 = tile_cache.bytes_uploaded()
            assert ref.advance_rolling(jeng, jrt, st.s, st.filters, start,
                                       fetch_lo, end, None, (0, 0), True)
            assert ce.advance_rolling(peng, prt, st.s, st.filters, start,
                                      fetch_lo, end, None, (0, 0), True)
            assert tile_cache.bytes_uploaded() - up0 < 80 * 40 * 12
            np.testing.assert_array_equal(prt.counts_host, jrt.counts_host)
            for a, b in zip(prt.tiles, jrt.tiles[:3]):
                np.testing.assert_array_equal(host_rows(a), np.asarray(b))
            cfg = RollupConfig(start, end, STEP, WINDOW)
            sh, mt = start - prt.base_ms, fetch_lo - start
            want = ref.run_fused_on_tiles(jeng, "sum", "rate", jrt.tiles,
                                          jgids, G, _rcfg(cfg), sh, mt)
            got = ce.run_fused_on_tiles(peng, "sum", "rate", prt.tiles,
                                        groups, cfg, sh, mt)
            _close(got, want)
            want_q = ref.run_quantile_on_tiles(
                jeng, 0.9, "rate", jrt.tiles, jgids, jnp.asarray(slots), G,
                max_group, _rcfg(cfg), sh, mt)
            got_q = ce.run_quantile_on_tiles(peng, 0.9, "rate", prt.tiles,
                                             groups, cfg, sh, mt)
            _close(got_q, want_q)
            # served == cold: a fresh mesh engine over a fresh fetch
            series2, gids2, G2, _ = st.fetch(start, end)
            cold = ce.try_aggr_rollup(
                ce.CUDAEngine(device="cpu", min_series=4,
                              mesh=ml.make_mesh(8, 1, CPU8)),
                "sum", "rate", _port_series(series2), gids2, G2, cfg)
            _close(got, cold)
    finally:
        st.s.close()


def test_fleet_sequence_on_a_mesh(tmp_path):
    """tests/test_device_fleet.py:180-221's mixed-grid panels: the
    reference's PrometheusAPI + StreamClient with TPUEngine(mesh=_mesh8())
    and the port's FleetPlane on an 8-way mesh engine, from the same
    Storage, every stream every interval, at rtol 1e-12."""
    from test_torch_fleet import (DUR, _API, _Stream, _close as fclose,
                                  _end0, _grid_t0, _ingest, _reference_shape,
                                  _register, _seed)
    from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
    from victoriametrics_tpu.query import rollup_result_cache as rrc
    from victoriametrics_tpu.query.matstream import StreamClient
    from victoriametrics_tpu.storage.storage import Storage

    rrc.GLOBAL.reset()
    panels = [("sum by (g)(rate(fl_m[5m]))", DUR),
              ("max by (i)(rate(fl_m[5m]))", 30 * STEP)]
    s = Storage(str(tmp_path / "s"))
    try:
        t0 = _grid_t0()
        last, rng = _seed(s, t0)
        end = _end0(t0)
        api = PrometheusAPI(s, ref.TPUEngine(
            min_series=4, mesh=ref_mesh.make_mesh(n_series=8)))
        subs = [api.matstreams.subscribe(q, STEP, d) for q, d in panels]
        clis = [StreamClient() for _ in panels]
        for sub, cli in zip(subs, clis):
            cli.apply(sub.next_frame(timeout_s=10.0, now_ms=end))
        ref_plane = api.tpu.fleet()
        streams = []
        for st in (sub.stream for sub in subs):
            info = ref_plane._analyze(api, st)
            streams.append(_Stream(st.q, st.duration,
                                   _reference_shape(info, s), st.tenant))
        eng = ce.CUDAEngine(device="cpu", min_series=4,
                            mesh=ml.make_mesh(8, 1, CPU8))
        port_skeys = [_register(eng, s, st, end) for st in streams]
        for st in streams:
            st.end = end
        port_api = _API(s, eng, streams)
        plane = eng.fleet()
        assert plane.n_stream() == 8
        for interval in range(4):
            end += STEP
            _ingest(s, rng, last, end)
            for sub, cli in zip(subs, clis):
                f = sub.next_frame(timeout_s=10.0, now_ms=end)
                assert f is not None
                cli.apply(f)
            assert plane.run(port_api, end) == 2  # one launch per bucket
            for b in plane._buckets.values():
                assert b.B_pad % 8 == 0 and len(b.dev["ts"]) == 8
            for (q, d), cli, st, skey in zip(panels, clis, streams,
                                             port_skeys):
                r = plane._results[skey]
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
                    fclose(got[k], want[k], f"interval {interval} {q} {k}")
                st.end = end
        assert ref_plane.stats()["launches"] > 0
        assert plane.stats()["members"] == len(panels)
    finally:
        s.close()


def test_query_pipeline_sharded_matches_reference():
    from victoriametrics_tpu.models import rollup_pipeline as ref_pipe
    from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
    cfg = RollupConfig(0, 3_600_000, 60_000, 300_000)
    ts, vals, counts, gids = synth_workload(64, 240, cfg, 8, seed=3)
    pipe = QueryPipeline(cfg, "rate", "sum", 8)
    got = pipe.sharded(ml.make_mesh(8, 1, CPU8))(
        torch.from_numpy(ts), torch.from_numpy(vals),
        torch.from_numpy(counts), gids).numpy()
    rcfg = RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)
    want = np.asarray(ref_pipe.QueryPipeline(rcfg, "rate", "sum", 8).sharded(
        ref_mesh.make_mesh(n_series=8))(ts, vals, counts, gids))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(
        got, pipe.forward(*(torch.from_numpy(a) for a in (ts, vals, counts)),
                          gids).numpy(), rtol=1e-12, atol=0, equal_nan=True)


def test_auto_mesh_leaves_one_card_unsharded():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    mesh = ce.auto_mesh()
    if n < 2:
        assert mesh is None
    else:
        assert mesh.shape == {"series": n, "time": 1}
    assert ce.CUDAEngine(device="cpu").series_shards() == 1
    eng = ce.CUDAEngine(device="cpu", mesh=ml.make_mesh(8, 1, CPU8))
    assert eng.series_shards() == 8 and eng.device == torch.device("cpu")
