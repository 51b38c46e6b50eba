#!/usr/bin/env python3
"""Run the port's mesh paths across every visible CUDA card and hold each
against the same work on one card.

    python3 tools/mesh_cards.py [--seed N] [--series S] [--samples N]

Needs two or more cards (an even count).  The series-sharded engine
(``CUDAEngine(mesh=make_mesh())``: one shard per card, peer copies to the
first) answers a cold fused query under every aggregate (B13), the
per-series, topk and quantile panels, then a rolling append (K3 per
shard) and a window slide (K4 per shard); B14 runs a fleet bucket over a
stream mesh of every card and B15 a (cards / 2, 2) time-sharded rollup.
Each result is held against the unsharded engine or kernel on cuda:0:
count, group, min and max and every per-series row bit for bit, the sums
at rtol 1e-12, the variances at rtol and atol 1e-9.  Prints one JSON line
and exits non-zero on the first difference or when fewer than two cards
are visible.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from victoriametrics_tpu_torch import kernels  # noqa: E402
from victoriametrics_tpu_torch.ops import device_rollup as dr  # noqa: E402
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig  # noqa: E402
from victoriametrics_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from victoriametrics_tpu_torch.parallel.partition import (  # noqa: E402
    host_rows, shard_put)
from victoriametrics_tpu_torch.query import cuda_engine as ce  # noqa: E402
from victoriametrics_tpu_torch.storage.columnar import (  # noqa: E402
    ColumnarSeries)
from victoriametrics_tpu_torch.storage.storage import SeriesData  # noqa: E402

T0 = 1_753_700_000_000
SCRAPE, STEP, WINDOW, GROUPS = 15_000, 60_000, 300_000, 256
FIRST = torch.device("cuda", 0)  # where the unsharded side runs


def same(what: str, got, want, aggr: str = "count") -> float:
    """Bit for bit for the order-free results, else rtol 1e-12 (the
    variances 1e-9); NaN where NaN.  Returns the largest difference."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"{what}: shape or NaN positions differ")
    if aggr in ("count", "group", "min", "max"):
        if not np.array_equal(g.view(np.int64), w.view(np.int64)):
            raise AssertionError(f"{what}: not bit-identical")
        return 0.0
    tol = 1e-9 if aggr in ("stddev", "stdvar") else 1e-12
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol if tol > 1e-12
                               else 0.0, equal_nan=True, err_msg=what)
    live = ~np.isnan(w)
    return float(np.abs(g[live] - w[live]).max()) if live.any() else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=8190,
                    help="series (not a multiple of the cards: padded rows)")
    ap.add_argument("--samples", type=int, default=1440)
    args = ap.parse_args(argv)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 or n % 2:
        print(f"mesh_cards: needs an even number (>= 2) of CUDA cards, "
              f"found {n}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kernels.build()
    rng = np.random.default_rng(args.seed)
    S, N = args.series, args.samples
    ts = T0 + np.arange(N, dtype=np.int64)[None, :] * SCRAPE + \
        rng.integers(-2000, 2001, (S, N))
    vals = np.cumsum(rng.integers(0, 50, (S, N)), axis=1).astype(np.float64)
    series = [SeriesData(None, ts[i], vals[i], raw_name=b"m%d" % i)
              for i in range(S)]
    gids = (np.arange(S) % GROUPS).astype(np.int32)
    end = T0 + (N - 1) * SCRAPE
    cfg = RollupConfig(end - 4 * 3600_000, end, STEP, WINDOW)
    mesh = meshlib.make_mesh()  # every visible card, one shard each
    meng = ce.CUDAEngine(mesh=mesh)
    flat = ce.CUDAEngine(device=FIRST)
    key = ("cards",)
    res = {"cards": n, "devices": [torch.cuda.get_device_name(i)
                                   for i in range(n)], "errors": {}}
    err = res["errors"]
    for aggr in dr.AGGR_FUNCS:
        err[f"B13 {aggr}"] = same(
            f"B13 {aggr}",
            ce.try_aggr_rollup(meng, aggr, "rate", series, gids, GROUPS, cfg,
                               cache_key=key),
            ce.try_aggr_rollup(flat, aggr, "rate", series, gids, GROUPS, cfg,
                               cache_key=key), aggr)
    tiles = meng.cache().get(key)
    if [t.device for t in tiles[0]] != meshlib.default_devices():
        raise AssertionError("the tile's shards are not one per card")
    err["B5"] = same("B5", ce.try_rollup(meng, "rate", series, cfg, (),
                                         cache_key=key),
                     ce.try_rollup(flat, "rate", series, cfg, (),
                                   cache_key=key))
    for name in ("topk", "topk_median"):
        g = ce.try_topk_rollup(meng, name, 10, "rate", series, cfg,
                               cache_key=key)
        w = ce.try_topk_rollup(flat, name, 10, "rate", series, cfg,
                               cache_key=key)
        if [i for i, _ in g] != [i for i, _ in w]:
            raise AssertionError(f"{name}: other series")
        err[name] = same(name, np.stack([r for _, r in g]),
                         np.stack([r for _, r in w]))
    _, max_group = ce.group_slots(gids, GROUPS)
    err["B8"] = same("B8", ce.try_quantile_rollup(
        meng, 0.9, "rate", series, gids, GROUPS, cfg, max_group,
        cache_key=key), ce.try_quantile_rollup(
        flat, 0.9, "rate", series, gids, GROUPS, cfg, max_group,
        cache_key=key))
    # a rolling append (K3 per shard) and a slide (K4 per shard)
    fetch_lo = cfg.start - WINDOW - 300_000
    skey, tkey = ce.device_roll_keys("m", None, "rate", "sum", None, ("g",),
                                     False, None, WINDOW)
    keys = [(("g", str(g)),) for g in range(GROUPS)]
    rts = [ce.register_window(eng, skey, tkey, gids, keys, tile_key=key,
                              series=series, cfg=cfg,
                              fetch_info=(fetch_lo, end + 2000, 1),
                              structural=0) for eng in (meng, flat)]
    k = 4
    new_ts = end + 2001 + np.arange(k, dtype=np.int64)[None, :] * SCRAPE + \
        np.zeros((S, 1), np.int64)
    new_v = vals[:, -1:] + np.cumsum(rng.integers(0, 50, (S, k)), axis=1)
    cols = ColumnarSeries(np.arange(S, dtype=np.int64), new_ts,
                          new_v.astype(np.float64), np.full(S, k, np.int64),
                          raw_names=[sd.raw_name for sd in series])
    for eng, rt in zip((meng, flat), rts):
        if not ce._append_cols(eng, rt, cols, fetch_lo) or \
                not ce.compact_window(eng, rt, fetch_lo + 3600_000):
            raise AssertionError("append or slide declined: "
                                 + eng.last_roll_decline)
    for g, w, what in zip(rts[0].tiles, rts[1].tiles, ("ts", "v", "c")):
        a, b = host_rows(g, S), host_rows(w)
        if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError(f"K3/K4 {what}: the shards differ")
    cfg2 = RollupConfig(cfg.start + 3600_000, cfg.end + k * SCRAPE, STEP,
                        WINDOW)
    served = [ce.run_fused_on_tiles(
        eng, "sum", "rate", rt.tiles, eng.window_cache().get(skey)[1], cfg2,
        cfg2.start - rt.base_ms, cfg2.start - WINDOW - 300_000 - cfg2.start)
        for eng, rt in zip((meng, flat), rts)]
    err["refresh"] = same("refresh", *served, "sum")
    # B14: a fleet bucket over a stream mesh of every card
    fmesh = meshlib.make_fleet_mesh()
    B, Sb, Nb = 2 * n, 512, 256
    fts = np.full((B, Sb, Nb), int(dr.TS_PAD), np.int32)
    fv = np.zeros((B, Sb, Nb))
    fc = np.full((B, Sb), Nb - 16, np.int32)
    fts[:, :, :Nb - 16] = (np.arange(Nb - 16) * SCRAPE)[None, None, :]
    fv[:, :, :Nb - 16] = np.cumsum(rng.integers(0, 50, (B, Sb, Nb - 16)),
                                   axis=2)
    fg = rng.integers(0, 8, (B, Sb)).astype(np.int32)
    aggr = (np.arange(B) % 8).astype(np.int32)
    shift = np.zeros(B, np.int32)
    mts = np.full(B, int(dr.MIN_TS_NONE), np.int32)
    v0 = np.zeros((B, Sb))
    fcfg = RollupConfig(0, 40 * STEP, STEP, WINDOW)
    names = ("fleet_ts", "fleet_values", "fleet_counts", "fleet_aggr",
             "fleet_shift", "fleet_min_ts", "fleet_v0")
    arrays = (fts, fv, fc, aggr, shift, mts, v0)
    sh = [shard_put(fmesh, nm, a) for nm, a in zip(names, arrays)]
    lays = [dr.fleet_layout(g, 8, g.device)
            for g in shard_put(fmesh, "fleet_gids", fg)]
    got = meshlib.cached_fleet_rollup_aggregate(fmesh, "rate", fcfg, 8)(
        sh[0], sh[1], sh[2], lays, *sh[3:])
    d0 = FIRST
    want = dr.fleet_rollup_aggregate_tile(
        "rate", fcfg, dr.fleet_layout(fg, 8, d0),
        *(torch.from_numpy(a).to(d0) for a in (fts, fv, fc, aggr, shift,
                                               mts, v0)))
    err["B14"] = same("B14", got.cpu(), want.cpu())
    # B15: (cards / 2, 2) over the first 1024 columns of the series
    m15 = meshlib.make_mesh(n // 2, 2)
    R = S // (n // 2) * (n // 2)
    ts_rel = torch.from_numpy((ts[:R, :1024] - T0).astype(np.int32))
    v15 = torch.from_numpy(vals[:R, :1024].copy())
    valid = torch.ones((R, 1024), dtype=torch.bool)
    c15 = RollupConfig(0, 1024 * SCRAPE - STEP, STEP, WINDOW)
    got = meshlib.time_sharded_rollup(m15, "rate", c15, 32)(
        *(meshlib.split_2d(m15, x) for x in (ts_rel, v15, valid)))
    want = dr.rollup_tile("rate", ts_rel.to(d0), v15.to(d0),
                          torch.full((R,), 1024, dtype=torch.int32,
                                     device=d0), c15)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-9, atol=1e-9, equal_nan=True,
                               err_msg="B15")
    res["seconds"] = time.perf_counter() - t_start
    res["ok"] = True
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
