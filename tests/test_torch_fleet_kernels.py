"""Port parity for the fleet's three kernels, through their plain PyTorch
versions on the CPU, against the JAX package's jitted fleet functions:
B9 fleet_rollup_aggregate_tile, B10 fleet_append_tile and B11
fleet_compact_tile.  The same numpy-seeded [B, S, N] bucket feeds both
sides (``convert.fleet_from_reference``).

The bucket holds nine live streams and three padded slots (counts 0,
TS_PAD).  Each live stream has its own series, grid shift, fetch bound and
aggregate code, the eight codes mixed in one bucket, and padded rows at
its end; group 4 of 5 stays empty.  Its rows hold counters, gauges,
counter resets (one to a negative value), NaN, Prometheus stale NaNs,
-0.0, and gaps that put the sample before a window below the stream's
fetch bound.  B9 runs every func a fleet bucket rolls (FLEET_FUNCS).

Tolerances: B10 and B11 bit for bit.  B9 at rtol 1e-12 where only the
summation order differs (the reference sums a group through a one-hot
matmul or segment_sum, the port in ascending row order), with the
stddev/stdvar allowances of tests/test_torch_device_rollup.py: the
variance to rtol 1e-9, atol 1e-9, stddev through its square, plus 16 ulp
of the squared group mean for the funcs other than the counter funcs;
deriv and stdvar_over_time at rtol 1e-9, atol 1e-9 and stddev_over_time at
the reference oracle's rtol 1e-6, atol 1e-4 under every aggregate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.decimal import STALE_NAN
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig

STEP, WINDOW, LOOKBACK_DELTA = 60_000, 300_000, 300_000
T_B = 16                 # the bucket's steps
S_B, N_B = 24, 128       # rows and columns per slot
LIVE, B_PAD = 9, 12      # live streams, slots
N_GROUPS = 5             # group 4 stays empty in every stream
PAD_ROWS = 3             # padded rows at the end of each live slot
TS_PAD = int(dr.TS_PAD)
CFG = RollupConfig(0, (T_B - 1) * STEP, STEP, WINDOW)


def _row(rng, kind, n):
    """One row's relative timestamps and values."""
    ts = np.sort(np.arange(n, dtype=np.int64) * 15_000 +
                 rng.integers(-2000, 2000, n)) + 30_000
    v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
    if kind == "gauge":
        v = np.round(rng.uniform(-50, 100, n), 3)
        v[rng.integers(0, n)] = -0.0
    elif kind == "resets":
        for p in rng.integers(1, n, 3):
            v[p:] -= v[p]
        v = np.abs(v)
    elif kind == "negative":
        v[n // 2:] -= v[n // 2] + 40.0
    elif kind == "nan":
        v[n // 3] = np.nan
        v[2 * n // 3] = STALE_NAN
    elif kind == "negzero":
        v[:3] = -0.0
    elif kind == "sparse":
        keep = np.sort(rng.choice(n, max(n // 6, 2), replace=False))
        ts, v = ts[keep], v[keep]
    elif kind == "gap":
        # a third of the samples ~12 minutes earlier: the sample before a
        # window can lie below a stream's fetch bound, which min_ts gates
        ts[:n // 3] -= 700_000
    return ts, v


KINDS = ("counter", "gauge", "resets", "negative", "nan", "negzero",
         "sparse", "gap", "counter")


def _bucket(seed=3):
    """The reference's bucket arrays and the per-stream launch inputs."""
    rng = np.random.default_rng(seed)
    ts = np.full((B_PAD, S_B, N_B), TS_PAD, np.int32)
    vals = np.zeros((B_PAD, S_B, N_B), np.float64)
    counts = np.zeros((B_PAD, S_B), np.int32)
    gids = np.zeros((B_PAD, S_B), np.int32)
    v0 = np.zeros((B_PAD, S_B), np.float64)
    aggr = np.zeros(B_PAD, np.int32)
    shift = np.zeros(B_PAD, np.int32)
    min_ts = np.zeros(B_PAD, np.int32)
    for b in range(LIVE):
        for r in range(S_B - PAD_ROWS):
            n = int(rng.integers(2, N_B - 8))
            t, v = _row(rng, KINDS[(r + b) % len(KINDS)], n)
            counts[b, r] = t.size
            ts[b, r, :t.size] = t
            vals[b, r, :t.size] = v
            gids[b, r] = (r * 7 + b) % (N_GROUPS - 1)
        aggr[b] = b % len(dr.FLEET_AGGR_CODES)
        shift[b] = (b % 4) * STEP + (b % 3) * 15_000
        min_ts[b] = -(WINDOW + LOOKBACK_DELTA) if b % 3 else dr.MIN_TS_NONE
    return ts, vals, counts, gids, v0, aggr, shift, min_ts


BUCKET = _bucket()


def _port(bucket):
    ts, vals, counts, gids, v0, aggr, shift, min_ts = bucket
    t, v, c, layout, v0_t, aggr_t = convert.fleet_from_reference(
        ts, vals, counts, gids, v0, aggr, N_GROUPS, "cpu")
    return t, v, c, layout, v0_t, aggr_t, torch.from_numpy(shift), \
        torch.from_numpy(min_ts)


def _reference(func, bucket, aggr=None):
    ts, vals, counts, gids, v0, aggr0, shift, min_ts = bucket
    cfg = dr.normalized_cfg(func, CFG)
    return np.asarray(ref.fleet_rollup_aggregate_tile(
        func, RefConfig(cfg.start, cfg.end, cfg.step, cfg.window), N_GROUPS,
        jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(counts),
        jnp.asarray(gids), jnp.asarray(aggr0 if aggr is None else aggr),
        jnp.asarray(shift), jnp.asarray(min_ts), jnp.asarray(v0)))


def _close(got, want, aggr, func, mean):
    """The tolerances of tests/test_torch_device_rollup.py::_close."""
    loose = func in ("deriv", "stddev_over_time", "stdvar_over_time")
    rtol, atol = (1e-6, 1e-4) if func == "stddev_over_time" else (1e-9, 1e-9)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if aggr in ("stddev", "stdvar"):
        if aggr == "stddev":
            got, want = got * got, want * want
        if func not in dr.COUNTER_FUNCS:
            atol = atol + 16 * np.finfo(np.float64).eps * (
                1 + np.nan_to_num(mean) ** 2)
        bad = np.abs(got - want) > atol + rtol * np.abs(want)
        assert not np.any(bad & ~np.isnan(want)), (got[bad], want[bad])
    elif loose:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("func", sorted(dr.FLEET_FUNCS))
def test_fleet_rollup_aggregate_matches_reference(func):
    want = _reference(func, BUCKET)
    t, v, c, layout, v0, aggr, shift, min_ts = _port(BUCKET)
    cfg = dr.normalized_cfg(func, CFG)
    got = dr.fleet_rollup_aggregate_tile(func, cfg, layout, t, v, c, aggr,
                                         shift, min_ts, v0).numpy()
    assert got.shape == want.shape == (B_PAD, N_GROUPS, T_B)
    # each stream's group mean, for the variance's 16-ulp allowance
    avg = np.full(B_PAD, dr.FLEET_AGGR_CODES["avg"], np.int32)
    mean = dr.fleet_rollup_aggregate_tile(
        func, cfg, layout, t, v, c, torch.from_numpy(avg), shift, min_ts,
        v0).numpy()
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    for b in range(B_PAD):
        _close(got[b], want[b], names[int(BUCKET[5][b])], func, mean[b])
    # padded slots, the empty group: NaN on both sides
    assert np.isnan(got[LIVE:]).all() and np.isnan(got[:, N_GROUPS - 1]).all()
    assert np.isfinite(got[:LIVE, :N_GROUPS - 1]).sum() > 100


def test_fleet_rollup_aggregate_counts_and_groups_exactly():
    """count and group of every live stream hold bit for bit: no sum order
    reaches them."""
    for code in (dr.FLEET_AGGR_CODES["count"], dr.FLEET_AGGR_CODES["group"]):
        aggr = np.full(B_PAD, code, np.int32)
        bucket = BUCKET[:5] + (aggr,) + BUCKET[6:]
        want = _reference("rate", bucket)
        t, v, c, layout, v0, aggr_t, shift, min_ts = _port(bucket)
        got = dr.fleet_rollup_aggregate_tile(
            "rate", dr.normalized_cfg("rate", CFG), layout, t, v, c, aggr_t,
            shift, min_ts, v0).numpy()
        np.testing.assert_array_equal(got, want)


def test_fleet_rollup_aggregate_equals_k2_per_stream():
    """Each stream of B9 is K2 on that stream's tile at its own shift and
    fetch bound (the fleet's per-stream oracle), here bit for bit: both
    plain versions sum in ascending row order."""
    t, v, c, layout, v0, aggr, shift, min_ts = _port(BUCKET)
    cfg = dr.normalized_cfg("increase", CFG)
    got = dr.fleet_rollup_aggregate_tile("increase", cfg, layout, t, v, c,
                                         aggr, shift, min_ts, v0)
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    for b in range(LIVE):
        groups = dr.group_layout(layout.gids[b], N_GROUPS, "cpu")
        want = dr.rollup_aggregate_tile(
            "increase", names[int(aggr[b])], t[b], v[b], c[b], groups, cfg,
            int(shift[b]), int(min_ts[b]))
        np.testing.assert_array_equal(got[b].numpy(), want.numpy())


def test_fleet_refuses_funcs_that_do_not_roll():
    t, v, c, layout, v0, aggr, shift, min_ts = _port(BUCKET)
    for func in sorted(set(dr.FUNC_CODES) - dr.FLEET_FUNCS):
        with pytest.raises(ValueError):
            dr.fleet_rollup_aggregate_tile(func, CFG, layout, t, v, c, aggr,
                                           shift, min_ts, v0)
    with pytest.raises(ValueError):
        dr.fleet_layout(np.full((2, 3), N_GROUPS), N_GROUPS, "cpu")


def test_fleet_layout_is_each_streams_group_layout():
    layout = dr.fleet_layout(BUCKET[3], N_GROUPS, "cpu")
    for b in range(B_PAD):
        g = dr.group_layout(BUCKET[3][b], N_GROUPS, "cpu")
        assert torch.equal(layout.order[b], g.order)
        assert torch.equal(layout.starts[b], g.starts)


def _planes(rng, B=6, S=10, N=40):
    counts = rng.integers(0, N + 1, (B, S)).astype(np.int32)
    ts = np.full((B, S, N), TS_PAD, np.int32)
    vals = np.zeros((B, S, N), np.float64)
    for b in range(B):
        for s in range(S):
            n = counts[b, s]
            ts[b, s, :n] = np.sort(rng.integers(-30_000, 600_000, n))
            vals[b, s, :n] = rng.normal(0, 100, n)
    return ts, vals, counts


def test_fleet_append_matches_reference_bitwise():
    rng = np.random.default_rng(8)
    ts, vals, counts = _planes(rng)
    B, S, N = ts.shape
    K = 8
    new_ts = rng.integers(600_001, 700_000, (B, S, K)).astype(np.int32)
    new_vals = rng.normal(0, 1, (B, S, K))
    new_vals[0, 0, 0] = -0.0
    new_vals[1, 2, 1] = np.nan
    # nothing staged for slot 2, rows past the capacity drop their tail
    new_counts = rng.integers(0, K + 1, (B, S)).astype(np.int32)
    new_counts[2] = 0
    want = ref.fleet_append_tile(jnp.asarray(ts), jnp.asarray(vals),
                                 jnp.asarray(counts), jnp.asarray(new_ts),
                                 jnp.asarray(new_vals),
                                 jnp.asarray(new_counts))
    t, v, c = convert.tiles_from_reference(ts, vals, counts, "cpu")
    got = dr.fleet_append_tile(t, v, c, torch.from_numpy(new_ts),
                               torch.from_numpy(new_vals),
                               torch.from_numpy(new_counts))
    assert got[0] is t and got[1] is v and got[2] is c  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      np.asarray(w).view(np.uint8))


@pytest.mark.parametrize("seed", [11, 12])
def test_fleet_compact_matches_reference_bitwise(seed):
    rng = np.random.default_rng(seed)
    ts, vals, counts = _planes(rng)
    vals[0, 0, :2] = -0.0
    vals[1, 1, 3] = np.nan
    B = ts.shape[0]
    # per-stream cutoffs; slots 1 and 4 are not compacted (cutoff 0) yet
    # hold live ts < 0, which every slot's compaction drops as in the
    # reference
    cut = rng.integers(1, 300_000, B).astype(np.int32)
    cut[[1, 4]] = 0
    assert (ts[[1, 4]] < 0).any()
    want = ref.fleet_compact_tile(jnp.asarray(ts), jnp.asarray(vals),
                                  jnp.asarray(counts), jnp.asarray(cut),
                                  jnp.asarray(cut))
    t, v, c = convert.tiles_from_reference(ts, vals, counts, "cpu")
    cut_t = torch.from_numpy(cut)
    got = dr.fleet_compact_tile(t, v, c, cut_t, cut_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      np.asarray(w).view(np.uint8))
    # K4 on each slot alone gives the same planes
    for b in range(B):
        k4 = dr.compact_tile(t[b], v[b], c[b], int(cut[b]), int(cut[b]))
        for g, w in zip(got, k4):
            assert torch.equal(g[b].view(torch.uint8) if g.dtype ==
                               torch.float64 else g[b],
                               w.view(torch.uint8) if w.dtype ==
                               torch.float64 else w)


# a bucket whose groups exceed B9's chunk: S_1 rows a slot, two groups;
# stream 0 is one group of every row, stream 1 splits 300 rows from the
# rest, stream 2 puts every row in group 1, slot 3 is padded
S_1, N_1, T_1, G_1 = 2304, 24, 8, 2
CFG_1 = RollupConfig(0, (T_1 - 1) * STEP, STEP, WINDOW)


def _one_group_bucket(seed=5):
    rng = np.random.default_rng(seed)
    B = 4
    ts = np.full((B, S_1, N_1), TS_PAD, np.int32)
    vals = np.zeros((B, S_1, N_1), np.float64)
    counts = np.zeros((B, S_1), np.int32)
    gids = np.zeros((B, S_1), np.int32)
    for b in range(B - 1):
        for r in range(S_1 - PAD_ROWS):
            t, v = _row(rng, KINDS[(r + b) % len(KINDS)],
                        int(rng.integers(2, N_1)))
            counts[b, r] = t.size
            ts[b, r, :t.size] = t
            vals[b, r, :t.size] = v
    gids[1, 300:] = 1
    gids[2] = 1
    shift = np.array([0, STEP, 15_000, 0], np.int32)
    min_ts = np.array([dr.MIN_TS_NONE, -(WINDOW + LOOKBACK_DELTA), 0, 0],
                      np.int32)
    return ts, vals, counts, gids, np.zeros((B, S_1)), np.zeros(B, np.int32), \
        shift, min_ts


ONE_GROUP = _one_group_bucket()


@pytest.mark.parametrize("func", ["rate", "max_over_time"])
def test_fleet_one_group_bucket_matches_reference(func):
    """Groups of 2004-2304 rows, which B9 walks in chunks of FLEET_CHUNK,
    against the reference under every aggregate: count and group bit for
    bit, the rest at the tolerances above."""
    ts, vals, counts, gids, v0, _, shift, min_ts = ONE_GROUP
    cfg = dr.normalized_cfg(func, CFG_1)
    rcfg = RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)
    t, v, c, layout, v0_t, _ = convert.fleet_from_reference(
        ts, vals, counts, gids, v0, np.zeros(4, np.int32), G_1, "cpu")
    assert dr.fleet_chunks(layout) == -(-S_1 // dr.FLEET_CHUNK) > 1
    mean = None
    for name, code in sorted(dr.FLEET_AGGR_CODES.items(),
                             key=lambda x: x[0] != "avg"):
        aggr = np.full(4, code, np.int32)
        want = np.asarray(ref.fleet_rollup_aggregate_tile(
            func, rcfg, G_1, jnp.asarray(ts), jnp.asarray(vals),
            jnp.asarray(counts), jnp.asarray(gids), jnp.asarray(aggr),
            jnp.asarray(shift), jnp.asarray(min_ts), jnp.asarray(v0)))
        got = dr.fleet_rollup_aggregate_tile(
            func, cfg, layout, t, v, c, torch.from_numpy(aggr),
            torch.from_numpy(shift), torch.from_numpy(min_ts), v0_t).numpy()
        assert got.shape == want.shape == (4, G_1, T_1)
        if name == "avg":
            mean = got
        if name in ("count", "group"):
            np.testing.assert_array_equal(got, want)
        else:
            for b in range(4):
                _close(got[b], want[b], name, func, mean[b])
    assert np.isfinite(got[:3]).sum() > 10 and np.isnan(got[3]).all()


@pytest.mark.parametrize("chunk", [dr.FLEET_CHUNK, 256])
def test_fleet_layout_max_group_and_chunk_slots(chunk, monkeypatch):
    """max_group is the largest group of any stream; each stream numbers
    its chunked groups' chunks 0, 1, ... in group order (slot0), within
    the layout's slots."""
    monkeypatch.setattr(dr, "FLEET_CHUNK", chunk)
    layout = dr.fleet_layout(ONE_GROUP[3], G_1, "cpu")
    assert layout.max_group == S_1 and layout.chunk == chunk
    assert dr.fleet_layout(BUCKET[3], N_GROUPS, "cpu").max_group == max(
        int(np.bincount(g, minlength=N_GROUPS).max()) for g in BUCKET[3])
    sizes = np.diff(layout.starts.numpy(), axis=1)
    slots = []
    for b in range(4):
        mine = [int(layout.slot0[b, g]) + c for g in range(G_1)
                if sizes[b, g] > chunk for c in range(-(-sizes[b, g] // chunk))]
        assert mine == list(range(len(mine)))
        slots.append(len(mine))
    # stream 1's groups of 300 and 2004 rows take one chunk more
    n = -(-S_1 // chunk)
    assert slots == [n, n + 1, n, n] and layout.slots == n + 1
    # a bucket of groups no larger than the chunk needs no slots
    small = dr.fleet_layout(BUCKET[3], N_GROUPS, "cpu")
    assert small.slots == 0 and dr.fleet_chunks(small) == 1


def test_fleet_chunk_boundaries_are_the_same_on_stream_shards():
    """B14 runs B9 on each stream shard's own layout: every group keeps
    its size, the chunk and the partial slots its chunks fold through, so
    its chunks [k * chunk, (k + 1) * chunk) and B14's bits are the
    bucket's; only the grid's chunk extent (the shard's largest group)
    may differ."""
    rng = np.random.default_rng(9)
    B, S, G = 8, 2048, 4
    gids = np.zeros((B, S), np.int32)
    gids[1] = np.arange(S) % G                   # 512 rows a group
    gids[2, 300:] = 3                            # 300 and 1748 rows
    gids[3] = rng.integers(0, G, S)              # ~512, uneven
    gids[4] = np.where(np.arange(S) % 40 == 0, 2, 1)
    gids[6] = np.arange(S) * G // S              # consecutive blocks
    gids[7] = np.arange(S) % 16 // 4             # 512 rows, interleaved
    bucket = dr.fleet_layout(gids, G, "cpu")
    extents = set()
    for d in range(4):  # the stream mesh's contiguous shards of 2 streams
        part = slice(2 * d, 2 * d + 2)
        shard = dr.fleet_layout(gids[part], G, "cpu")
        extents.add(dr.fleet_chunks(shard))
        sizes = np.diff(shard.starts.numpy(), axis=1)
        for i, b in enumerate(range(B)[part]):
            for g in range(G):
                m = int(bucket.starts[b, g + 1] - bucket.starts[b, g])
                assert sizes[i, g] == m and shard.chunk == bucket.chunk
                if m > dr.FLEET_CHUNK:
                    assert int(shard.slot0[i, g]) == int(bucket.slot0[b, g])
        assert shard.slots <= bucket.slots
    assert len(extents) > 1  # the shards' largest groups differ
