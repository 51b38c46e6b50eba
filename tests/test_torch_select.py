"""Port parity: the selections over a rolled tile, each through its plain
PyTorch version on the CPU, against the JAX package's kernels: per-step
topk/bottomk (B6 topk_select_tile) and its row gather (take_rows), the
per-series rank statistic (B7 rank_tile) and the per-group quantile (B8
rollup_quantile_tile).

Tolerances: the picks (indices and NaN flags) and take_rows are exact,
ties included; the rolled tile and the statistics agree to rtol 1e-12
(only the rollup's and the average's summation orders differ); the
quantiles to rtol 1e-12 (their rolled inputs differ by summation order
only, the order statistics and the interpolation are the same)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch import timing
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce

from test_torch_rollup_tile import CFG, RAGGED

S = len(RAGGED)
PHIS = [-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5]


def _rcfg(cfg):
    return RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)


@pytest.fixture(scope="module")
def tile():
    return dr.pack_series(RAGGED, CFG.start)


def _port(tile):
    return tuple(torch.from_numpy(a) for a in tile)


def _jax(tile):
    return tuple(jnp.asarray(a) for a in tile)


# (func, k, bottom): ties come from the integer-valued funcs (count,
# changes) and the all-NaN row (a series before the range), k = S takes
# every series
TOPK_CASES = [("rate", 1, False), ("rate", 3, True), ("count_over_time", 5,
                                                      False),
              ("changes", 4, True), ("increase", 10, False),
              ("count_over_time", S, True), ("delta", S, False)]


@pytest.mark.parametrize("func,k,bottom", TOPK_CASES)
def test_topk_select_tile_matches_reference(tile, func, k, bottom):
    cfg = dr.normalized_cfg(func, CFG)
    w_rolled, w_idx, w_nan = ref.topk_select_tile(func, *_jax(tile),
                                                  _rcfg(cfg), k, bottom)
    rolled, idx, sel_nan = dr.topk_select_tile(func, *_port(tile), cfg, k,
                                               bottom)
    np.testing.assert_allclose(rolled.numpy(), np.asarray(w_rolled),
                               rtol=1e-12, atol=0, equal_nan=True)
    assert idx.dtype == torch.int32 and sel_nan.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(sel_nan.numpy(), np.asarray(w_nan))


@pytest.mark.parametrize("bottom", [False, True])
@pytest.mark.parametrize("k", [1, 7, 40])
def test_topk_select_ties_match_lax_top_k(k, bottom):
    """Signed zeros, infinities and NaN rows: the reference's key and
    jax.lax.top_k against the port's selection."""
    rng = np.random.default_rng(k)
    pool = np.array([-0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, np.nan])
    rolled = pool[rng.integers(0, pool.size, (40, 9))]
    rolled[5] = np.nan
    r = jnp.asarray(rolled)
    key = jnp.where(jnp.isnan(r), -jnp.inf, -r if bottom else r)
    _, w_idx = jax.lax.top_k(key.T, k)
    idx, sel_nan = dr.topk_select(torch.from_numpy(rolled), k, bottom)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(
        sel_nan.numpy(), np.isnan(rolled).T[np.arange(9)[:, None],
                                            np.asarray(w_idx)])


# B6's path boundaries: the old register path's last k (16) and the sort
# path's first before this design (17), the scan path's last (K_REG) and
# the sort path's first (K_REG + 1)
BOUNDARY_KS = [16, 17, dr.K_REG, dr.K_REG + 1]


@pytest.mark.parametrize("bottom", [False, True])
@pytest.mark.parametrize("k", BOUNDARY_KS)
def test_topk_select_path_boundaries_match_lax_top_k(k, bottom):
    """k at each path boundary on a tile of ties (signed zeros,
    infinities), NaN rows and a ragged last 32-step tile."""
    rng = np.random.default_rng(100 + k)
    pool = np.array([-0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5])
    rolled = pool[rng.integers(0, pool.size, (dr.K_REG + 16, 37))]
    rolled[::11] = np.nan
    key = jnp.where(jnp.isnan(rolled), -jnp.inf,
                    -jnp.asarray(rolled) if bottom else jnp.asarray(rolled))
    _, w_idx = jax.lax.top_k(key.T, k)
    w_idx = np.asarray(w_idx)
    idx, sel_nan = dr.topk_select(torch.from_numpy(rolled), k, bottom)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(
        sel_nan.numpy(), np.isnan(rolled).T[np.arange(37)[:, None], w_idx])


# (S, T, k): the dashboard at k = 10, 20 and S, the full width at k = 10
# and 20 and its sort-path check (a 512-step slice), a tile shorter than a
# warp's 32 rows, a tile with k = S on the scan path, and row counts that
# no cluster size divides (the last member's range is shorter)
PLAN_CASES = [(8192, 355, 10), (8192, 355, 20), (8192, 355, 8192),
              (100_000, 5761, 10), (100_000, 5761, 20),
              (100_000, 512, dr.K_REG + 1), (40, 9, 7), (64, 3, 64),
              (30_000, 4, 30_000), (8191, 355, 10), (5001, 355, dr.K_REG)]


@pytest.mark.parametrize("S,T,k", PLAN_CASES)
def test_topk_plan(S, T, k):
    p = dr.topk_plan(S, T, k)
    if k <= dr.K_REG:  # one launch, no scratch
        assert p.scratch == 0 and p.chunk == 0 and p.blocks == 0
        assert p.cluster in (1, 2, 4, 8, 16)
        # the members' row ranges cover [0, S), none empty
        assert p.cluster * p.rows >= S > (p.cluster - 1) * p.rows
        assert p.cluster == 1 or p.rows >= 256
    else:  # the sort path: chunks of steps, scratch for codes and pairs
        assert p.cluster == 1
        assert 1 <= p.chunk <= T and 1 <= p.blocks <= p.chunk
        assert p.scratch >= 9 * p.chunk * S + p.blocks * 24 * k
        assert p.chunk == T or 9 * p.chunk * S <= 256 << 20


def test_topk_plan_fills_the_card():
    # the dashboard's 12 tiles of 32 steps take the largest cluster; the
    # full width's 181 tiles take 2 row ranges each, 2 blocks an SM
    assert dr.topk_plan(8192, 355, 10)[:2] == (16, 512)
    assert dr.topk_plan(100_000, 5761, 10)[:2] == (2, 50_000)
    assert dr.topk_plan(100_000, 5761, 20)[:2] == (2, 50_000)
    assert dr.topk_plan(40, 9, 7).cluster == 1


def test_selection_bounds_count_each_byte_once():
    # B6 reads [S, T] float64 once and writes [T, k] int32 picks and bool
    # flags; take_rows reads and writes M rows and reads M int64 indices
    b = timing.topk_bound(8192, 355, 10)
    assert b["bytes"] == 8192 * 355 * 8 + 355 * 10 * 5
    assert b["ops"] == 8192 * 355 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    r = timing.take_rows_bound(2260, 355)
    assert r["bytes"] == 2260 * 355 * 16 + 2260 * 8 and r["ops"] == 0
    assert timing.bound(1.0, 1e9)["bound_by"] == "operations"


def test_topk_plan_refuses_k_outside_the_rows():
    with pytest.raises(ValueError):
        dr.topk_plan(4, 3, 5)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_take_rows_matches_reference_int_types(tile, dtype):
    """int32 indices (B6's own) and int64 (the engine's), out-of-range
    ones among them (NaN rows, jnp.take's fill mode)."""
    cfg = dr.normalized_cfg("rate", CFG)
    rolled = dr.rollup_tile("rate", *_port(tile), cfg)
    sel = np.array([3, -1, S - 1, S, 0, 3, -S - 2, 2 * S], dtype=dtype)
    want = np.asarray(ref.take_rows(jnp.asarray(rolled.numpy()),
                                    jnp.asarray(sel)))
    got = dr.take_rows(rolled, torch.from_numpy(sel)).numpy()
    np.testing.assert_array_equal(got, want)


def test_take_rows_matches_reference(tile):
    cfg = dr.normalized_cfg("rate", CFG)
    rolled = dr.rollup_tile("rate", *_port(tile), cfg)
    sel = np.array([3, 0, S - 1, 3, 7])
    want = np.asarray(ref.take_rows(jnp.asarray(rolled.numpy()),
                                    jnp.asarray(sel)))
    got = dr.take_rows(rolled, torch.from_numpy(sel)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(dr.RANK_KINDS))
@pytest.mark.parametrize("func", ["rate", "last_over_time"])
def test_rank_tile_matches_reference(tile, func, kind):
    cfg = dr.normalized_cfg(func, CFG)
    w_rolled, w_rank = ref.rank_tile(func, kind, *_jax(tile), _rcfg(cfg))
    rolled, rank = dr.rank_tile(func, kind, *_port(tile), cfg)
    np.testing.assert_allclose(rolled.numpy(), np.asarray(w_rolled),
                               rtol=1e-12, atol=0, equal_nan=True)
    assert np.isnan(np.asarray(w_rank)).any()  # a row with no value
    np.testing.assert_allclose(rank.numpy(), np.asarray(w_rank), rtol=1e-12,
                               atol=0, equal_nan=True)


def _groupings():
    rng = np.random.default_rng(3)
    return {
        "singletons": (np.arange(S, dtype=np.int32), S),
        "uneven": (np.sort(rng.integers(0, 5, S)).astype(np.int32)[
            rng.permutation(S)], 6),  # group 5 stays empty
        "one_group": (np.zeros(S, np.int32), 1),
    }


GROUPINGS = _groupings()
# (tile base offset before CFG.start, min_ts in the shifted frame)
QSHIFTS = {"unshifted": (0, int(dr.MIN_TS_NONE)),
           "shifted": (120_000, -420_000)}


@pytest.mark.parametrize("shift_case", list(QSHIFTS))
@pytest.mark.parametrize("grouping", list(GROUPINGS))
@pytest.mark.parametrize("phi", PHIS)
def test_rollup_quantile_tile_matches_reference(phi, grouping, shift_case):
    off, min_ts = QSHIFTS[shift_case]
    ts, vals, counts = dr.pack_series(RAGGED, CFG.start - off)
    gids, G = GROUPINGS[grouping]
    slots, max_group = ce.group_slots(gids, G)
    cfg = dr.normalized_cfg("rate", CFG)
    want = np.asarray(ref.rollup_quantile_tile(
        "rate", phi, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(counts),
        jnp.asarray(gids), jnp.asarray(slots), _rcfg(cfg), G, max_group,
        np.int32(off), np.int32(min_ts)))
    groups = dr.group_layout(gids, G, "cpu")
    assert groups.max_group == max_group
    got = dr.rollup_quantile_tile("rate", phi, torch.from_numpy(ts),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(counts), groups, cfg, off,
                                  min_ts).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_quantile_interpolates_infinities_like_the_reference():
    """inf - inf in the interpolation gives NaN in both."""
    rolled = np.array([[np.inf, 1.0], [np.inf, 2.0], [-np.inf, 3.0],
                       [np.inf, np.nan]])
    groups = dr.group_layout(np.zeros(4, np.int32), 1, "cpu")
    for phi in (0.5, 0.9, 1.0):
        got = dr.quantile_groups(torch.from_numpy(rolled), groups, phi)
        r = jnp.sort(jnp.asarray(rolled), axis=0)
        n = (~np.isnan(rolled)).sum(axis=0)
        rank = phi * np.maximum(n - 1, 0)
        lo, hi = np.floor(rank).astype(int), np.ceil(rank).astype(int)
        v_lo = np.asarray(r)[lo, np.arange(2)]
        v_hi = np.asarray(r)[hi, np.arange(2)]
        with np.errstate(invalid="ignore"):
            want = v_lo + (rank - lo) * (v_hi - v_lo)
        np.testing.assert_array_equal(got.numpy()[0], want)


def test_topk_select_refuses_k_outside_the_rows():
    rolled = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        dr.topk_select(rolled, 5, False)
    with pytest.raises(ValueError):
        dr.topk_select(rolled, 0, False)


# B8's plan at the main path's shapes (quantile by instance, M = 32 over
# 256 groups; the dashboard's median without by, M = 8192; the full
# width's instant quantile, M = 100,000 at one step), at the staging edges
# of one block (24,576 keys) and of a cluster (16 x 24,576), at a group no
# cluster size divides, and at the large-group test's shape below
QPLAN_CASES = [(256, 355, 32), (1, 355, 8192), (1, 1, 100_000),
               (1, 355, 24_576), (1, 355, 24_577), (1, 1, 393_216),
               (1, 1, 393_217), (1, 1, 100_003), (1, 4, 30_000),
               (3, 2, 40_000), (2, 66, 8192)]


@pytest.mark.parametrize("G,T,M", QPLAN_CASES)
def test_quantile_plan(G, T, M):
    p = dr.quantile_plan(G, T, M)
    if M <= 32:
        assert p == (dr.Q_WARP, 1, M, 0)
        return
    assert p.path == (dr.Q_CLUSTER if p.cluster > 1 else dr.Q_BLOCK)
    assert p.cluster in (1, 2, 4, 8, 16)
    # the members' slices cover the largest group, none empty
    assert p.cluster * p.slice >= M > (p.cluster - 1) * p.slice
    assert p.cluster == 1 or p.slice >= 2048
    # a cluster leaves the card no fuller than one block an SM
    assert p.cluster == 1 or G * T * p.cluster <= 132
    # staged exactly when a block's keys fit its shared memory
    assert p.staged == int(p.slice <= 24_576)


def test_quantile_plan_spreads_one_large_group():
    # the dashboard keeps one block per (group, step); the full width's
    # instant quantile takes 16 SMs; the staging edges of a block and of
    # a cluster, and a group that 16 does not divide (last member 6238)
    assert dr.quantile_plan(1, 355, 8192) == (dr.Q_BLOCK, 1, 8192, 1)
    assert dr.quantile_plan(1, 1, 100_000) == (dr.Q_CLUSTER, 16, 6250, 1)
    assert dr.quantile_plan(1, 355, 24_576).staged == 1
    assert dr.quantile_plan(1, 355, 24_577) == (dr.Q_BLOCK, 1, 24_577, 0)
    assert dr.quantile_plan(1, 1, 393_216) == (dr.Q_CLUSTER, 16, 24_576, 1)
    assert dr.quantile_plan(1, 1, 393_217) == (dr.Q_CLUSTER, 16, 24_577, 0)
    p = dr.quantile_plan(1, 1, 100_003)
    assert p[:3] == (dr.Q_CLUSTER, 16, 6251) and 100_003 - 15 * 6251 == 6238
    # fewer SMs, fewer members; few keys, fewer members
    assert dr.quantile_plan(1, 1, 100_000, sms=8).cluster == 8
    assert dr.quantile_plan(1, 1, 8192).cluster == 4


def _large_group_tile(S=30_000, N=6):
    """One group of S series over 4 steps: last_over_time of sparse rows
    (empty windows and rows with no sample are NaN gaps) whose values hold
    ties, signed zeros, infinities and NaN samples."""
    rng = np.random.default_rng(21)
    pool = np.array([-0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5])
    counts = rng.integers(0, N + 1, S).astype(np.int32)
    ts = np.full((S, N), dr.TS_PAD, np.int32)
    vals = np.zeros((S, N))
    for s in range(S):
        n = counts[s]
        ts[s, :n] = np.sort(rng.choice(300_000, n, replace=False)) - 120_000
        v = np.round(rng.normal(0, 3, n), 1)  # ties
        pick = rng.random(n) < 0.3
        v[pick] = pool[rng.integers(0, pool.size, int(pick.sum()))]
        vals[s, :n] = v
    return ts, vals, counts


LARGE_GROUP = _large_group_tile()


@pytest.mark.parametrize("phi", PHIS)
def test_quantile_over_one_large_group_matches_reference(phi):
    """B8's cluster path's shape (one group of 30,000 series, 4 steps)
    against the reference's jitted rollup_quantile_tile, exactly: the
    rolled values are the samples themselves (last_over_time) and the
    order statistics and interpolation are the same."""
    ts, vals, counts = LARGE_GROUP
    S = ts.shape[0]
    cfg = RollupConfig(0, 180_000, 60_000, 120_000)
    gids = np.zeros(S, np.int32)
    want = np.asarray(ref.rollup_quantile_tile(
        "last_over_time", phi, jnp.asarray(ts), jnp.asarray(vals),
        jnp.asarray(counts), jnp.asarray(gids),
        jnp.asarray(np.arange(S, dtype=np.int32)), _rcfg(cfg), 1, S))
    groups = dr.group_layout(gids, 1, "cpu")
    assert dr.quantile_plan(1, 4, groups.max_group).path == dr.Q_CLUSTER
    got = dr.rollup_quantile_tile("last_over_time", phi, torch.from_numpy(ts),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(counts), groups,
                                  cfg).numpy()
    assert got.shape == want.shape == (1, 4)
    np.testing.assert_array_equal(got, want)
    if 0 < phi < 1:  # the extremes are infinite, inf - inf is NaN
        assert np.isfinite(got).all()
