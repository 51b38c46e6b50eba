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
