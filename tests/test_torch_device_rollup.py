"""Port parity: the fused rollup + group aggregate (K2), maxPrevInterval,
and the rolling append (K3) / compaction (K4), each run through its plain
PyTorch version on the CPU, against the JAX package's kernels.

Tolerances: append, compact, counts and maxPrevInterval are bitwise; the
rate family and sum/count/avg/min/max/group agree to rtol=1e-12 (only the
summation order differs); the variance to rtol=1e-9, atol=1e-9 (the
cancellation in s2/cnt - mean^2, the bound tests/test_device_rollup.py
uses).  stddev is held to that bound through its square: where a group's
variance is zero, the reference's fused multiply-add leaves a residual of
order eps * mean^2 in s2/cnt - mean^2, and its square root (~1e-8 here)
is noise of the reference, not a difference in the function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.models.rollup_pipeline import (QueryPipeline,
                                                              synth_workload)
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig

START = 1_753_700_000_000
CFG = RollupConfig(start=START + 600_000, end=START + 1_800_000,
                   step=60_000, window=300_000)
FUNCS = list(dr.FUSED_FUNCS)
AGGRS = list(dr.AGGR_FUNCS)
N_GROUPS = 5  # group 4 stays empty: its row must be all NaN
# (tile base offset before CFG.start, min_ts in the shifted frame)
SHIFTS = {"unshifted": (0, int(dr.MIN_TS_NONE)),
          "shifted": (120_000, -420_000)}


def _ref_cfg(cfg):
    return RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)


def _make_series(rng, n, kind, interval=15_000):
    ts = np.arange(n, dtype=np.int64) * interval + START
    ts = np.sort(ts + rng.integers(-2000, 2000, n))
    v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
    if kind == "gauge":
        v = np.round(rng.uniform(0, 100, n), 3)
    elif kind == "counter_resets":
        for p in rng.integers(1, n, 3):
            v[p:] -= v[p]
        v = np.abs(v)
    return ts, v


def _ragged():
    """The ragged fixture of tests/test_device_rollup.py plus a counter
    that goes negative after a reset and a counter holding a NaN."""
    rng = np.random.default_rng(11)
    series = []
    for i in range(17):
        kind = ("gauge", "counter", "counter_resets")[i % 3]
        series.append(_make_series(rng, int(rng.integers(3, 200)), kind))
    series.append((np.array([START + 700_000]), np.array([42.0])))
    series.append((np.array([START + 700_000, START + 710_000]),
                   np.array([1.0, 5.0])))
    series.append((np.array([START - 50_000]), np.array([7.0])))
    series.append((np.array([START, START + 900_000, START + 1_700_000]),
                   np.array([1.0, 100.0, 3.0])))
    ts, v = _make_series(rng, 150, "counter")
    v[60:] -= v[60] + 40.0  # reset to a negative value, then climbs
    series.append((ts, v))
    ts, v = _make_series(rng, 150, "counter")
    v[90] = np.nan
    series.append((ts, v))
    return series


RAGGED = _ragged()
GIDS = (np.arange(len(RAGGED)) * 7 % (N_GROUPS - 1)).astype(np.int32)


def _tile(base_ms):
    return dr.pack_series(RAGGED, base_ms)


def _close(got, want, aggr):
    if aggr == "stddev":
        got, want = got * got, want * want
    if aggr in ("stddev", "stdvar"):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("shift_case", list(SHIFTS))
@pytest.mark.parametrize("func", FUNCS)
def test_rollup_tile_matches_reference(func, shift_case):
    off, min_ts = SHIFTS[shift_case]
    ts, vals, counts = _tile(CFG.start - off)
    cfg = dr.normalized_cfg(func, CFG)
    want = np.asarray(ref.rollup_tile(
        func, jnp.asarray(ts) - np.int32(off), jnp.asarray(vals),
        jnp.asarray(counts), _ref_cfg(cfg), np.int32(min_ts)))
    t = convert.tiles_from_reference(ts, vals, counts, "cpu")
    got = dr.rollup_tile(func, t[0] - off, t[1], t[2], cfg, min_ts).numpy()
    assert np.isfinite(want).sum() > 50  # the fixture exercises the func
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("shift_case", list(SHIFTS))
@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("func", FUNCS)
def test_rollup_aggregate_tile_matches_reference(func, aggr, shift_case):
    off, min_ts = SHIFTS[shift_case]
    ts, vals, counts = _tile(CFG.start - off)
    cfg = dr.normalized_cfg(func, CFG)
    want = np.asarray(ref.rollup_aggregate_tile(
        func, aggr, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(counts),
        jnp.asarray(GIDS), _ref_cfg(cfg), N_GROUPS, np.int32(off),
        np.int32(min_ts)))
    t = convert.tiles_from_reference(ts, vals, counts, "cpu")
    groups = dr.group_layout(GIDS, N_GROUPS, "cpu")
    got = dr.rollup_aggregate_tile(func, aggr, *t, groups, cfg, off,
                                   min_ts).numpy()
    assert got.shape == want.shape
    assert np.isnan(got[N_GROUPS - 1]).all()
    _close(got, want, aggr)


@pytest.mark.parametrize("case", ["range", "min_ts", "instant"])
def test_max_prev_interval_bit_exact(case):
    ts, vals, counts = _tile(CFG.start)
    cfg = dr.normalized_cfg("rate", CFG)
    min_ts = -400_000 if case == "min_ts" else int(dr.MIN_TS_NONE)
    if case == "instant":
        cfg = RollupConfig(0, 0, CFG.step, CFG.window)
    want = np.asarray(ref._max_prev_interval_tile(
        jnp.asarray(ts), jnp.asarray(counts), _ref_cfg(cfg),
        np.int32(min_ts)))
    got = dr._max_prev_interval_tile(torch.from_numpy(ts),
                                     torch.from_numpy(counts), cfg,
                                     min_ts).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _new_cols(counts, K, seed):
    rng = np.random.default_rng(seed)
    S = counts.size
    new_counts = rng.integers(0, K + 1, S).astype(np.int32)
    new_ts = (2_000_000 + np.cumsum(rng.integers(1, 20_000, (S, K)),
                                    axis=1)).astype(np.int32)
    new_vals = rng.normal(0, 100, (S, K))
    return new_ts, new_vals, new_counts


@pytest.mark.parametrize("K", [1, 8, 40])
def test_append_tile_bit_exact(K):
    ts, vals, counts = dr.pack_series(RAGGED, CFG.start, n_pad=224)
    new_ts, new_vals, new_counts = _new_cols(counts, K, K)
    want = ref.append_tile(jnp.asarray(ts), jnp.asarray(vals),
                           jnp.asarray(counts), jnp.asarray(new_ts),
                           jnp.asarray(new_vals), jnp.asarray(new_counts))
    t = convert.tiles_from_reference(ts, vals, counts, "cpu")
    got = dr.append_tile(*t, torch.from_numpy(new_ts),
                         torch.from_numpy(new_vals),
                         torch.from_numpy(new_counts))
    assert all(g is o for g, o in zip(got, t))  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cutoff", [0, 650_000, 10**9])
def test_compact_tile_bit_exact(cutoff):
    ts, vals, counts = dr.pack_series(RAGGED, CFG.start - 600_000,
                                      n_pad=224)
    want = ref.compact_tile(jnp.asarray(ts), jnp.asarray(vals),
                            jnp.asarray(counts), np.int32(cutoff),
                            np.int32(cutoff))
    got = dr.compact_tile(*convert.tiles_from_reference(ts, vals, counts,
                                                        "cpu"),
                          cutoff, cutoff)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pipeline_forward_matches_reference():
    from victoriametrics_tpu.models.rollup_pipeline import QueryPipeline as RQ
    cfg = RollupConfig(start=0, end=3_600_000, step=60_000, window=300_000)
    ts, vals, counts, gids = synth_workload(96, 240, cfg, 8, seed=3)
    want = np.asarray(RQ(_ref_cfg(cfg), "rate", "sum", 8).forward(
        jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(counts),
        jnp.asarray(gids)))
    t = convert.tiles_from_reference(ts, vals, counts, "cpu")
    got = QueryPipeline(cfg, "rate", "sum", 8).forward(
        *t, torch.from_numpy(gids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_group_layout_rejects_out_of_range_ids():
    with pytest.raises(ValueError):
        dr.group_layout(np.array([0, 3], np.int32), 3, "cpu")


def test_wrappers_refuse_mixed_devices():
    ts, vals, counts = convert.tiles_from_reference(*_tile(CFG.start), "cpu")
    with pytest.raises(ValueError):
        dr.compact_tile(ts, vals, counts.to("meta"), 0, 0)
