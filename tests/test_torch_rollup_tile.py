"""Port parity: the windowed rollup (B5) for every CORE_SUPPORTED func,
the port's plain version on the CPU against the JAX package's rollup_tile,
on ragged rows with a NaN sample, a reset to a negative value and a
counter starting at -0.0, unshifted, with a fetch bound, and shifted.

Tolerances, per func:
- bit-equal (NaN positions included) where the reference computes no
  sum: count_over_time, present_over_time, first/last_over_time,
  default_rollup, the time-valued funcs, min/max_over_time, changes
  (a count of ones);
- rtol 1e-12 for every func whose only difference is the summation order
  (sums, averages, deltas, rates), and for lag, where the reference's
  fused (grid - t) / 1e3 rounds one ulp apart;
- deriv and stddev/stdvar_over_time at rtol 1e-9, atol 1e-9: their
  moment formulas cancel (the reference's own oracle test,
  tests/test_device_rollup.py:69-74, allows 1e-9 for deriv and
  rtol 1e-6 / atol 1e-4 for the variances).  stddev is held through its
  square: where a window's variance is zero the reference's fused
  multiply-add leaves ~eps * mean^2, whose square root (~5e-8 here) is
  the reference's noise, not a difference in the function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import CORE_SUPPORTED, RollupConfig

START = 1_753_700_000_000
CFG = RollupConfig(start=START + 600_000, end=START + 1_800_000,
                   step=60_000, window=300_000)
FUNCS = list(CORE_SUPPORTED)
EXACT = {"count_over_time", "present_over_time", "first_over_time",
         "last_over_time", "default_rollup", "tfirst_over_time",
         "tlast_over_time", "timestamp", "min_over_time",
         "max_over_time", "changes"}
LOOSE = {"deriv", "stddev_over_time", "stdvar_over_time"}
# (tile base offset before CFG.start, min_ts in the shifted frame)
SHIFTS = {"unshifted": (0, int(dr.MIN_TS_NONE)),
          "fetch_bound": (0, -400_000),
          "shifted": (120_000, -420_000)}


def _series(rng, n, kind):
    ts = np.sort(np.arange(n, dtype=np.int64) * 15_000 + START +
                 rng.integers(-2000, 2000, n))
    if kind == "gauge":
        v = np.round(rng.uniform(0, 100, n), 3)
    else:
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        if kind == "counter_resets":
            for p in rng.integers(1, n, 3):
                v[p:] -= v[p]
            v = np.abs(v)
    return ts, v


def _ragged():
    """tests/test_device_rollup.py's ragged fixture, plus a reset to a
    negative value, a NaN sample, a counter starting at -0.0 and a gauge
    with repeated values."""
    rng = np.random.default_rng(11)
    out = [_series(rng, int(rng.integers(3, 200)),
                   ("gauge", "counter", "counter_resets")[i % 3])
           for i in range(17)]
    out.append((np.array([START + 700_000]), np.array([42.0])))
    out.append((np.array([START + 700_000, START + 710_000]),
                np.array([1.0, 5.0])))
    out.append((np.array([START - 50_000]), np.array([7.0])))
    out.append((np.array([START, START + 900_000, START + 1_700_000]),
                np.array([1.0, 100.0, 3.0])))
    ts, v = _series(rng, 150, "counter")
    v[60:] -= v[60] + 40.0
    out.append((ts, v))
    ts, v = _series(rng, 150, "counter")
    v[90] = np.nan
    out.append((ts, v))
    ts, v = _series(rng, 150, "counter")
    v[:3] = -0.0
    out.append((ts, v))
    ts, _ = _series(rng, 150, "gauge")
    out.append((ts, np.repeat(rng.integers(0, 4, 50), 3).astype(np.float64)))
    return out


RAGGED = _ragged()


def _cases():
    for func in FUNCS:
        for case in SHIFTS:
            if case == "shifted" and func in dr.TIME_VALUED_FUNCS:
                continue  # refused, see test_time_valued_funcs_refuse_a_shift
            yield func, case


@pytest.fixture(scope="module")
def tiles():
    return {off: dr.pack_series(RAGGED, CFG.start - off)
            for off in {o for o, _ in SHIFTS.values()}}


@pytest.mark.parametrize("func,case", list(_cases()))
def test_rollup_tile_plain_matches_reference(tiles, func, case):
    off, min_ts = SHIFTS[case]
    ts, vals, counts = tiles[off]
    cfg = dr.normalized_cfg(func, CFG)
    want = np.asarray(ref.rollup_tile(
        func, jnp.asarray(ts) - np.int32(off), jnp.asarray(vals),
        jnp.asarray(counts), RefConfig(cfg.start, cfg.end, cfg.step,
                                       cfg.window), np.int32(min_ts)))
    got = dr.rollup_tile_plain(func, torch.from_numpy(ts) - off,
                               torch.from_numpy(vals),
                               torch.from_numpy(counts), cfg, min_ts).numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).sum() > 50  # the fixture exercises the func
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if func in EXACT:
        np.testing.assert_array_equal(got, want)
    elif func == "stddev_over_time":  # through its square, see above
        np.testing.assert_allclose(got * got, want * want, rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    elif func in LOOSE:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True)
    # the wrapper runs the same plain version for CPU tensors
    wrapped = dr.rollup_tile(func, torch.from_numpy(ts),
                             torch.from_numpy(vals), torch.from_numpy(counts),
                             cfg, min_ts, off).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("func", sorted(dr.TIME_VALUED_FUNCS))
def test_time_valued_funcs_refuse_a_shift(tiles, func):
    ts, vals, counts = (torch.from_numpy(a) for a in tiles[0])
    with pytest.raises(ValueError):
        dr.rollup_tile(func, ts, vals, counts, CFG, shift=60_000)


def test_func_codes_cover_core_supported():
    assert set(dr.FUNC_CODES) == set(CORE_SUPPORTED)
    assert sorted(dr.FUNC_CODES.values()) == list(range(len(CORE_SUPPORTED)))
