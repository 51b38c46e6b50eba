"""Port parity for the numpy rollup oracle
(victoriametrics_tpu_torch/ops/rollup_np.py) against the reference's.

Inputs are made from a seed with numpy: ragged counter series with resets
and jittered 15 s scrapes (empty, one-, two-sample and long rows), a
decimal gauge, and rows with stale NaNs and plain NaNs.  Three grids: a
range query with a 5 m window, the same with the window left to the step
(the scrape-interval gate of the deriv family), and an instant query.

  * every core rollup function, one series at a time (``rollup``);
  * every function of the batched path (``rollup_batch``), with its
    arguments, on the finite rows, and its refusal of rows with NaNs;
  * the native and numpy paths of the port against each other: the
    counter family's fused window walk and ``remove_counter_resets``;
  * the scrape-interval estimators and the function tables.

Every comparison is bit for bit: the port runs the reference's numpy code
and the same native source."""

import numpy as np
import pytest

from victoriametrics_tpu.ops import rollup_np as ref
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.ops import decimal as dec
from victoriametrics_tpu_torch.ops import rollup_np as port

T0 = 1_753_700_000_000
SCRAPE = 15_000
STEP = 60_000

GRIDS = {
    "range": (T0 + 600_000, T0 + 3_000_000, STEP, 300_000),
    "step_window": (T0 + 600_000, T0 + 3_000_000, STEP, 0),
    "instant": (T0 + 2_400_000, T0 + 2_400_000, STEP, 300_000),
}


def _timestamps(rng, n):
    jitter = rng.integers(-2_000, 2_001, n)
    ts = T0 + np.arange(n, dtype=np.int64) * SCRAPE + jitter
    return np.maximum.accumulate(ts + np.arange(n))  # strictly increasing


def _series(seed=13):
    """(ts, values) rows: counters with resets, a decimal gauge and rows
    of every small length; the last three carry NaNs."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in (0, 1, 2, 3, 7, 21, 22, 150, 200, 230):
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        for r in np.sort(rng.choice(n, size=min(n // 40, 4),
                                    replace=False)) if n else ():
            v[r:] -= v[r] - rng.integers(0, 5)   # a reset to a small value
        rows.append((_timestamps(rng, n), v))
    # a partial reset (a drop of less than 1/8) and a long flat stretch
    v = np.cumsum(rng.integers(1, 9, 200)).astype(np.float64)
    v[120:] -= 3.0
    v[40:90] = v[40]
    rows.append((_timestamps(rng, 200), v))
    rows.append((_timestamps(rng, 180),
                 np.round(rng.normal(50, 20, 180), 3)))       # gauge
    for n, k in ((200, 5), (160, 9), (90, 2)):
        ts = _timestamps(rng, n)
        v = np.cumsum(rng.integers(0, 40, n)).astype(np.float64)
        v[rng.choice(n, k, replace=False)] = np.nan
        v[rng.choice(n, k, replace=False)] = dec.STALE_NAN
        rows.append((ts, v))
    return rows


ROWS = _series()
FINITE = [r for r in ROWS if np.isfinite(r[1]).all()]
N_NAN = len(ROWS) - len(FINITE)

#: arguments for the functions that take them
ARGS = {"quantile_over_time": (0.9,), "count_eq_over_time": (100.0,),
        "count_ne_over_time": (100.0,), "count_le_over_time": (500.0,),
        "count_gt_over_time": (500.0,), "share_eq_over_time": (100.0,),
        "share_le_over_time": (500.0,), "share_gt_over_time": (500.0,),
        "sum_eq_over_time": (100.0,), "sum_le_over_time": (500.0,),
        "sum_gt_over_time": (500.0,), "predict_linear": (600.0,),
        "hoeffding_bound_lower": (0.9,), "hoeffding_bound_upper": (0.9,),
        "duration_over_time": (30.0,)}


#: what the batched path refuses on these rows (the reference's rule)
DECLINED = {"geomean_over_time"}


def _cfgs(mod):
    return {k: mod.RollupConfig(*g) for k, g in GRIDS.items()}


def _bits_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert np.array_equal(got.view(np.int64), want.view(np.int64)), \
        f"{what}: {got} != {want}"


def test_the_inputs_hold_what_the_tests_need():
    assert N_NAN == 3 and len(FINITE) == len(ROWS) - 3
    assert any(ts.size == 0 for ts, _ in ROWS)
    assert any((np.diff(v) < 0).any() for _, v in FINITE)   # resets
    assert any(dec.is_stale_nan(v).any() for _, v in ROWS)


def test_tables_equal_the_reference():
    assert port.CORE_SUPPORTED == ref.CORE_SUPPORTED
    assert port.EXTENDED_SUPPORTED == ref.EXTENDED_SUPPORTED
    assert port.SUPPORTED == ref.SUPPORTED
    assert port.ARG_COUNTS == ref.ARG_COUNTS
    for func in ref.SUPPORTED + ("nope",):
        for args in ((), (1.0,), (1.0, 2.0), ("x",)):
            assert port.batch_supported(func, args) == \
                ref.batch_supported(func, args), (func, args)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("func", ref.CORE_SUPPORTED)
def test_rollup_equals_the_reference(func, grid):
    pc, rc = _cfgs(port)[grid], _cfgs(ref)[grid]
    for i, (ts, v) in enumerate(ROWS):
        _bits_equal(port.rollup(func, ts, v, pc), ref.rollup(func, ts, v, rc),
                    f"{func} row {i}")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("func", ref.SUPPORTED)
def test_rollup_batch_equals_the_reference(func, grid):
    pc, rc = _cfgs(port)[grid], _cfgs(ref)[grid]
    args = ARGS.get(func, ())
    got = port.rollup_batch(func, FINITE, pc, args)
    want = ref.rollup_batch(func, FINITE, rc, args)
    if want is None:   # a refusal (geomean of rows with zeros) is equal too
        assert got is None and func in DECLINED
    else:
        _bits_equal(got, want, func)
    # rows with NaNs leave the batched path to the per-series one
    assert port.rollup_batch(func, ROWS, pc, args) is None
    assert ref.rollup_batch(func, ROWS, rc, args) is None


def _packed(rows):
    S = len(rows)
    counts = np.array([ts.size for ts, _ in rows], np.int64)
    N = int(counts.max())
    ts2 = np.full((S, N), np.iinfo(np.int64).max, np.int64)
    v2 = np.zeros((S, N), np.float64)
    for i, (ts, v) in enumerate(rows):
        ts2[i, :ts.size], v2[i, :ts.size] = ts, v
    return ts2, v2, counts


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("func", sorted(native.ROLLUP_COUNTER_FUNCS))
def test_native_and_numpy_paths_agree(func, grid, monkeypatch):
    assert native.available()
    cfg = _cfgs(port)[grid]
    ts2, v2, counts = _packed(FINITE)
    fused = port.rollup_batch_packed(func, ts2, v2, counts, cfg)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = port.rollup_batch_packed(func, ts2, v2, counts, cfg)
    _bits_equal(fused, plain, func)
    assert np.isfinite(fused).any()


def test_counter_resets_native_and_numpy_agree(monkeypatch):
    assert native.available()
    _, v2, _ = _packed(FINITE)
    rows = [v2, v2[9], v2[:, :1], np.zeros((2, 0))]   # v2[9]: 230 samples
    fused = [port.remove_counter_resets(v) for v in rows]
    monkeypatch.setattr(native, "available", lambda: False)
    for v, f in zip(rows, fused):
        _bits_equal(f, port.remove_counter_resets(v))
        _bits_equal(f, ref.remove_counter_resets(v))
    assert (np.diff(v2[9]) < 0).any() and (np.diff(fused[1]) >= 0).all()


def test_scrape_interval_estimators_equal_the_reference():
    ts2, _, counts = _packed(ROWS)
    for ts, _ in ROWS:
        for default in (STEP, 1_000):
            assert port.scrape_interval_estimate(ts, default) == \
                ref.scrape_interval_estimate(ts, default)
    for default in (STEP, 1_000):
        si = port.scrape_interval_estimate_batch(ts2, counts, default)
        _bits_equal(si, ref.scrape_interval_estimate_batch(ts2, counts,
                                                           default))
        _bits_equal(port.max_prev_interval_batch(si),
                    ref.max_prev_interval_batch(si))
    for si in (1, 2_000, 2_001, 4_000, 8_000, 15_000, 16_001, 32_000,
               32_001, 600_000):
        assert port.max_prev_interval(si) == ref.max_prev_interval(si)
    for grid in GRIDS:
        pc, rc = _cfgs(port)[grid], _cfgs(ref)[grid]
        for ts, _ in ROWS:
            assert port._max_prev_interval_for(ts, pc) == \
                ref._max_prev_interval_for(ts, rc)
        _bits_equal(pc.out_timestamps(), rc.out_timestamps())
        assert pc.lookback == rc.lookback
