"""Port parity: the host decimal codec and nearest-delta2 plane packing
(per series and flat), the cold upload's host half, and the K1 decode
(its plain PyTorch version on the CPU) against the JAX package.
Everything here is bit-exact, but for the one intended difference of the
pack (NaN mantissas), held against the reference's numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.ops import device_decode as ref_dd
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.ops.rollup_np import rollup as ref_rollup
from victoriametrics_tpu.query.tpu_engine import tile_capacity as ref_capacity
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import decimal as dec
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.ops.device_rollup import pack_series
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query.cuda_engine import tile_capacity
from victoriametrics_tpu_torch.storage.storage import SeriesData

START = 1_753_700_000_000

# (timestamp jitter ms, max counter increment): the narrowest plane that
# fits the second-order deltas is int8, int16 and int32 respectively
PLANE_CASES = {
    "int8": (20, 30),
    "int16": (2_000, 5_000),
    "int32": (100_000, 2_000_000),
}


def _series(seed, jitter, incr, S=24, n_max=200, exp=-2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        n = int(rng.integers(1, n_max))
        ts = np.arange(n, dtype=np.int64) * 15_000 + START + \
            rng.integers(-jitter, jitter + 1, n)
        ts.sort()
        mant = np.cumsum(rng.integers(0, incr + 1, n)).astype(np.int64)
        out.append((ts, mant, exp))
    return out


@pytest.mark.parametrize("values", [
    np.array([1.5, 2.25, -3.0, 0.0]),
    np.array([1e-3, 2e-3, 7.0, 1e9, 12345.678, 0.1, 0.2, 0.3, 42.0]),
    np.array([np.nan, ref_dec.STALE_NAN, np.inf, -np.inf, 1.0, 2.0, 3.0,
              4.0, 5.0, 6.0]),
    np.cumsum(np.random.default_rng(3).integers(0, 50, 500)).astype(float),
    np.round(np.random.default_rng(4).uniform(0, 100, 300), 3),
    np.random.default_rng(5).normal(0, 1, 64),
], ids=["small", "mixed", "specials", "counter", "gauge3", "full"])
def test_float_to_decimal_matches_reference(values):
    m, e = dec.float_to_decimal(values)
    rm, re_ = ref_dec.float_to_decimal(values)
    assert e == re_
    np.testing.assert_array_equal(m, rm)
    assert m.dtype == rm.dtype


@pytest.mark.parametrize("plane", list(PLANE_CASES))
def test_pack_delta_planes_identical(plane):
    jitter, incr = PLANE_CASES[plane]
    series = _series(41, jitter, incr)
    got = dd.pack_delta_planes(series, START)
    want = ref_dd.pack_delta_planes(series, START, np.float64)
    assert got is not None and want is not None
    assert np.dtype(got.val_d2.dtype).name == plane
    for f in ("ts_first", "ts_fdelta", "ts_d2", "val_first", "val_fdelta",
              "val_d2", "scale", "counts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("plane", list(PLANE_CASES))
def test_decode_tiles_bit_exact_at_capacity(plane):
    jitter, incr = PLANE_CASES[plane]
    series = _series(42, jitter, incr)
    planes = ref_dd.pack_delta_planes(series, START, np.float64)
    n = int(planes.counts.max())
    n_cap = tile_capacity(n)
    assert n_cap == ref_capacity(n)
    # headroom columns as the engines pad them: zero d2 past the data
    pad = max(n_cap - 2 - planes.ts_d2.shape[1], 0)
    planes.ts_d2 = np.pad(planes.ts_d2, ((0, 0), (0, pad)))
    planes.val_d2 = np.pad(planes.val_d2, ((0, 0), (0, pad)))
    fields = [getattr(planes, f) for f in convert._PLANE_FIELDS]
    want_ts, want_v = ref_dd.decode_tiles(*[jnp.asarray(a) for a in fields],
                                          n_cap, np.float64)
    got_ts, got_v = dd.decode_tiles(
        *convert.planes_from_reference(planes, "cpu"), n_cap)
    assert got_ts.dtype == torch.int32 and got_v.dtype == torch.float64
    assert tuple(got_ts.shape) == (len(series), n_cap)
    # the whole planes, headroom tails included
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_array_equal(got_v.numpy().view(np.uint64),
                                  np.asarray(want_v).view(np.uint64))


def test_decode_tail_wraps_like_int32():
    """A headroom tail that overflows int32 wraps to the same bits as the
    reference's int32 cumsum."""
    ts = np.array([0, 1_000_000_000, 2_000_000_000], dtype=np.int64)
    mant = np.array([0, 1_000_000_000, 2_000_000_000], dtype=np.int64)
    planes = ref_dd.pack_delta_planes([(ts + START, mant, 0)], START,
                                      np.float64)
    n_cap = 8
    planes.ts_d2 = np.pad(planes.ts_d2, ((0, 0), (0, n_cap - 3)))
    planes.val_d2 = np.pad(planes.val_d2, ((0, 0), (0, n_cap - 3)))
    fields = [getattr(planes, f) for f in convert._PLANE_FIELDS]
    want_ts, want_v = ref_dd.decode_tiles(*[jnp.asarray(a) for a in fields],
                                          n_cap, np.float64)
    got_ts, got_v = dd.decode_tiles(
        *convert.planes_from_reference(planes, "cpu"), n_cap)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (got_v.numpy()[0, 3:] < 0).any()  # the tail did wrap


def test_overflow_falls_back():
    series = [(np.array([START, START + 1000], dtype=np.int64),
               np.array([0, 1 << 40], dtype=np.int64), 0)]
    assert dd.pack_delta_planes(series, START) is None
    assert ref_dd.pack_delta_planes(series, START) is None


def test_decode_rejects_short_planes():
    planes = dd.pack_delta_planes(_series(7, 20, 30, S=4, n_max=20), START)
    args = convert.planes_from_reference(planes, "cpu")
    with pytest.raises(ValueError):
        dd.decode_tiles(*args, planes.ts_d2.shape[1] + 3)


# --- the flat pack (pack_delta_planes_flat) and the cold upload's host half

PLANE_FIELDS = ("ts_first", "ts_fdelta", "ts_d2", "val_first", "val_fdelta",
                "val_d2", "scale", "counts")


def _assert_planes_equal(got, want, cols=0):
    """Field for field, dtype for dtype; `cols` widens want's d2 planes
    with zero columns as the cold upload's headroom does."""
    assert got is not None and want is not None
    for f in PLANE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f.endswith("d2") and b.shape[1] < cols:
            b = np.pad(b, ((0, 0), (0, cols - b.shape[1])))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _flat(series):
    counts = np.array([t.size for t, _, _ in series], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64)
    return (np.concatenate([t for t, _, _ in series]),
            np.concatenate([m for _, m, _ in series]), starts,
            np.array([e for _, _, e in series], np.int64))


def _layout_series(layout, jitter, incr):
    if layout == "ragged":
        return _series(51, jitter, incr, S=40, n_max=300)
    if layout == "short":  # 1-8 samples: the scalar conversion's series
        return _series(52, jitter, incr, S=30, n_max=9)
    if layout == "one_two_three":
        return [s for n in (1, 2, 3, 2, 1, 3)
                for s in _series(53 + n, jitter, incr, S=1, n_max=n + 1)
                if s[0].size == n] or _series(53, jitter, incr, S=3,
                                              n_max=2)
    rng = np.random.default_rng(54)  # "fixed": every row 120 samples
    return [(np.sort(START + np.arange(120) * 15_000 +
                     rng.integers(-jitter, jitter + 1, 120)),
             np.cumsum(rng.integers(0, incr + 1, 120)), int(e))
            for e in rng.integers(-4, 2, 30)]


@pytest.mark.parametrize("chunk", [dd.PACK_CHUNK, 50])
@pytest.mark.parametrize("layout", ["ragged", "short", "one_two_three",
                                    "fixed"])
@pytest.mark.parametrize("plane", list(PLANE_CASES))
def test_flat_pack_matches_reference(plane, layout, chunk, monkeypatch):
    """pack_delta_planes_flat == the reference's per-series pack, field for
    field, at each plane width, with ragged, short (1-8 samples) and equal
    rows, in one chunk of rows and in chunks of a few rows."""
    monkeypatch.setattr(dd, "PACK_CHUNK", chunk)
    series = _layout_series(layout, *PLANE_CASES[plane])
    want = ref_dd.pack_delta_planes(series, START, np.float64)
    _assert_planes_equal(dd.pack_delta_planes_flat(*_flat(series), START),
                         want)
    _assert_planes_equal(dd.pack_delta_planes(series, START), want)
    cols = want.ts_d2.shape[1] + 7  # the cold upload's headroom columns
    got = dd.pack_delta_planes_flat(*_flat(series), START, cols)
    assert got.ts_d2.shape == got.val_d2.shape == (len(series), cols)
    _assert_planes_equal(got, want, cols)


def _overflow_case(case):
    """A series list of which one series breaks an int32 bound."""
    base = _series(60, 20, 30, S=6, n_max=40)
    k = int(np.argmax([t.size for t, _, _ in base]))
    ts, m, e = base[k]
    n = ts.size
    if case == "ts_after":
        ts = ts + 2**31
    elif case == "ts_before":
        ts = ts - 2**31 - 10**6
    elif case == "mantissa":
        m = m + 2**31
    elif case == "negative_mantissa":  # -2**31 itself is out, as abs()
        m = m - m[0] - 2**31
    elif case == "first_delta":
        m = np.concatenate([[-2**30 - 5], np.full(n - 1, 2**30 + 5)])
    elif case == "second_delta":  # deltas fit, their difference does not
        m = np.array([0, 2**30, 0] * (n // 3 + 1))[:n]
    elif case == "stale_marker":
        m = m.copy()
        m[n // 2] = ref_dec.V_STALE_NAN
    elif case == "inf":
        m = np.full(n, ref_dec.V_INF_POS)
    elif case == "nan_among_finite":
        m = m.copy()
        m[0] = ref_dec.V_NAN
    base[k] = (ts, np.asarray(m, np.int64), e)
    return base


@pytest.mark.parametrize("case", ["ts_after", "ts_before", "mantissa",
                                  "negative_mantissa", "first_delta",
                                  "second_delta", "stale_marker", "inf",
                                  "nan_among_finite"])
def test_flat_pack_overflow_returns_none_as_reference(case):
    series = _overflow_case(case)
    assert ref_dd.pack_delta_planes(series, START, np.float64) is None
    assert dd.pack_delta_planes_flat(*_flat(series), START) is None
    assert dd.pack_delta_planes(series, START) is None


def test_flat_pack_refuses_empty_input():
    assert dd.pack_delta_planes([], START) is None
    ts, m, starts, exps = _flat(_series(61, 20, 30, S=3, n_max=9))
    starts[1] = starts[2]  # series 1 holds no sample
    assert dd.pack_delta_planes_flat(ts, m, starts, exps, START) is None


@pytest.mark.parametrize("nan_series", ["all_nan", "one_nan_sample"])
def test_nan_mantissas_are_out_of_range_unlike_reference(nan_series):
    """The one intended difference from the reference's pack: its np.abs
    range test lets INT64_MIN (V_NAN, the mantissa of a plain NaN) pass,
    and it packs an all-NaN series, or a single NaN sample, as zeros; the
    port's range test refuses it, so the upload takes the dense tile."""
    series = _series(62, 20, 30, S=5, n_max=50)
    n = 30 if nan_series == "all_nan" else 1
    series[3] = (START + np.arange(n, dtype=np.int64) * 15_000,
                 np.full(n, ref_dec.V_NAN, np.int64), 0)
    want = ref_dd.pack_delta_planes(series, START, np.float64)
    assert want is not None
    assert want.val_first[3] == 0 and not want.val_d2[3].any()
    assert dd.pack_delta_planes(series, START) is None


def _store(kind, seed=70):
    """SeriesData of one kind of values, with series of 1-8 samples (the
    scalar conversion's) among longer ones: decimal counters and 3-digit
    gauges; full-precision floats; and NaN, +-Inf and staleness markers
    among finite values."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        n = int(rng.integers(1, 9)) if i % 5 == 0 else \
            int(rng.integers(9, 400))
        ts = np.sort(START + np.arange(n, dtype=np.int64) * 15_000 +
                     rng.integers(-2000, 2001, n))
        if kind == "decimal":
            v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
            if i % 2:
                v = np.round(rng.uniform(-100, 100, n), 3)
        elif kind == "full_precision":
            v = rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))
        else:
            v = np.round(rng.uniform(0, 100, n), 2)
            v[rng.random(n) < 0.1] = [np.nan, np.inf, -np.inf,
                                      ref_dec.STALE_NAN][i % 4]
        out.append(SeriesData(None, ts, v, raw_name=b"s%d" % i))
    return out


@pytest.mark.parametrize("kind", ["decimal", "full_precision", "specials"])
def test_upload_matches_the_per_series_path(kind, monkeypatch):
    """The cold upload's host half (one grouped conversion, the scalar path
    for <= 8 samples, one flat pack) against the per-series path: the
    reference's float_to_decimal and pack on each series.  Mantissas and
    exponents bit for bit; the planes field for field (None for data
    beyond int32, where both take the dense tile); the decoded tile of
    _upload_tiles equal to the reference planes' decode."""
    series = _store(kind)
    grouped, scalar = [], []
    real_g, real_s = dec.float_to_decimal_grouped, dec.float_to_decimal
    monkeypatch.setattr(dec, "float_to_decimal_grouped",
                        lambda *a: grouped.append(1) or real_g(*a))
    monkeypatch.setattr(dec, "float_to_decimal",
                        lambda v: scalar.append(v.size) or real_s(v))
    m, starts, exps = ce.decimal_columns(series)
    monkeypatch.undo()
    assert grouped == [1] and scalar and max(scalar) <= 8
    triples = []
    for i, sd in enumerate(series):
        rm, re_ = ref_dec.float_to_decimal(sd.values)
        np.testing.assert_array_equal(m[starts[i]:starts[i] + rm.size], rm)
        assert exps[i] == re_
        triples.append((sd.timestamps, rm, re_))
    want = ref_dd.pack_delta_planes(triples, START, np.float64)
    got = ce.host_planes(series, START)
    assert (got is None) == (want is None) == (kind != "decimal")
    cfg = RollupConfig(START, START + 3_600_000, 60_000, 300_000)
    ts_t, v_t, counts = ce._upload_tiles(ce.CUDAEngine(device="cpu"), series,
                                         cfg)
    if want is None:
        ts_w, v_w, c_w = pack_series(
            [(sd.timestamps, sd.values) for sd in series], START,
            n_pad=tile_capacity(max(sd.timestamps.size for sd in series)))
        ts_w, v_w = torch.from_numpy(ts_w), torch.from_numpy(v_w)
    else:
        n_cap = tile_capacity(int(want.counts.max()))
        _assert_planes_equal(got, want, n_cap - 2)
        pad = ((0, 0), (0, n_cap - 2 - want.ts_d2.shape[1]))
        want.ts_d2 = np.pad(want.ts_d2, pad)
        want.val_d2 = np.pad(want.val_d2, pad)
        ts_w, v_w = dd.decode_tiles(
            *convert.planes_from_reference(want, "cpu"), n_cap)
    np.testing.assert_array_equal(ts_t.numpy(), ts_w.numpy())
    np.testing.assert_array_equal(v_t.numpy().view(np.uint64),
                                  v_w.numpy().view(np.uint64))
    np.testing.assert_array_equal(
        counts.numpy(), [sd.timestamps.size for sd in series])


def _nan_store():
    """Eight finite counters, an all-NaN series and a one-sample NaN
    series, over the last 30 minutes before START + 30 min."""
    rng = np.random.default_rng(80)
    out = []
    for i in range(10):
        n = 1 if i == 9 else 120
        ts = np.sort(START + np.arange(n, dtype=np.int64) * 15_000 +
                     rng.integers(-2000, 2001, n))
        if i == 9:
            ts = np.array([START + 900_000])
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        if i >= 8:
            v[:] = np.nan
        out.append(SeriesData(None, ts, v, raw_name=b"n%d" % i))
    return out


NAN_CFG = RollupConfig(START + 600_000, START + 1_800_000, 60_000, 300_000)


def _oracle_rows(func, series):
    cfg = RefConfig(NAN_CFG.start, NAN_CFG.end, NAN_CFG.step, NAN_CFG.window)
    return np.array([ref_rollup(func, sd.timestamps, sd.values, cfg)
                     for sd in series])


@pytest.mark.parametrize("func", ["max_over_time", "rate"])
def test_nan_series_roll_up_as_the_oracle(func):
    """An all-NaN series and a single NaN sample answer NaN through the
    port's cold query, as the reference's numpy oracle does (the
    reference's pack turned them into zeros, and its tpu_engine answers
    0 for them)."""
    series = _nan_store()
    eng = ce.CUDAEngine(device="cpu", min_series=4)
    got = np.array(ce.try_rollup(eng, func, series, NAN_CFG, ()))
    want = _oracle_rows(func, series)
    assert np.isnan(want[8:]).all() and np.isnan(got[8:]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("aggr", ["count", "sum"])
def test_nan_series_aggregate_as_the_oracle(aggr):
    series = _nan_store()
    gids = np.array([0, 1, 2, 0, 1, 2, 0, 1, 0, 2], np.int32)
    eng = ce.CUDAEngine(device="cpu", min_series=4)
    got = ce.try_aggr_rollup(eng, aggr, "rate", series, gids, 3, NAN_CFG)
    rows = _oracle_rows("rate", series)
    live = ~np.isnan(rows)
    want = np.full((3, rows.shape[1]), np.nan)
    for g in range(3):
        n = live[gids == g].sum(axis=0)
        val = n if aggr == "count" else \
            np.where(live, rows, 0.0)[gids == g].sum(axis=0)
        want[g] = np.where(n > 0, val, np.nan)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
