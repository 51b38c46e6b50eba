"""Port parity: the decimal codec (victoriametrics_tpu_torch/ops/decimal.py)
against the JAX package's, on the same seeded inputs.

Mirrors tests/test_decimal.py (round trips, special values and the
staleness marker, scale calibration) and adds the grouped conversion and
the block decode: mantissas, exponents and decoded floats bit for bit."""

import numpy as np
import pytest

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu_torch.ops import decimal as dec

_RNG = np.random.default_rng(42)

VALUES = {
    "empty": np.array([], dtype=np.float64),
    "integers": np.array([0.0, 1, -1, 12345, -98765, 10, 100, 1e6,
                          123456789012345.0]),
    "common_exponent": np.array([100.0, 200.0, 300.0]),
    "decimal_fractions": np.array([0.1, 0.25, 1.5, -3.75, 123.456, 0.001,
                                   9.99]),
    "mixed_scales": np.array([1e-3, 1.0, 1e3]),
    "narrow_spread": _RNG.uniform(1.0, 100.0, 1000),
    "wide_spread": _RNG.standard_normal(1000) *
    np.exp(_RNG.uniform(-5, 5, 1000)),
    "huge_spread": np.array([1e-300, 1e300]),
    "specials": np.array([np.nan, np.inf, -np.inf, 1.0]),
    "stale": np.array([dec.STALE_NAN, np.nan, 5.0]),
    "negative_zero": np.array([-0.0, 0.0]),
    "single_3": np.array([3.0]),
    "single_0.02": np.array([0.02]),
    "single_-7e9": np.array([-7e9]),
    "single_planck": np.array([6.62607015e-34]),
    "tiny": np.array([1e-300, 2e-308]),
    "large_mantissa": np.array([0.1, 1900000000000001.0]),
    "specials_long": np.array([np.nan, dec.STALE_NAN, np.inf, -np.inf, 1.0,
                               2.0, 3.0, 4.0, 5.0, 6.0]),
    "gauge_3dp": np.round(_RNG.uniform(-1000, 1000, 300), 3),
}


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("case", sorted(VALUES))
def test_round_trip_matches_reference(case):
    v = VALUES[case]
    m, e = dec.float_to_decimal(v)
    rm, re_ = ref_dec.float_to_decimal(v)
    assert e == re_ and m.dtype == rm.dtype
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(_bits(dec.decimal_to_float(m, e)),
                                  _bits(ref_dec.decimal_to_float(rm, re_)))


def test_stale_marker_survives_bit_exact():
    m, e = dec.float_to_decimal(VALUES["stale"])
    assert m[0] == dec.V_STALE_NAN and m[1] == dec.V_NAN
    out = dec.decimal_to_float(m, e)
    assert dec.is_stale_nan(out[:1]).all()
    assert not dec.is_stale_nan(out[1:2]).any()


@pytest.mark.parametrize("exponent", [-25, -19, -18, -3, 0, 2, 300])
def test_decimal_to_float_matches_reference(exponent):
    rng = np.random.default_rng(exponent + 100)
    m = rng.integers(-10**17, 10**17, 500).astype(np.int64)
    m[::11] = 10**16 * 3  # exact quotients above 2^53
    m[1::13] = dec.V_STALE_NAN
    m[2::17] = dec.V_INF_POS
    with np.errstate(over="ignore"):  # 10^300 overflows, on both sides
        np.testing.assert_array_equal(
            _bits(dec.decimal_to_float(m, exponent)),
            _bits(ref_dec.decimal_to_float(m, exponent)))


CALIBRATE = {
    "same_exp": ([1, 2], 0, [3, 4], 0),
    "scale_down_b": ([15, 25], -1, [3, 4], 0),
    "swapped": ([3, 4], 0, [15, 25], -1),
    "specials": ([dec.V_STALE_NAN, 10], -2, [5], 0),
    "all_zero_b": ([123456], -25, [0, dec.V_STALE_NAN], 0),
    "lossy_a": ([10**16, 7], -30, [9 * 10**15], 0),
}


@pytest.mark.parametrize("case", sorted(CALIBRATE))
def test_calibrate_scale_matches_reference(case):
    a, ae, b, be = CALIBRATE[case]
    a, b = np.array(a, np.int64), np.array(b, np.int64)
    got = dec.calibrate_scale(a, ae, b, be)
    want = ref_dec.calibrate_scale(a, ae, b, be)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_calibrate_scale_keeps_values():
    rng = np.random.default_rng(7)
    av = np.round(rng.uniform(-100, 100, 50), 3)
    bv = np.round(rng.uniform(-1e6, 1e6, 50), 1)
    a2, b2, e = dec.calibrate_scale(*dec.float_to_decimal(av),
                                    *dec.float_to_decimal(bv))
    np.testing.assert_allclose(dec.decimal_to_float(a2, e), av, rtol=1e-10)
    np.testing.assert_allclose(dec.decimal_to_float(b2, e), bv, rtol=1e-10)


GROUPED = {
    "counters": lambda rng: np.cumsum(rng.integers(0, 50, 200)).astype(float),
    "gauges_3dp": lambda rng: np.round(rng.uniform(-1000, 1000, 200), 3),
    "full_precision": lambda rng: rng.standard_normal(200) *
    np.exp(rng.uniform(-20, 20, 200)),
    "specials": lambda rng: np.where(rng.random(200) < 0.2, np.nan,
                                     rng.uniform(0, 9, 200)),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
@pytest.mark.parametrize("size", [200, 3000])  # numpy, and native >= 256
def test_grouped_matches_reference_and_per_group(case, size):
    """float_to_decimal_grouped equals the reference's, and equals
    float_to_decimal on every group of more than 8 values (what the cold
    upload relies on; groups of <= 8 take the scalar path there)."""
    rng = np.random.default_rng(sorted(GROUPED).index(case))
    v = np.concatenate([GROUPED[case](rng) for _ in range(size // 200)])
    if case == "specials":
        v[::37] = dec.STALE_NAN
        v[5::41] = -np.inf
    starts = np.unique(np.concatenate(
        [[0], rng.choice(v.size, v.size // 20, replace=False)])).astype(
        np.int64)
    m, e = dec.float_to_decimal_grouped(v, starts)
    rm, re_ = ref_dec.float_to_decimal_grouped(v, starts)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(e, re_)
    ends = np.append(starts[1:], v.size)
    for i, (a, b) in enumerate(zip(starts, ends)):
        if b - a > 8:
            gm, ge = dec.float_to_decimal(v[a:b])
            np.testing.assert_array_equal(m[a:b], gm)
            assert e[i] == ge


class _InlinePool:
    """A work pool that runs its tasks in order (decimal_to_float_blocks_py
    takes any object with .run(list_of_callables))."""

    def __init__(self):
        self.batches = 0

    def run(self, fns):
        self.batches += 1
        for f in fns:
            f()


@pytest.mark.parametrize("scales", ["one", "many", "split"])
def test_decimal_to_float_blocks_py_matches_reference(scales, monkeypatch):
    rng = np.random.default_rng(5)
    cnt = rng.integers(1, 300, 30)
    goff = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    mants = rng.integers(-10**12, 10**12, int(goff[-1])).astype(np.int64)
    mants[::53] = dec.V_NAN
    sc = np.full(cnt.size, -3, np.int64) if scales == "one" else \
        rng.integers(-8, 3, cnt.size).astype(np.int64)
    pool = None
    if scales == "split":  # runs split across the pool
        monkeypatch.setattr(dec, "_BLOCKS_SPLIT_MIN", 64)
        monkeypatch.setattr(ref_dec, "_BLOCKS_SPLIT_MIN", 64)
        pool = _InlinePool()
    got = dec.decimal_to_float_blocks_py(mants, goff, sc,
                                         np.empty(mants.size), pool)
    want = ref_dec.decimal_to_float_blocks_py(mants, goff, sc,
                                              np.empty(mants.size))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if pool is not None:
        assert pool.batches == 1
