"""Port parity: the host decimal codec and nearest-delta2 plane packing,
and the K1 decode (its plain PyTorch version on the CPU) against the JAX
package.  Everything here is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.ops import device_decode as ref_dd
from victoriametrics_tpu.query.tpu_engine import tile_capacity as ref_capacity
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import decimal as dec
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.query.cuda_engine import tile_capacity

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
