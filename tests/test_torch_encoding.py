"""Port parity: the block codecs (victoriametrics_tpu_torch/ops: varint,
nearest_delta, compress, encoding) against the JAX package's, on the same
seeded inputs.

Mirrors tests/test_encoding.py: varint round trips, nearest-delta(2),
marshal-type selection, timestamps and their validation, malformed
input.  Every marshalled payload equals the reference's byte for byte,
through both of the port's paths (the native codec and numpy), which
also agree with each other."""

import numpy as np
import pytest

from victoriametrics_tpu.ops import compress as ref_compress
from victoriametrics_tpu.ops import encoding as ref_enc
from victoriametrics_tpu.ops import nearest_delta as ref_nd
from victoriametrics_tpu.ops import varint as ref_varint
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.ops import compress
from victoriametrics_tpu_torch.ops import encoding as enc
from victoriametrics_tpu_torch.ops import nearest_delta as nd
from victoriametrics_tpu_torch.ops import varint

_RNG = np.random.default_rng(3)

VARINT = {
    "simple": np.array([0, 1, -1, 63, -64, 64, -65, 1 << 40, -(1 << 40)]),
    "extremes": np.array([(1 << 62), -(1 << 62), (1 << 63) - 1, -(1 << 63)]),
    "one_byte": np.arange(-64, 64),
    "empty": np.array([], dtype=np.int64),
    **{f"random_{n}": _RNG.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
       for n in (1, 2, 100, 8192)},
}


@pytest.mark.parametrize("case", sorted(VARINT))
def test_varint_matches_reference(case):
    v = VARINT[case].astype(np.int64)
    data = varint.marshal_varint64s(v)
    assert data == ref_varint.marshal_varint64s(v)
    np.testing.assert_array_equal(varint.unmarshal_varint64s(data), v)
    if case == "one_byte":
        assert len(data) == v.size


@pytest.mark.parametrize("x", [0, 1, 127, 128, 300, 1 << 32, (1 << 64) - 1])
def test_varuint_scalar_matches_reference(x):
    data = varint.marshal_varuint64(x)
    assert data == ref_varint.marshal_varuint64(x)
    assert varint.unmarshal_varuint64(data) == (x, len(data))


@pytest.mark.parametrize("data", [b"\x01\x81", b"\x80",
                                  b"\x81" * 10 + b"\x01"],
                         ids=["unterminated", "all_continuation", "overlong"])
def test_malformed_varint_raises(data):
    with pytest.raises(ValueError):
        varint.unmarshal_varint64s(data)


ND = {
    "random": np.random.default_rng(1).integers(-(1 << 50), 1 << 50, 1000),
    "gauge": np.cumsum(np.random.default_rng(2).integers(-1000, 1000, 500))
    + 10**9,
    "counter2": np.cumsum(np.cumsum(
        np.random.default_rng(4).integers(-5, 5, 300))),
    "linear": np.arange(0, 10000, 15),
    "sentinels": np.array([0, (1 << 63) - 1, -(1 << 63) + 5, 7,
                           -(1 << 63) + 1, 5]),
}


@pytest.mark.parametrize("case", sorted(ND))
@pytest.mark.parametrize("bits", [4, 16, 32, 64])
def test_nearest_delta_matches_reference(case, bits):
    v = ND[case].astype(np.int64)
    with np.errstate(over="ignore"):
        first, d = nd.nearest_delta_encode(v, bits)
        rfirst, rd = ref_nd.nearest_delta_encode(v, bits)
        assert first == rfirst
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(nd.nearest_delta_decode(first, d),
                                      ref_nd.nearest_delta_decode(rfirst, rd))
        got = nd.nearest_delta2_encode(v, bits)
        want = ref_nd.nearest_delta2_encode(v, bits)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        out = nd.nearest_delta2_decode(*got)
    if bits == 64 and case != "sentinels":
        np.testing.assert_array_equal(out, v)
    if case == "linear":
        assert (got[2] == 0).all()


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run a test through one of the port's two codec paths."""
    if request.param == "native" and not native.available():
        pytest.skip("no native codec (g++ missing)")
    monkeypatch.setattr(enc, "_HAVE_NATIVE", request.param == "native")
    return request.param


_R = np.random.default_rng(5)
BLOCKS = {
    "const": (np.full(100, 42), "CONST"),
    "single": (np.array([-7]), "CONST"),
    "delta_const": (np.arange(1000, 9000, 15), "DELTA_CONST"),
    "counter": (np.cumsum(_R.integers(0, 100, 500)), "NEAREST_DELTA2"),
    "gauge": (_R.integers(-1000, 1000, 500), "NEAREST_DELTA"),
    "compressible": (np.cumsum(np.tile([1, 2, 3, 4], 2048)), "ZSTD"),
    "tiny": (np.array([1, 5, 2, 9, 3]), "PLAIN"),
    "sentinel_delta_const": (np.array([-(1 << 63) + 1, (1 << 63) - 1]),
                             "DELTA_CONST"),
    "scrape_ts": (np.arange(0, 8192 * 15000, 15000) + 1700000000000,
                  "DELTA_CONST"),
    "jittered_ts": (np.arange(4096) * 15000 + 1700000000000 +
                    _R.integers(-50, 50, 4096), None),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
@pytest.mark.parametrize("bits", [64, 20])
def test_marshal_matches_reference(case, bits, path):
    v, kind = BLOCKS[case]
    v = v.astype(np.int64)
    data, mt, first = enc.marshal_int64_array(v, bits)
    rdata, rmt, rfirst = ref_enc.marshal_int64_array(v, bits)
    assert (data, int(mt), first) == (rdata, int(rmt), rfirst)
    if kind in ("CONST", "DELTA_CONST", "NEAREST_DELTA2", "NEAREST_DELTA"):
        assert mt.name.endswith(kind)
    elif kind == "ZSTD":
        assert mt.name.startswith("ZSTD_")
    elif kind == "PLAIN":
        assert not mt.name.startswith("ZSTD_")
    out = enc.unmarshal_int64_array(data, mt, first, v.size)
    np.testing.assert_array_equal(
        out, ref_enc.unmarshal_int64_array(data, mt, first, v.size))
    if bits == 64:
        np.testing.assert_array_equal(out, v)


@pytest.mark.parametrize("case", ["counter", "gauge", "jittered_ts",
                                  "scrape_ts", "compressible"])
def test_native_and_numpy_paths_agree(case, monkeypatch):
    """marshal_int64_array / marshal_timestamps / marshal_values through
    the native codec and through numpy: the same bytes, and each path
    decodes the other's blocks."""
    if not native.available():
        pytest.skip("no native codec (g++ missing)")
    v = BLOCKS[case][0].astype(np.int64)
    runs = {}
    for use in (True, False):
        monkeypatch.setattr(enc, "_HAVE_NATIVE", use)
        runs[use] = [f(v) for f in (enc.marshal_int64_array,
                                    enc.marshal_timestamps,
                                    enc.marshal_values)]
    assert runs[True] == runs[False]
    data, mt, first = runs[True][1]
    for use in (True, False):
        monkeypatch.setattr(enc, "_HAVE_NATIVE", use)
        np.testing.assert_array_equal(
            enc.unmarshal_timestamps(data, mt, first, v.size),
            ref_enc.unmarshal_timestamps(data, mt, first, v.size))
        np.testing.assert_array_equal(
            enc.unmarshal_values(data, mt, first, v.size), v)


def test_encoding_probes_the_native_codec_lazily(monkeypatch):
    monkeypatch.setattr(enc, "_HAVE_NATIVE", None)
    asked = []
    monkeypatch.setattr(native, "available", lambda: asked.append(1) or False)
    v = BLOCKS["counter"][0].astype(np.int64)
    assert enc.marshal_int64_array(v) == ref_enc.marshal_int64_array(v)
    assert asked == [1] and enc._HAVE_NATIVE is False


def test_empty_and_bad_counts_raise():
    with pytest.raises(ValueError):
        enc.marshal_int64_array(np.array([], dtype=np.int64))
    with pytest.raises(ValueError):
        enc.unmarshal_int64_array(b"", enc.MarshalType.CONST, 0, 0)


def test_validation_clamps():
    out = enc.ensure_non_decreasing_sequence(
        np.array([1, 5, 3, 7, 6], dtype=np.int64))
    np.testing.assert_array_equal(out, [1, 5, 5, 7, 7])
    # an unchecksummed lossy block of decreasing timestamps is clamped
    d = ref_varint.marshal_varint64s(np.array([20, -10, 20], np.int64))
    got = enc.unmarshal_timestamps(d, enc.MarshalType.NEAREST_DELTA, 10, 4)
    np.testing.assert_array_equal(got, [10, 30, 30, 40])


@pytest.mark.parametrize("size", [0, 100, 50_000])
def test_compress_matches_reference(size):
    data = np.cumsum(np.arange(size) % 11).astype(np.int64).tobytes()
    packed = compress.compress(data)
    assert packed == ref_compress.compress(data)
    assert compress.decompress(packed) == data
    assert ref_compress.decompress(packed) == data
    assert compress.zstd_available() == ref_compress.zstd_available()


def test_compress_reads_zlib_frames_and_bounds_them():
    import zlib
    data = bytes(range(256)) * 64
    assert compress.decompress(zlib.compress(data, 1)) == data
    with pytest.raises(ValueError):
        compress.decompress(zlib.compress(data, 1), max_size=100)
