"""Adaptive int64-array block encoding (reference lib/encoding/encoding.go);
the port's own copy of ``victoriametrics_tpu/ops/encoding.py``.

Pipeline (reference encoding.go:119-170, re-designed around NumPy bulk ops):
int64 array -> pick MarshalType:

  CONST        all values equal                       (encoding.go:82-117 analog)
  DELTA_CONST  arithmetic progression (counters with fixed scrape interval)
  NEAREST_DELTA   gauge-like series: lossy first-order deltas
  NEAREST_DELTA2  counter-like series: lossy second-order deltas

then varint-pack the deltas and zstd them only when the payload is >= 128
bytes and compression saves >= 1/8 of the size (encoding.go:15,136-170).

Timestamps use the same path with precision_bits=64 (lossless); adaptive
choice almost always lands on DELTA_CONST or NEAREST_DELTA2 since timestamps
are near-arithmetic.

The (marshal_type, first_value) pair lives in the block header, not the
payload, mirroring the reference's blockHeader layout.
"""

from __future__ import annotations

import enum

import numpy as np

from . import compress as zstd
from .nearest_delta import (nearest_delta2_decode, nearest_delta2_encode,
                            nearest_delta_decode, nearest_delta_encode)
from .varint import marshal_varint64s, unmarshal_varint64s

from .. import native as _native

#: whether the native codec (native/codec.cpp) serves the lossless delta
#: codecs: None until the first marshal or unmarshal asks, which builds
#: the library (importing this module builds nothing); False without one
_HAVE_NATIVE = None


def _use_native() -> bool:
    global _HAVE_NATIVE
    if _HAVE_NATIVE is None:
        # benign double-probe: racers compute the same verdict
        _HAVE_NATIVE = _native.available()  # vmt: disable=VMT015
    return _HAVE_NATIVE


class MarshalType(enum.IntEnum):
    CONST = 1
    DELTA_CONST = 2
    NEAREST_DELTA = 3
    NEAREST_DELTA2 = 4
    ZSTD_NEAREST_DELTA = 5
    ZSTD_NEAREST_DELTA2 = 6

    @property
    def needs_validation(self) -> bool:
        # Uncompressed lossy encodings carry no zstd checksum; decoded
        # timestamp sequences must be re-validated (encoding.go:46-57 analog).
        return self in (MarshalType.NEAREST_DELTA, MarshalType.NEAREST_DELTA2)


MIN_COMPRESSIBLE_BLOCK_SIZE = 128  # bytes; below this zstd never pays off
_MIN_COMPRESS_RATIO = 8 / 7        # require >= 12.5% shrink


def is_const(values: np.ndarray) -> bool:
    v = np.asarray(values)
    return v.size > 0 and bool((v == v[0]).all())


def is_delta_const(values: np.ndarray) -> bool:
    v = np.asarray(values, dtype=np.int64)
    if v.size < 2:
        return False
    d = v[1:] - v[:-1]
    return bool((d == d[0]).all())


def is_gauge(values: np.ndarray) -> bool:
    """Heuristic: counters are (mostly) non-decreasing; a series with more
    than 1/8 negative deltas is treated as a gauge (first-order deltas)."""
    v = np.asarray(values, dtype=np.int64)
    if v.size < 2:
        return False
    neg = int((v[1:] < v[:-1]).sum())
    return neg * 8 > v.size


def _maybe_compress(data: bytes, plain_type: MarshalType,
                    zstd_type: MarshalType) -> tuple[bytes, MarshalType]:
    if len(data) < MIN_COMPRESSIBLE_BLOCK_SIZE:
        return data, plain_type
    packed = zstd.compress(data)
    if len(packed) * _MIN_COMPRESS_RATIO < len(data):
        return packed, zstd_type
    return data, plain_type


def marshal_int64_array(values: np.ndarray, precision_bits: int = 64
                        ) -> tuple[bytes, MarshalType, int]:
    """Returns (payload, marshal_type, first_value)."""
    v = np.asarray(values, dtype=np.int64)
    if v.size == 0:
        raise ValueError("marshal_int64_array: empty input")
    if is_const(v):
        return b"", MarshalType.CONST, int(v[0])
    if is_delta_const(v):
        # wrapping int64 subtraction: sentinel mantissas (stale NaN / inf)
        # sit near the int64 bounds and must round-trip via two's complement
        with np.errstate(over="ignore"):
            d = int(v[1] - v[0])
        return marshal_varint64s(np.array([d], dtype=np.int64)), \
            MarshalType.DELTA_CONST, int(v[0])
    if is_gauge(v):
        if _use_native() and precision_bits >= 64:
            data, first = _native.delta_encode(v)
        else:
            first, deltas = nearest_delta_encode(v, precision_bits)
            data = marshal_varint64s(deltas)
        data, mt = _maybe_compress(data, MarshalType.NEAREST_DELTA,
                                   MarshalType.ZSTD_NEAREST_DELTA)
        return data, mt, first
    if _use_native() and precision_bits >= 64:
        d2_payload, first, first_delta = _native.delta2_encode(v)
        data = _native.varint_encode(
            np.array([first_delta], dtype=np.int64)) + d2_payload
    else:
        first, first_delta, d2 = nearest_delta2_encode(v, precision_bits)
        stream = np.empty(d2.size + 1, dtype=np.int64)
        stream[0] = first_delta
        stream[1:] = d2
        data = marshal_varint64s(stream)
    data, mt = _maybe_compress(data, MarshalType.NEAREST_DELTA2,
                               MarshalType.ZSTD_NEAREST_DELTA2)
    return data, mt, first


def unmarshal_int64_array(data: bytes, marshal_type: MarshalType,
                          first_value: int, count: int) -> np.ndarray:
    mt = MarshalType(marshal_type)
    if count <= 0:
        raise ValueError("unmarshal_int64_array: count must be positive")
    if mt == MarshalType.CONST:
        return np.full(count, first_value, dtype=np.int64)
    if mt == MarshalType.DELTA_CONST:
        d = int(unmarshal_varint64s(data, 1)[0])
        return first_value + np.arange(count, dtype=np.int64) * d
    if mt in (MarshalType.ZSTD_NEAREST_DELTA, MarshalType.ZSTD_NEAREST_DELTA2):
        data = zstd.decompress(data)
        mt = (MarshalType.NEAREST_DELTA
              if mt == MarshalType.ZSTD_NEAREST_DELTA
              else MarshalType.NEAREST_DELTA2)
    if mt == MarshalType.NEAREST_DELTA:
        if _use_native():
            return _native.delta_decode(data, first_value, count)
        deltas = unmarshal_varint64s(data, count - 1)
        return nearest_delta_decode(first_value, deltas)
    if mt == MarshalType.NEAREST_DELTA2:
        if _use_native() and count >= 2:
            # split off the leading first_delta varint, then fused decode
            i = 0
            while i < len(data) and data[i] & 0x80:
                i += 1
                if i >= 10:
                    raise ValueError("varint: too long encoded varint")
            if i >= len(data):
                raise ValueError("varint: truncated trailing value")
            fd = int(unmarshal_varint64s(data[:i + 1], 1)[0])
            return _native.delta2_decode(data[i + 1:], first_value, fd, count)
        stream = unmarshal_varint64s(data, count - 1)
        return nearest_delta2_decode(first_value, int(stream[0]), stream[1:])
    raise ValueError(f"unknown marshal type {marshal_type}")


def marshal_timestamps(timestamps: np.ndarray, precision_bits: int = 64
                       ) -> tuple[bytes, MarshalType, int]:
    """Timestamps (unix ms) use the lossless path by default
    (encoding.go:82 MarshalTimestamps analog)."""
    return marshal_int64_array(timestamps, precision_bits)


def unmarshal_timestamps(data: bytes, marshal_type: MarshalType,
                         first_value: int, count: int) -> np.ndarray:
    ts = unmarshal_int64_array(data, marshal_type, first_value, count)
    if MarshalType(marshal_type).needs_validation:
        ts = ensure_non_decreasing_sequence(ts)
    return ts


def marshal_values(values: np.ndarray, precision_bits: int = 64
                   ) -> tuple[bytes, MarshalType, int]:
    return marshal_int64_array(values, precision_bits)


unmarshal_values = unmarshal_int64_array


def ensure_non_decreasing_sequence(ts: np.ndarray) -> np.ndarray:
    """Clamp decoded timestamps to be non-decreasing (post-decode validation
    for non-checksummed lossy encodings; encoding.go:258 analog)."""
    return np.maximum.accumulate(np.asarray(ts, dtype=np.int64))
