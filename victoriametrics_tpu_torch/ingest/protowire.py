"""Minimal protobuf wire-format reader/writer (the easyproto analog —
reference vendors VictoriaMetrics/easyproto for alloc-free proto handling;
we hand-roll the same subset: varint, fixed64, length-delimited).

The port's copy of ``victoriametrics_tpu/ingest/protowire.py``, whole.
"""

from __future__ import annotations

import struct


def read_varint(data: bytes, i: int) -> tuple[int, int]:
    x = 0
    shift = 0
    while True:
        if i >= len(data):
            raise ValueError("proto: truncated varint")
        b = data[i]
        i += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, i
        shift += 7
        if shift > 70:
            raise ValueError("proto: varint too long")


def iter_fields(data: bytes, start: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value, next_i). value is int for
    varint/fixed, bytes for length-delimited."""
    i = start
    end = len(data) if end is None else end
    while i < end:
        key, i = read_varint(data, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, i = read_varint(data, i)
            yield fnum, wt, v
        elif wt == 1:
            if i + 8 > end:
                raise ValueError("proto: truncated fixed64")
            v = struct.unpack_from("<Q", data, i)[0]
            i += 8
            yield fnum, wt, v
        elif wt == 2:
            ln, i = read_varint(data, i)
            if i + ln > end:
                raise ValueError("proto: truncated bytes field")
            yield fnum, wt, data[i:i + ln]
            i += ln
        elif wt == 5:
            if i + 4 > end:
                raise ValueError("proto: truncated fixed32")
            v = struct.unpack_from("<I", data, i)[0]
            i += 4
            yield fnum, wt, v
        else:
            raise ValueError(f"proto: unsupported wire type {wt}")


def zigzag64(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def as_double(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def as_signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# -- writer ------------------------------------------------------------------

def w_varint(out: bytearray, x: int):
    if x < 0:
        x += 1 << 64
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def w_tag(out: bytearray, fnum: int, wt: int):
    w_varint(out, (fnum << 3) | wt)


def w_bytes(out: bytearray, fnum: int, data: bytes):
    w_tag(out, fnum, 2)
    w_varint(out, len(data))
    out += data


def w_double(out: bytearray, fnum: int, v: float):
    w_tag(out, fnum, 1)
    out += struct.pack("<d", v)


def w_int64(out: bytearray, fnum: int, v: int):
    w_tag(out, fnum, 0)
    w_varint(out, v)
