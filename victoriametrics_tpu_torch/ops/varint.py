"""Bulk zigzag-varint codecs, fully vectorized in NumPy.

The port's own copy of ``victoriametrics_tpu/ops/varint.py`` (reference
lib/encoding/int.go:107-470, MarshalVarInt64s / UnmarshalVarInt64s bulk
fast paths). The reference
hand-unrolls byte loops in Go; here both directions are expressed as dense
array ops (the encode builds an (n, 10) byte matrix and compacts it; the
decode reconstructs values with bitwise_or.reduceat over continuation-bit
groups), which is also the shape a device kernel of the same codec would take.
"""

from __future__ import annotations

import numpy as np


def bit_len_u64(u: np.ndarray) -> np.ndarray:
    """floor(log2(u))+1 for u>0, 0 for u==0 — without float round-off.
    Shared by the varint and nearest-delta codecs."""
    u = np.asarray(u, dtype=np.uint64)
    n = np.zeros(u.shape, dtype=np.int64)
    tmp = u.copy()
    for b in (32, 16, 8, 4, 2, 1):
        mask = tmp >= (np.uint64(1) << np.uint64(b))
        n = np.where(mask, n + b, n)
        tmp = np.where(mask, tmp >> np.uint64(b), tmp)
    return np.where(u == 0, 0, n + 1)


def zigzag_encode(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    return ((x << np.int64(1)) ^ (x >> np.int64(63))).view(np.uint64)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, dtype=np.uint64)
    return ((u >> np.uint64(1)).view(np.int64)) ^ (-(u & np.uint64(1)).view(np.int64))


def marshal_varint64s(values: np.ndarray) -> bytes:
    """Encode int64 array as concatenated zigzag varints."""
    u = zigzag_encode(values)
    n = u.size
    if n == 0:
        return b""
    # Byte i of value v is (v >> 7i) & 0x7f, with the continuation bit set on
    # all but the last byte. Number of bytes = ceil(bitlen/7), min 1.
    shifts = (np.arange(10, dtype=np.uint64) * np.uint64(7))
    chunks = (u[:, None] >> shifts[None, :]) & np.uint64(0x7F)
    nbytes = np.maximum((bit_len_u64(u) + 6) // 7, 1)
    pos = np.arange(10)
    valid = pos[None, :] < nbytes[:, None]
    last = pos[None, :] == (nbytes - 1)[:, None]
    out = chunks | np.where(valid & ~last, np.uint64(0x80), np.uint64(0))
    return out[valid].astype(np.uint8).tobytes()


def unmarshal_varint64s(data: bytes, count: int | None = None) -> np.ndarray:
    """Decode concatenated zigzag varints into an int64 array."""
    b = np.frombuffer(data, dtype=np.uint8)
    if b.size == 0:
        return np.zeros(0, dtype=np.int64)
    cont = (b & 0x80) != 0
    if cont[-1]:
        # Unterminated trailing varint: without this check its bytes would be
        # silently OR-folded into the previous value.
        raise ValueError("varint: truncated trailing value")
    ends = np.flatnonzero(~cont)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    if ((ends - starts) >= 10).any():
        # int64 varints are at most 10 bytes; longer means corruption, and
        # uint64 shifts >= 64 would otherwise decode silently to garbage.
        raise ValueError("varint: too long encoded varint")
    # position of each byte within its value
    idx = np.arange(b.size, dtype=np.int64)
    start_per_byte = np.repeat(starts, ends - starts + 1)
    pos = idx - start_per_byte
    contrib = (b.astype(np.uint64) & np.uint64(0x7F)) << (pos.astype(np.uint64) * np.uint64(7))
    u = np.bitwise_or.reduceat(contrib, starts)
    vals = zigzag_decode(u)
    if count is not None and vals.size != count:
        raise ValueError(f"varint: expected {count} values, got {vals.size}")
    return vals


def marshal_varuint64(x: int) -> bytes:
    """Single unsigned varint (headers/metadata)."""
    out = bytearray()
    x = int(x)
    if x < 0:
        raise ValueError("negative varuint")
    while True:
        bb = x & 0x7F
        x >>= 7
        if x:
            out.append(bb | 0x80)
        else:
            out.append(bb)
            return bytes(out)


def unmarshal_varuint64(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode one unsigned varint; returns (value, next_offset)."""
    x = 0
    shift = 0
    i = offset
    while True:
        if i >= len(data):
            raise ValueError("varuint: truncated")
        bb = data[i]
        i += 1
        x |= (bb & 0x7F) << shift
        if not bb & 0x80:
            return x, i
        shift += 7
        if shift > 70:
            raise ValueError("varuint: too long")
