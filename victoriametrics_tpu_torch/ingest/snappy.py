"""Snappy block codec via the system libsnappy C API (ctypes), with a
pure-Python decoder fallback. Prometheus remote-write bodies are
snappy-block-compressed protobufs (reference lib/protoparser/
promremotewrite handles the same two codecs: snappy and zstd).

The port's copy of ``victoriametrics_tpu/ingest/snappy.py``, whole.
"""

from __future__ import annotations

import ctypes
import struct

_lib = None
try:
    _lib = ctypes.CDLL("libsnappy.so.1")
    _lib.snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t)]
    _lib.snappy_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t)]
    _lib.snappy_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    _lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
    _lib.snappy_max_compressed_length.restype = ctypes.c_size_t
except OSError:  # pragma: no cover
    _lib = None


def compress(data: bytes) -> bytes:
    if _lib is not None:
        n = _lib.snappy_max_compressed_length(len(data))
        out = ctypes.create_string_buffer(n)
        out_len = ctypes.c_size_t(n)
        rc = _lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"snappy_compress failed: {rc}")
        return out.raw[:out_len.value]
    return _py_compress(data)


def decompress(data: bytes) -> bytes:
    if _lib is not None:
        n = ctypes.c_size_t(0)
        if _lib.snappy_uncompressed_length(data, len(data), ctypes.byref(n)) != 0:
            raise ValueError("snappy: bad header")
        if n.value > 1 << 31:
            raise ValueError("snappy: unreasonable uncompressed length")
        out = ctypes.create_string_buffer(n.value or 1)
        out_len = ctypes.c_size_t(n.value)
        rc = _lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"snappy_uncompress failed: {rc}")
        return out.raw[:out_len.value]
    return _py_decompress(data)


# -- pure-python fallback (spec: github.com/google/snappy format docs) -------

def _py_compress(data: bytes) -> bytes:
    # all-literal encoding: valid snappy, just not compressed
    out = bytearray()
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    i = 0
    while i < len(data):
        chunk = data[i:i + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append((ln << 2) | 0)
        else:
            out.append((60 << 2) | 0)
            out.append(ln & 0xFF)
            out.append((ln >> 8) & 0xFF)
            out[-3] = (61 << 2) | 0
        out += chunk
        i += 65536
    return bytes(out)


def _py_decompress(data: bytes) -> bytes:
    # decode uncompressed length varint
    n = 0
    shift = 0
    i = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while i < len(data):
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(data[i:i + extra], "little")
                i += extra
            ln += 1
            out += data[i:i + ln]
            i += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[i]
                i += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[i:i + 2], "little")
                i += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[i:i + 4], "little")
                i += 4
            if off == 0 or off > len(out):
                raise ValueError("snappy: bad copy offset")
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != n:
        raise ValueError("snappy: length mismatch")
    return bytes(out)
