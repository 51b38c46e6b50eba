"""zstd block compression (reference lib/encoding/compress.go:13-38 and
lib/encoding/zstd — the reference's single cgo/native dependency); the
port's own copy of ``victoriametrics_tpu/ops/compress.py``.

Uses the CPython `zstandard` package (libzstd-backed). Level 1 by default:
block payloads are small (<64KB) and this host has few cores, so speed wins;
the reference reaches the same trade-off via its cgo fast path.

(De)compressor objects are NOT thread-safe for concurrent use, so they are
kept thread-local — the storage engine decompresses from query threads while
flusher threads compress.

Gated dependency: when the `zstandard` package is absent (minimal dev
containers), `compress` first tries the native codec library's dlopen'd
libzstd.so.1 (victoriametrics_tpu_torch/native — one-shot, thread-safe,
allocation-bounded) and only then falls back to stdlib zlib, so minimal
containers with just the runtime library still write real zstd frames.
`decompress` sniffs the frame magic and accepts BOTH encodings regardless
of which codec produced the part, so data written by any build reads back
on any build; only zstd-compressed data on a host with no libzstd binding
at all fails, and it fails loudly.
"""

from __future__ import annotations

import threading
import zlib

try:
    import zstandard
except ImportError:  # minimal container: stdlib fallback, see docstring
    zstandard = None

DEFAULT_LEVEL = 1

_native_zstd = None  # tri-state: None = unprobed, False = unavailable


def _native():
    """The native module's dlopen'd zstd one-shots, probed once; False
    when the library is missing or libzstd.so.1 did not resolve."""
    global _native_zstd
    if _native_zstd is None:
        try:
            from .. import native
            # benign double-probe: both racers compute the same verdict
            # from the same module state
            _native_zstd = native if native.has_zstd() else False  # vmt: disable=VMT015
        except Exception:
            _native_zstd = False
    return _native_zstd

#: every zstd frame starts with this magic (RFC 8878); zlib streams start
#: with 0x78 — disjoint, so decompress can sniff the producer
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_tls = threading.local()


def zstd_available() -> bool:
    """True when compress() produces zstd frames (python binding or the
    native dlopen'd runtime library)."""
    return zstandard is not None or bool(_native())


def _compressor(level: int):
    cs = getattr(_tls, "compressors", None)
    if cs is None:
        cs = _tls.compressors = {}
    c = cs.get(level)
    if c is None:
        c = cs[level] = zstandard.ZstdCompressor(level=level)
    return c


def _decompressor():
    d = getattr(_tls, "decompressor", None)
    if d is None:
        d = _tls.decompressor = zstandard.ZstdDecompressor()
    return d


def compress(data: bytes, level: int = DEFAULT_LEVEL) -> bytes:
    if zstandard is None:
        nat = _native()
        if nat:
            out = nat.zstd_compress(data, level)
            if out is not None:
                return out
        return zlib.compress(data, level)
    return _compressor(level).compress(data)


def decompress(data: bytes, max_size: int = 1 << 30) -> bytes:
    if data.startswith(_ZSTD_MAGIC):
        if zstandard is None:
            nat = _native()
            if nat:
                out = nat.zstd_decompress(data, max_size=max_size)
                if out is not None:
                    return out
            raise RuntimeError(
                "cannot decompress zstd data: neither the 'zstandard' "
                "package nor a runtime libzstd is available in this build")
        return _decompressor().decompress(data, max_output_size=max_size)
    # bounded like the zstd path's max_output_size: cap BEFORE the whole
    # stream materializes, so a hostile/corrupt frame (zlib bomb over an
    # RPC boundary) cannot balloon memory
    d = zlib.decompressobj()
    out = d.decompress(data, max_size + 1)
    if len(out) > max_size:
        raise ValueError(f"decompressed size exceeds {max_size}")
    return out + d.flush()
