"""ctypes bindings for the native host codec and ingest kernels.

The port's own copy of ``victoriametrics_tpu/native``: ``codec.cpp``
(varint and delta(2) codecs, the batched block marshal, the zstd
one-shots, the storage read kernels (block decode, part assembly, dedup,
mantissa -> float64), the grouped float -> decimal of the cold upload, the
counter/rollup host kernels, and xxh64/xxh32, the storage's series hashes
in place of the ``xxhash`` package), ``parse.cpp`` (the Prometheus text
line scanner) and ``ingest.cpp`` (the snappy block decoder, the
remote-write and Influx parsers into columnar rows, and the raw-key ->
dense-id map of the storage's columnar ingest).

The three sources are compiled by g++ on first use, never at import, into
one ``victoriametrics_tpu_torch/_build/libvmcodec-<digest>.so``, the
digest taken over every source, the flags and this CPU
(``-march=native``), so a build from another machine, or from older
sources, is not loaded.  Concurrent first users (test workers) build
under a file lock into a temporary name that is renamed into place.
Where no compiler is found or the build fails, ``_load()`` returns None
and callers keep their numpy and Python paths (the reference's
cgo-zstd-with-pure-Go-fallback split, lib/encoding/zstd/zstd_{cgo,pure}.go);
xxh64 and xxh32 have no numpy path and raise RuntimeError there.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
#: the library's sources, compiled together into one shared object
SOURCES = (_DIR / "codec.cpp", _DIR / "parse.cpp", _DIR / "ingest.cpp")
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib = None
_tried = False
_lock = threading.Lock()


def _cpu_tag() -> bytes:
    """What ``-march=native`` compiles for: this CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        return platform.machine().encode()
    return b"\n".join(sorted({ln for ln in lines
                               if ln.startswith((b"model name", b"flags"))}))


def library_path() -> Path:
    """Where the build of these sources, flags and CPU lives: a change to
    any source names another library."""
    h = hashlib.blake2b(digest_size=8)
    for src in SOURCES:
        data = src.read_bytes()
        h.update(b"%s %d\n" % (src.name.encode(), len(data)))
        h.update(data)
    h.update(" ".join(CXX_FLAGS).encode() + _cpu_tag())
    return BUILD_DIR / f"libvmcodec-{h.hexdigest()}.so"


def _zstd_links(cxx: str) -> bool:
    """Whether zstd.h compiles and -lzstd links (the reference Makefile's
    HAVE_ZSTD probe); without them codec.cpp dlopens libzstd at run time."""
    r = subprocess.run([cxx, "-x", "c++", "-", "-lzstd", "-o", os.devnull],
                       input=b"#include <zstd.h>\nint main(){return 0;}\n",
                       capture_output=True, timeout=120)
    return r.returncode == 0


def build() -> Path:
    """Compile the sources into ``_build/`` unless built; returns the
    library's path.  Raises FileNotFoundError without a compiler and
    RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native library cannot "
                                "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libvmcodec.lock", "wb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        zstd = _zstd_links(cxx)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *(["-DVM_HAVE_ZSTD=1"] if zstd else []),
               "-o", str(tmp), *map(str, SOURCES),
               *(["-lzstd"] if zstd else []),
               "-ldl"]
        r = subprocess.run(cmd, capture_output=True, timeout=600)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ of the native sources failed "
                               f"({r.returncode}):\n"
                               + r.stdout.decode(errors="replace")
                               + r.stderr.decode(errors="replace"))
        os.replace(tmp, out)
    return out


def _load():
    """The configured library, built on the first call; None where it
    cannot be built or loaded (asked once a process)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            # double-checked: _lib is set before _tried, so the
            # lock-free read above sees either _tried False (and waits
            # here) or the finished verdict
            try:
                _lib = _configure(ctypes.CDLL(str(build())))  # vmt: disable=VMT015
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError):
                _lib = None
            _tried = True  # vmt: disable=VMT015
    return _lib


def _configure(lib):
    i64 = ctypes.c_int64
    p8 = ctypes.POINTER(ctypes.c_uint8)
    pi64 = ctypes.POINTER(i64)
    lib.vm_varint_encode.restype = i64
    lib.vm_varint_encode.argtypes = [pi64, i64, p8]
    lib.vm_varint_decode.restype = i64
    lib.vm_varint_decode.argtypes = [p8, i64, pi64, i64]
    lib.vm_delta2_encode.restype = i64
    lib.vm_delta2_encode.argtypes = [pi64, i64, p8, pi64, pi64]
    lib.vm_delta2_decode.restype = i64
    lib.vm_delta2_decode.argtypes = [p8, i64, i64, i64, pi64, i64]
    lib.vm_delta_encode.restype = i64
    lib.vm_delta_encode.argtypes = [pi64, i64, p8, pi64]
    lib.vm_delta_decode.restype = i64
    lib.vm_delta_decode.argtypes = [p8, i64, i64, pi64, i64]
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pf64 = ctypes.POINTER(ctypes.c_double)
    lib.vm_parse_prom.restype = i64
    lib.vm_parse_prom.argtypes = [ctypes.c_char_p, i64, pi32, pi32,
                                  pf64, pi64, i64]
    lib.vm_marshal_i64_many.restype = i64
    lib.vm_marshal_i64_many.argtypes = [pi64, pi64, i64, p8, i64,
                                        pi32, pi64, pi64]
    lib.vm_has_zstd.restype = ctypes.c_int32
    lib.vm_has_zstd.argtypes = []
    lib.vm_decompress_caps.restype = ctypes.c_int32
    lib.vm_decompress_caps.argtypes = []
    lib.vm_zstd_compress_bound.restype = i64
    lib.vm_zstd_compress_bound.argtypes = [i64]
    lib.vm_zstd_compress.restype = i64
    lib.vm_zstd_compress.argtypes = [p8, i64, p8, i64, ctypes.c_int32]
    lib.vm_zstd_content_size.restype = i64
    lib.vm_zstd_content_size.argtypes = [p8, i64]
    lib.vm_zstd_decompress.restype = i64
    lib.vm_zstd_decompress.argtypes = [p8, i64, p8, i64]
    lib.vm_assemble_part.restype = i64
    lib.vm_assemble_part.argtypes = [p8, p8, pi64, pi64, pi32, pi64,
                                     pi64, pi64, pi32, pi64, pi64, pi64,
                                     i64, i64, i64, pi64, pf64, pi64]
    lib.vm_dedup_rows.restype = None
    lib.vm_dedup_rows.argtypes = [pi64, i64, pf64, i64, pi64, pi64, i64,
                                  i64, i64]
    lib.vm_decode_blocks.restype = i64
    lib.vm_decode_blocks.argtypes = [p8, pi64, pi64, pi32, pi64, pi64,
                                     i64, pi64, ctypes.c_int32]
    lib.vm_decimal_to_float_blocks.restype = None
    lib.vm_decimal_to_float_blocks.argtypes = [pi64, pi64, pi64, i64, pf64]
    lib.vm_clip_blocks.restype = None
    lib.vm_clip_blocks.argtypes = [pi64, pi64, pi64, i64, i64, i64,
                                   pi64, pi64]
    lib.vm_gather_rows2.restype = None
    lib.vm_gather_rows2.argtypes = [pi64, pi64, pi64, pi64, i64, pi64, pi64]
    lib.vm_scatter_pad.restype = None
    lib.vm_scatter_pad.argtypes = [pi64, pf64, pi64, pi64, i64, i64, i64,
                                   i64, pi64, pf64, pi64]
    lib.vm_counter_resets_2d.restype = None
    lib.vm_counter_resets_2d.argtypes = [pf64, i64, i64, pf64]
    lib.vm_f2d_grouped.restype = None
    lib.vm_f2d_grouped.argtypes = [pf64, pi64, i64, i64, pi64, pi64]
    lib.vm_rollup_counter_2d.restype = None
    lib.vm_rollup_counter_2d.argtypes = [pi64, pf64, pi64, i64, i64, i64,
                                         i64, i64, i64, pi64,
                                         ctypes.c_int32, pf64, pf64]
    lib.vm_snappy_uncompressed_len.restype = i64
    lib.vm_snappy_uncompressed_len.argtypes = [p8, i64]
    lib.vm_snappy_uncompress.restype = i64
    lib.vm_snappy_uncompress.argtypes = [p8, i64, p8, i64]
    lib.vm_parse_rw.restype = i64
    lib.vm_parse_rw.argtypes = [p8, i64, i64, p8, i64, pi64, pi64,
                                pf64, pi64, i64]
    lib.vm_parse_influx.restype = i64
    lib.vm_parse_influx.argtypes = [p8, i64, p8, i64, i64, p8, i64,
                                    pi64, pi64, pf64, pi64, i64]
    lib.vm_keymap_new.restype = i64
    lib.vm_keymap_new.argtypes = []
    lib.vm_keymap_free.restype = None
    lib.vm_keymap_free.argtypes = [i64]
    lib.vm_keymap_size.restype = i64
    lib.vm_keymap_size.argtypes = [i64]
    lib.vm_keymap_resolve.restype = i64
    lib.vm_keymap_resolve.argtypes = [i64, p8, pi64, pi64, i64, pi64]
    # the hashes through a handle that keeps the GIL: a key's hash takes
    # well under a microsecond, and releasing and retaking the GIL around
    # it costs tens of microseconds a call when threads contend (a
    # router's writers placing every series)
    held = ctypes.PyDLL(lib._name)
    for name, ret in (("vm_xxh64", ctypes.c_uint64),
                      ("vm_xxh32", ctypes.c_uint32)):
        for handle in (lib, held):
            fn = getattr(handle, name)
            fn.restype = ret
            fn.argtypes = [ctypes.c_void_p, i64, ret]
    lib.held_xxh64, lib.held_xxh32 = held.vm_xxh64, held.vm_xxh32
    return lib


def available() -> bool:
    return _load() is not None


def assemble_enabled() -> bool:
    """Whether the fused native read kernel (vm_assemble_part) serves
    queries. ``VM_NATIVE_ASSEMBLE=0`` is the escape hatch AND the
    correctness oracle: it restores the split Python-orchestrated
    collect/decode/assemble path exactly. Re-read per call, like
    VM_SEARCH_WORKERS, so tests can flip modes without restarting."""
    return os.environ.get("VM_NATIVE_ASSEMBLE", "1") != "0" and available()


def _required():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native codec (codec.cpp) could not be built "
                           "or loaded: the storage's series hashes need it")
    return lib


def _hash_args(data):
    """(pointer, length, keep-alive) for bytes-like input: bytes, a
    bytearray, a memoryview or a numpy array (hashed as its C-order
    bytes)."""
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data)
        return a.ctypes.data, a.nbytes, a
    if not isinstance(data, bytes):
        data = bytes(data)
    return data, len(data), data


def xxh64(data, seed: int = 0) -> int:
    """XXH64 digest of `data` as an unsigned int: the value of
    ``xxhash.xxh64_intdigest(data, seed)``."""
    ptr, n, _keep = _hash_args(data)  # _keep holds the buffer
    return int(_required().held_xxh64(ptr, n, seed))


def xxh32(data, seed: int = 0) -> int:
    """XXH32 digest of `data` as an unsigned int: the value of
    ``xxhash.xxh32_intdigest(data, seed)``."""
    ptr, n, _keep = _hash_args(data)  # _keep holds the buffer
    return int(_required().held_xxh32(ptr, n, seed))


def has_zstd() -> bool:
    """True when zstd frames decode natively (linked libzstd or the
    runtime libzstd.so.1 resolved via dlopen); callers with zstd-marshaled
    blocks must otherwise take their Python path."""
    lib = _load()
    return bool(lib is not None and lib.vm_has_zstd())


def decompress_caps() -> int:
    """Bitmask of compressed-payload codecs the native decoder can
    inflate: bit 0 = zstd frames, bit 1 = zlib fallback streams."""
    lib = _load()
    return int(lib.vm_decompress_caps()) if lib is not None else 0


def zstd_compress(data: bytes, level: int = 1):
    """One-shot zstd compress via the runtime library; None when zstd is
    unavailable (callers fall back to zlib)."""
    lib = _load()
    if lib is None:
        return None
    cap = lib.vm_zstd_compress_bound(len(data))
    if cap < 0:
        return None
    out = ctypes.create_string_buffer(int(cap) or 1)
    n = lib.vm_zstd_compress(
        _as_u8_ptr(data), len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap, level)
    if n < 0:
        return None
    return out.raw[:n]


def zstd_decompress(data: bytes, max_size: int = 1 << 30):
    """One-shot zstd decompress, allocation-bounded by the frame's claimed
    content size (refused when unknown or above max_size — a hostile frame
    cannot balloon memory). None when zstd is unavailable; raises on a
    corrupt/oversized frame."""
    lib = _load()
    if lib is None or not lib.vm_has_zstd():
        return None
    src = _as_u8_ptr(data)
    size = lib.vm_zstd_content_size(src, len(data))
    if size < 0 or size > max_size:
        raise ValueError(
            f"zstd frame claims unknown or oversized content ({size})")
    out = ctypes.create_string_buffer(int(size) or 1)
    n = lib.vm_zstd_decompress(
        src, len(data), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
        size)
    if n != size:
        raise ValueError("native zstd: malformed frame")
    return out.raw[:n]


def _as_i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_u8_ptr(b):
    return ctypes.cast(ctypes.c_char_p(bytes(b) if not isinstance(b, (bytes, bytearray)) else b),
                       ctypes.POINTER(ctypes.c_uint8))


def varint_encode(vals: np.ndarray) -> bytes:
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = ctypes.create_string_buffer(int(vals.size) * 10 or 1)
    n = lib.vm_varint_encode(_as_i64_ptr(vals), vals.size,
                             ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)))
    return out.raw[:n]


def varint_decode(data: bytes, count: int) -> np.ndarray:
    lib = _load()
    out = np.empty(count, dtype=np.int64)
    n = lib.vm_varint_decode(_as_u8_ptr(data), len(data), _as_i64_ptr(out),
                             count)
    if n != count:
        raise ValueError(f"native varint: expected {count} values, got {n}")
    return out


def delta2_encode(vals: np.ndarray) -> tuple[bytes, int, int]:
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = ctypes.create_string_buffer(int(vals.size) * 10 or 1)
    first = ctypes.c_int64()
    fd = ctypes.c_int64()
    n = lib.vm_delta2_encode(_as_i64_ptr(vals), vals.size,
                             ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                             ctypes.byref(first), ctypes.byref(fd))
    if n < 0:
        raise ValueError("native delta2 encode failed")
    return out.raw[:n], first.value, fd.value


def delta2_decode(data: bytes, first: int, first_delta: int,
                  count: int) -> np.ndarray:
    lib = _load()
    out = np.empty(count, dtype=np.int64)
    n = lib.vm_delta2_decode(_as_u8_ptr(data), len(data), first, first_delta,
                             _as_i64_ptr(out), count)
    if n != count:
        raise ValueError("native delta2: malformed payload")
    return out


def delta_encode(vals: np.ndarray) -> tuple[bytes, int]:
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = ctypes.create_string_buffer(int(vals.size) * 10 or 1)
    first = ctypes.c_int64()
    n = lib.vm_delta_encode(_as_i64_ptr(vals), vals.size,
                            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.byref(first))
    if n < 0:
        raise ValueError("native delta encode failed")
    return out.raw[:n], first.value


def delta_decode(data: bytes, first: int, count: int) -> np.ndarray:
    lib = _load()
    out = np.empty(count, dtype=np.int64)
    n = lib.vm_delta_decode(_as_u8_ptr(data), len(data), first,
                            _as_i64_ptr(out), count)
    if n != count:
        raise ValueError("native delta: malformed payload")
    return out


def decode_blocks(buf, off: np.ndarray, sz: np.ndarray, mt: np.ndarray,
                  first: np.ndarray, cnt: np.ndarray, out: np.ndarray,
                  validate_ts: bool) -> None:
    """Batched block decode: K payloads at buf[off[i]:off[i]+sz[i]] (zstd
    inline for MarshalType 5/6) -> int64s written contiguously into `out`
    (pre-sized to cnt.sum()). buf may be any buffer (bytes/mmap/ndarray).
    Raises ValueError naming the malformed block."""
    lib = _load()
    if isinstance(buf, np.ndarray):
        base = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:  # bytes: zero-copy via c_char_p
        base = ctypes.cast(ctypes.c_char_p(buf),
                           ctypes.POINTER(ctypes.c_uint8))
    k = int(off.size)
    r = lib.vm_decode_blocks(
        base, _as_i64_ptr(off), _as_i64_ptr(sz),
        mt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_i64_ptr(first), _as_i64_ptr(cnt), k, _as_i64_ptr(out),
        1 if validate_ts else 0)
    if r != int(cnt.sum()):
        raise ValueError(f"native decode_blocks: malformed block {-r - 1}")


def _as_base_ptr(buf):
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def assemble_part(ts_buf, val_buf, ts_off, ts_sz, ts_mt, ts_first,
                  val_off, val_sz, val_mt, val_first, cnt, exps,
                  lo: int, hi: int):
    """Fused per-part read kernel (vm_assemble_part): decode K blocks'
    timestamp+value streams from the part's mmap'd payload buffers, clip
    each block to [lo, hi], convert kept mantissas to float64 with the
    block exponents, and compact into freshly allocated output columns —
    ONE GIL-released call per part. Returns (kept_per_block int64[K],
    ts int64[kept], vals float64[kept]); the ts/vals arrays are zero-copy
    views of the kernel-filled buffers. Raises on a malformed block."""
    lib = _load()
    k = int(cnt.size)
    total = int(cnt.sum())
    out_ts = np.empty(total, np.int64)
    out_vals = np.empty(total, np.float64)
    out_cnt = np.empty(k, np.int64)
    r = lib.vm_assemble_part(
        _as_base_ptr(ts_buf), _as_base_ptr(val_buf),
        _as_i64_ptr(ts_off), _as_i64_ptr(ts_sz),
        ts_mt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_i64_ptr(ts_first),
        _as_i64_ptr(val_off), _as_i64_ptr(val_sz),
        val_mt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_i64_ptr(val_first),
        _as_i64_ptr(cnt), _as_i64_ptr(exps), k, int(lo), int(hi),
        _as_i64_ptr(out_ts),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(out_cnt))
    if r < 0:
        raise ValueError(f"native assemble_part: malformed block {-r - 1}")
    return out_cnt, out_ts[:r], out_vals[:r]


def dedup_rows(ts2: np.ndarray, v2: np.ndarray, counts: np.ndarray,
               rows: np.ndarray, interval_ms: int, pad_ts: int) -> None:
    """In-place per-row dedup + exact-duplicate removal over the padded
    (S, N) layout for the listed rows (vm_dedup_rows; bit-exact with
    storage/dedup.deduplicate + the keep-last pass). ts2/v2 may be
    column-sliced views (row stride is passed through); counts is
    rewritten in place."""
    lib = _load()
    if ts2.strides[1] != 8 or v2.strides[1] != 8:
        raise ValueError("dedup_rows needs row-contiguous columns")
    rows = np.ascontiguousarray(rows, np.int64)
    lib.vm_dedup_rows(
        _as_i64_ptr(ts2), ts2.strides[0] // 8,
        v2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v2.strides[0] // 8, _as_i64_ptr(counts), _as_i64_ptr(rows),
        int(rows.size), int(interval_ms), int(pad_ts))


def decimal_to_float_blocks(m: np.ndarray, group_offsets: np.ndarray,
                            exps: np.ndarray, out: np.ndarray) -> None:
    """Batched mantissa->float64: group i = m[group_offsets[i]:
    group_offsets[i+1]] with decimal exponent exps[i], written into out
    (same layout). Replicates ops/decimal.decimal_to_float bit-exactly."""
    lib = _load()
    k = int(group_offsets.size) - 1
    lib.vm_decimal_to_float_blocks(
        _as_i64_ptr(m), _as_i64_ptr(group_offsets), _as_i64_ptr(exps), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))


def f2d_grouped(values: np.ndarray, starts: np.ndarray):
    """Grouped float64 -> (int64 mantissas, per-group exponents), the
    native twin of ops/decimal.float_to_decimal_grouped (flush hot path).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.float64)
    st = np.ascontiguousarray(starts, dtype=np.int64)
    m_out = np.empty(v.size, np.int64)
    exps = np.empty(st.size, np.int64)
    lib.vm_f2d_grouped(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(st), st.size, v.size, _as_i64_ptr(m_out),
        _as_i64_ptr(exps))
    return m_out, exps


def clip_blocks(ts: np.ndarray, bstart: np.ndarray, bend: np.ndarray,
                lo: int, hi: int):
    """Per-block [lo, hi]-inclusive kept row range over the concatenated
    (per-block sorted) timestamp column: block i spans rows
    [bstart[i], bend[i]). Returns (keep_lo, keep_hi) index arrays."""
    lib = _load()
    k = int(bstart.size)
    out_lo = np.empty(k, np.int64)
    out_hi = np.empty(k, np.int64)
    lib.vm_clip_blocks(_as_i64_ptr(ts), _as_i64_ptr(bstart),
                       _as_i64_ptr(bend), k, int(lo), int(hi),
                       _as_i64_ptr(out_lo), _as_i64_ptr(out_hi))
    return out_lo, out_hi


def gather_rows2(a: np.ndarray, b: np.ndarray, keep_lo: np.ndarray,
                 keep_hi: np.ndarray, total: int):
    """Densely gather kept row ranges of two parallel int64 columns (per-
    segment memcpy; `total` = sum of range lengths)."""
    lib = _load()
    out_a = np.empty(total, np.int64)
    out_b = np.empty(total, np.int64)
    lib.vm_gather_rows2(_as_i64_ptr(a), _as_i64_ptr(b),
                        _as_i64_ptr(keep_lo), _as_i64_ptr(keep_hi),
                        int(keep_lo.size), _as_i64_ptr(out_a),
                        _as_i64_ptr(out_b))
    return out_a, out_b


def scatter_pad(ts_all: np.ndarray, vals_f: np.ndarray, cnts: np.ndarray,
                rows: np.ndarray, S: int, N: int, pad_ts: int):
    """Scatter pre-grouped blocks into padded (S, N) tiles; returns
    (ts2, v2, counts). Appends block k's samples to row rows[k] in input
    order, pads row tails with (pad_ts, 0.0)."""
    lib = _load()
    ts2 = np.empty((S, N), np.int64)
    v2 = np.empty((S, N), np.float64)
    fill = np.zeros(S, np.int64)
    lib.vm_scatter_pad(
        _as_i64_ptr(ts_all),
        vals_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(cnts), _as_i64_ptr(rows), int(cnts.size), int(S),
        int(N), int(pad_ts), _as_i64_ptr(ts2),
        v2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(fill))
    return ts2, v2, fill


def counter_resets_2d(v: np.ndarray) -> np.ndarray:
    """Row-batched counter-reset removal; v is (S, N) or (N,) float64."""
    lib = _load()
    a = np.ascontiguousarray(v, dtype=np.float64)
    shape = a.shape
    if a.ndim == 1:
        a = a.reshape(1, -1)
    out = np.empty_like(a)
    lib.vm_counter_resets_2d(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        a.shape[0], a.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out.reshape(shape)


ROLLUP_COUNTER_FUNCS = {"rate": 1, "increase": 2, "increase_pure": 7,
                        "delta": 3, "deriv_fast": 4, "irate": 5, "idelta": 6}


def rollup_counter_2d(func: str, ts2: np.ndarray, v2: np.ndarray,
                      counts: np.ndarray, start: int, end: int, step: int,
                      lookback: int, mpi: np.ndarray) -> np.ndarray:
    """Fused native window-walk for the counter/derivative rollup family;
    returns (S, T) float64. Semantics match rollup_batch_packed bit-exactly
    (shared differential tests)."""
    lib = _load()
    S, N = ts2.shape
    T = (end - start) // step + 1
    ts2 = np.ascontiguousarray(ts2, dtype=np.int64)
    v2 = np.ascontiguousarray(v2, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    mpi = np.ascontiguousarray(mpi, dtype=np.int64)
    out = np.empty((S, T), np.float64)
    scratch = np.empty(max(N, 1), np.float64)
    lib.vm_rollup_counter_2d(
        _as_i64_ptr(ts2), v2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(counts), S, N, start, end, step, lookback,
        _as_i64_ptr(mpi), ROLLUP_COUNTER_FUNCS[func],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scratch.ctypes.
        data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def marshal_i64_many(vals: np.ndarray, offsets: np.ndarray):
    """Batched block marshal: type choice + encode for K blocks in one
    native call. vals = int64 concatenation, offsets = K+1 boundaries.
    Returns (payload bytes, types int32[K], firsts int64[K], lens int64[K])
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    k = offsets.size - 1
    cap = int(vals.size + k) * 10 + 16
    out = ctypes.create_string_buffer(cap)
    types = np.empty(k, dtype=np.int32)
    firsts = np.empty(k, dtype=np.int64)
    lens = np.empty(k, dtype=np.int64)
    n = lib.vm_marshal_i64_many(
        _as_i64_ptr(vals), _as_i64_ptr(offsets), k,
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap,
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_i64_ptr(firsts), _as_i64_ptr(lens))
    if n < 0:
        raise ValueError("native batched marshal failed")
    return out.raw[:n], types, firsts, lens


_TS_ABSENT = -(2 ** 63)  # INT64_MIN sentinel from vm_parse_prom


def parse_prom_raw(data: bytes, default_ts: int):
    """Native prometheus text parse -> list of (series_key_bytes, ts_ms,
    value). Returns None when the native library is unavailable (callers
    fall back to the Python parser). The series key is the raw
    `name{labels}` prefix — the storage TSID cache is keyed on it directly,
    so repeat scrapes never materialize labels."""
    lib = _load()
    if lib is None:
        return None
    n_max = data.count(b"\n") + 2
    key_off = np.empty(n_max, dtype=np.int32)
    key_len = np.empty(n_max, dtype=np.int32)
    values = np.empty(n_max, dtype=np.float64)
    tss = np.empty(n_max, dtype=np.int64)
    n = lib.vm_parse_prom(
        data, len(data),
        key_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        key_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(tss), n_max)
    out = []
    mv = memoryview(data)
    for i in range(n):
        o = key_off[i]
        ts = tss[i]
        # explicit 0 is "no timestamp" too, matching the Python ingest path
        # (Row.with_default_ts treats 0 as absent)
        out.append((bytes(mv[o:o + key_len[i]]),
                    default_ts if ts == _TS_ABSENT or ts == 0 else int(ts),
                    values[i]))
    return out


def snappy_uncompress(data: bytes):
    """Native snappy block-format decompress; None when unavailable or
    malformed (callers fall back to the Python decoder)."""
    lib = _load()
    if lib is None:
        return None
    src = _as_u8_ptr(data)
    n = lib.vm_snappy_uncompressed_len(src, len(data))
    if n < 0 or n > 1 << 31:
        # unreasonable claimed length (attacker-controlled varint): refuse
        # to allocate; the Python decoder raises the proper 400 downstream
        return None
    out = ctypes.create_string_buffer(int(n) or 1)
    w = lib.vm_snappy_uncompress(src, len(data),
                                 ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                                 n)
    if w != n:
        return None
    return out.raw[:n]


class ColumnarRows:
    """Columnar ingest rows: keybuf[key_off[i]:key_off[i]+key_len[i]] is the
    canonical text series key of row i; tss/values are int64/float64."""

    __slots__ = ("keybuf", "key_off", "key_len", "tss", "values")

    def __init__(self, keybuf, key_off, key_len, tss, values):
        self.keybuf = keybuf
        self.key_off = key_off
        self.key_len = key_len
        self.tss = tss
        self.values = values

    def __len__(self):
        return self.key_off.size

    def to_rows(self):
        """Materialize per-row (key_bytes, ts, value) tuples (slow; tests
        and non-columnar storages only)."""
        mv = memoryview(self.keybuf)
        return [(bytes(mv[o:o + l]), int(t), float(v))
                for o, l, t, v in zip(self.key_off, self.key_len,
                                      self.tss, self.values)]


def _parse_columnar(call, data: bytes, est_rows: int):
    """Shared retry loop for the columnar parsers: grows keybuf (-2) and
    row capacity (-3); -1 = native asked for the Python fallback."""
    lib = _load()
    if lib is None:
        return None
    keybuf_cap = 2 * len(data) + 4096
    max_rows = est_rows
    for _ in range(6):
        keybuf = ctypes.create_string_buffer(keybuf_cap)
        key_off = np.empty(max_rows, dtype=np.int64)
        key_len = np.empty(max_rows, dtype=np.int64)
        values = np.empty(max_rows, dtype=np.float64)
        tss = np.empty(max_rows, dtype=np.int64)
        n = call(lib, keybuf, keybuf_cap, _as_i64_ptr(key_off),
                 _as_i64_ptr(key_len),
                 values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                 _as_i64_ptr(tss), max_rows)
        if n == -2:
            keybuf_cap *= 4
            continue
        if n == -3:
            max_rows *= 4
            continue
        if n < 0:
            return None
        return ColumnarRows(keybuf.raw[:_keybuf_used(key_off, key_len, n)],
                            key_off[:n], key_len[:n], tss[:n], values[:n])
    return None


def _keybuf_used(key_off, key_len, n):
    if n == 0:
        return 0
    return int(key_off[n - 1] + key_len[n - 1])


def parse_rw_columnar(data: bytes, default_ts: int):
    """Native remote-write WriteRequest parse (uncompressed protobuf) ->
    ColumnarRows; None = fall back to the Python parser."""
    return _parse_columnar(
        lambda lib, kb, kc, ko, kl, vs, ts, mr: lib.vm_parse_rw(
            _as_u8_ptr(data), len(data), default_ts, ctypes.cast(
                kb, ctypes.POINTER(ctypes.c_uint8)), kc, ko, kl, vs, ts, mr),
        data, max(data.count(b"\x12") + 16, 64))


def parse_influx_columnar(data: bytes, db: str, default_ts: int):
    """Native influx line-protocol parse -> ColumnarRows; None = fallback."""
    dbb = db.encode() if db else b""
    return _parse_columnar(
        lambda lib, kb, kc, ko, kl, vs, ts, mr: lib.vm_parse_influx(
            _as_u8_ptr(data), len(data), _as_u8_ptr(dbb), len(dbb),
            default_ts, ctypes.cast(kb, ctypes.POINTER(ctypes.c_uint8)),
            kc, ko, kl, vs, ts, mr),
        data, max(2 * data.count(b"\n") + 16, 64))


def parse_prom_columnar(data: bytes, default_ts: int):
    """Native prometheus text parse -> ColumnarRows (keys reference the
    request body itself); None = fallback."""
    lib = _load()
    if lib is None:
        return None
    n_max = data.count(b"\n") + 2
    key_off = np.empty(n_max, dtype=np.int32)
    key_len = np.empty(n_max, dtype=np.int32)
    values = np.empty(n_max, dtype=np.float64)
    tss = np.empty(n_max, dtype=np.int64)
    n = lib.vm_parse_prom(
        data, len(data),
        key_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        key_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _as_i64_ptr(tss), n_max)
    tss = tss[:n]
    # explicit 0 is "no timestamp" too (parity with parse_prom_raw)
    tss[(tss == _TS_ABSENT) | (tss == 0)] = default_ts
    return ColumnarRows(data, key_off[:n].astype(np.int64),
                        key_len[:n].astype(np.int64), tss, values[:n])


class KeyMap:
    """Native byte-string -> dense-id map (vm_keymap). Ids are assigned
    consecutively in first-occurrence order, so id arrays can index numpy
    side tables (TSID fields, per-day state) directly."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.vm_keymap_new()
        if not self._h:
            raise MemoryError("vm_keymap_new failed")

    def __len__(self):
        return int(self._lib.vm_keymap_size(self._h))

    def resolve(self, base, key_off: np.ndarray,
                key_len: np.ndarray) -> tuple[np.ndarray, int]:
        """Returns (ids int64[n], n_new). New keys get ids
        len-before..len-before+n_new-1 in first-occurrence order."""
        n = int(key_off.size)
        ids = np.empty(n, dtype=np.int64)
        if isinstance(base, np.ndarray):
            bp = base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        else:
            bp = _as_u8_ptr(base)
        added = self._lib.vm_keymap_resolve(
            self._h, bp, _as_i64_ptr(np.ascontiguousarray(key_off, np.int64)),
            _as_i64_ptr(np.ascontiguousarray(key_len, np.int64)), n,
            _as_i64_ptr(ids))
        if added < 0:
            raise MemoryError("vm_keymap_resolve failed")
        return ids, int(added)

    def close(self):
        if self._h:
            self._lib.vm_keymap_free(self._h)
            self._h = 0

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError, OSError):
            # interpreter teardown: the ctypes lib handle may already
            # be gone; __del__ must never raise
            pass
