"""ctypes bindings for the native host codec (``codec.cpp``).

The port's own copy of ``victoriametrics_tpu/native`` for ``codec.cpp``:
varint and delta(2) codecs, the batched block marshal, the zstd one-shots,
the storage read kernels (block decode, part assembly, dedup, mantissa ->
float64), the grouped float -> decimal of the cold upload, the
counter/rollup host kernels, and xxh64/xxh32 (the storage's series
hashes, in place of the ``xxhash`` package).  (``parse.cpp`` and
``ingest.cpp`` come with the ingestion layer.)

``codec.cpp`` is compiled by g++ on first use, never at import, into
``victoriametrics_tpu_torch/_build/libvmcodec-<digest>.so``, the digest
taken over the source, the flags and this CPU (``-march=native``), so a
build from another machine is not loaded.  Concurrent first users (test
workers) build under a file lock into a temporary name that is renamed
into place.  Where no compiler is found or the build fails, ``_load()``
returns None and callers keep their numpy paths (the reference's
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
SOURCE = _DIR / "codec.cpp"
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
    digest = hashlib.blake2b(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _cpu_tag(),
        digest_size=8).hexdigest()
    return BUILD_DIR / f"libvmcodec-{digest}.so"


def _zstd_links(cxx: str) -> bool:
    """Whether zstd.h compiles and -lzstd links (the reference Makefile's
    HAVE_ZSTD probe); without them codec.cpp dlopens libzstd at run time."""
    r = subprocess.run([cxx, "-x", "c++", "-", "-lzstd", "-o", os.devnull],
                       input=b"#include <zstd.h>\nint main(){return 0;}\n",
                       capture_output=True, timeout=120)
    return r.returncode == 0


def build() -> Path:
    """Compile codec.cpp into ``_build/`` unless it is built; returns the
    library's path.  Raises FileNotFoundError without a compiler and
    RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native codec cannot be "
                                "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libvmcodec.lock", "wb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        zstd = _zstd_links(cxx)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *(["-DVM_HAVE_ZSTD=1"] if zstd else []),
               "-o", str(tmp), str(SOURCE), *(["-lzstd"] if zstd else []),
               "-ldl"]
        r = subprocess.run(cmd, capture_output=True, timeout=600)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ codec.cpp failed ({r.returncode}):\n"
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
            try:
                _lib = _configure(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError):
                _lib = None
            _tried = True
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
    lib.vm_xxh64.restype = ctypes.c_uint64
    lib.vm_xxh64.argtypes = [ctypes.c_void_p, i64, ctypes.c_uint64]
    lib.vm_xxh32.restype = ctypes.c_uint32
    lib.vm_xxh32.argtypes = [ctypes.c_void_p, i64, ctypes.c_uint32]
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
    return int(_required().vm_xxh64(ptr, n, seed))


def xxh32(data, seed: int = 0) -> int:
    """XXH32 digest of `data` as an unsigned int: the value of
    ``xxhash.xxh32_intdigest(data, seed)``."""
    ptr, n, _keep = _hash_args(data)  # _keep holds the buffer
    return int(_required().vm_xxh32(ptr, n, seed))


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
