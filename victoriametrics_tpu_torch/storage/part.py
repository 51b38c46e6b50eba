"""Immutable part files (reference lib/storage/part.go:30-48,
metaindex_row.go, part_header.go:19).

Anatomy (same as the reference):
  timestamps.bin  concatenated timestamp payloads
  values.bin      concatenated value payloads
  index.bin       zstd index blocks of up to 256 BlockHeaders each
  metaindex.bin   zstd array of metaindex rows: (first_tsid, block_count,
                  index_offset, index_size, min_ts, max_ts)
  metadata.json   {rows, blocks, min_ts, max_ts}

Parts are written once to a .tmp dir, fsynced, then renamed — the atomic
immutable-part property that makes snapshots hardlinks (fs.go:71,182).

The port's copy of ``victoriametrics_tpu/storage/part.py``, whole; its id-set memo key is the
native codec's xxh64 in place of the ``xxhash`` package.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import OrderedDict

import numpy as np

from ..devtools import faultinject
from ..ops import compress as zstd
from ..utils import fs as fslib
from .block import Block, BlockHeader
from .tsid import TSID

#: re-exported: callers catch this to quarantine torn/corrupt parts
PartIntegrityError = fslib.IntegrityError

HEADERS_PER_INDEX_BLOCK = 256
_META_ROW = struct.Struct(">32sIQIqq")

# global budget for whole-part decoded-row memos (Part._dec), shared across
# every open part so many hot parts cannot pin unbounded RAM (the
# lib/blockcache 25%-of-RAM role); released on part close/GC.  Guarded by
# a locktrace-made lock so the happens-before sanitizer sees the seam
# (concurrent pool workers race to memoize different parts; a bare
# threading.Lock would carry no vector clocks).
from ..devtools.locktrace import make_lock as _make_lock

DEC_CACHE_TOTAL_BYTES = int(os.environ.get("VM_DEC_CACHE_TOTAL_MB",
                                           2048)) << 20
_dec_budget_lock = _make_lock("storage.part._dec_budget")
_dec_budget_used = 0


def _dec_budget_take(cost: int) -> bool:
    global _dec_budget_used
    with _dec_budget_lock:
        if _dec_budget_used + cost > DEC_CACHE_TOTAL_BYTES:
            return False
        _dec_budget_used += cost
        return True


def _dec_budget_release(cost: int) -> None:
    global _dec_budget_used
    with _dec_budget_lock:
        _dec_budget_used -= cost

# numpy mirror of BlockHeader's struct layout (">32sqqIhBBBqqQIQI"); the
# TSID's trailing 8 bytes are the metric_id (tsid.py _FMT ">IIQIIQ"), split
# out so header selection is pure array masking
def sorted_member_mask(mids_sorted, mids: np.ndarray) -> np.ndarray:
    """Membership mask of each metric id in the SORTED wanted-id array
    (None = everything matches). Shared by the file-part and in-memory
    columnar block selectors so their semantics cannot diverge."""
    if mids_sorted is None:
        return np.ones(mids.shape, bool)
    if len(mids_sorted) == 0:
        return np.zeros(mids.shape, bool)
    pos = np.searchsorted(mids_sorted, mids)
    pos_c = np.minimum(pos, len(mids_sorted) - 1)
    return (mids_sorted[pos_c] == mids) & (pos < len(mids_sorted))


def _clip_gather(mids, scales, ts_src, m_src, bstart, bend, min_ts, max_ts,
                 unchanged=None):
    """Shared core of the row-granular time clip: block i of the piece
    lives at rows [bstart[i], bend[i]) of ts_src/m_src. Keeps only samples
    in [min_ts, max_ts], drops emptied blocks, densely gathers survivors.
    Returns (mids, cnts, scales, ts, mants) — or `unchanged` verbatim when
    nothing clips (callers pass their no-copy representation)."""
    k = int(bstart.size)
    lo = -(1 << 62) if min_ts is None else min_ts
    hi = (1 << 62) if max_ts is None else max_ts
    from .. import native as _native
    if _native.available():
        ts_src = np.ascontiguousarray(ts_src)
        m_src = np.ascontiguousarray(m_src)
        keep_lo, keep_hi = _native.clip_blocks(ts_src, bstart, bend, lo, hi)
    else:
        keep_lo = np.empty(k, np.int64)
        keep_hi = np.empty(k, np.int64)
        for i in range(k):
            a, b = int(bstart[i]), int(bend[i])
            seg = ts_src[a:b]
            keep_lo[i] = a + np.searchsorted(seg, lo, side="left")
            keep_hi[i] = a + np.searchsorted(seg, hi, side="right")
    new_cnts = keep_hi - keep_lo
    kept = int(new_cnts.sum())
    if unchanged is not None and kept == int(bend[-1] - bstart[0]) \
            and bool((bend[:-1] == bstart[1:]).all()):
        return unchanged
    nz = new_cnts > 0
    if not nz.all():
        mids, scales = mids[nz], scales[nz]
        keep_lo, keep_hi = keep_lo[nz], keep_hi[nz]
        new_cnts = new_cnts[nz]
    if kept == 0:
        return (mids, new_cnts, scales, np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    if _native.available():
        ts_k, m_k = _native.gather_rows2(ts_src, m_src, keep_lo, keep_hi,
                                         kept)
    else:
        excl = np.cumsum(new_cnts) - new_cnts
        pos = np.repeat(keep_lo - excl, new_cnts) + \
            np.arange(kept, dtype=np.int64)
        ts_k, m_k = ts_src[pos], m_src[pos]
    return mids, new_cnts, scales, ts_k, m_k


def _piece_to_float(piece):
    """Mantissa piece (mids, cnts, scales, ts, mants) -> FLOAT piece
    (mids, cnts, ts, vals_f64), converting per block with the block
    exponent — the exact per-(value, exponent) conversion the split
    path's decode phase applies globally, so fused-mode pieces coming
    from fallback sub-paths stay bit-identical to the oracle."""
    mids, cnts, scales, ts, m = piece
    vals = np.empty(m.size, np.float64)
    goff = np.empty(cnts.size + 1, np.int64)
    goff[0] = 0
    np.cumsum(cnts, out=goff[1:])
    from .. import native as _native
    if _native.available():
        _native.decimal_to_float_blocks(
            np.ascontiguousarray(m), goff,
            np.ascontiguousarray(scales, dtype=np.int64), vals)
    else:
        from ..ops import decimal as dec_ops
        dec_ops.decimal_to_float_blocks_py(m, goff, scales, vals)
    return mids, cnts, ts, vals


def clip_piece(mids, cnts, scales, ts_all, m_all, min_ts, max_ts):
    """Row-granular time clip of one collected piece: keep only samples in
    [min_ts, max_ts] (the part_search.go pruning taken down to rows, so a
    tail fetch of M samples costs O(M) downstream — float conversion and
    (S, N) assembly never see out-of-range rows). Blocks left empty are
    dropped. No-ops (returning the inputs unchanged) when nothing clips."""
    k = int(cnts.size)
    if k == 0 or ts_all.size == 0:
        return mids, cnts, scales, ts_all, m_all
    goff = np.empty(k + 1, np.int64)
    goff[0] = 0
    np.cumsum(cnts, out=goff[1:])
    return _clip_gather(mids, scales, ts_all, m_all, goff[:-1].copy(),
                        goff[1:].copy(), min_ts, max_ts,
                        unchanged=(mids, cnts, scales, ts_all, m_all))


_HDR_DTYPE = np.dtype([
    ("tsid_pre", "S24"), ("mid", ">u8"),
    ("min_ts", ">i8"), ("max_ts", ">i8"), ("rows", ">u4"),
    ("scale", ">i2"), ("prec", "u1"), ("ts_mt", "u1"), ("val_mt", "u1"),
    ("ts_first", ">i8"), ("val_first", ">i8"),
    ("ts_off", ">u8"), ("ts_size", ">u4"), ("val_off", ">u8"),
    ("val_size", ">u4")])


class MetaindexRow:
    __slots__ = ("first_tsid", "block_count", "index_offset", "index_size",
                 "min_ts", "max_ts")


class PartWriter:
    """Streams blocks (sorted by (tsid, min_ts)) into a new part dir."""

    def __init__(self, path: str, resolution_ms: int = 0):
        self.path = path
        #: sample resolution this part stores: 0 = raw samples; >0 = one
        #: aggregated sample per resolution_ms bucket (downsampled tier)
        self.resolution_ms = resolution_ms
        self.tmp = path + ".tmp"
        os.makedirs(self.tmp, exist_ok=True)
        self._ts_f = open(os.path.join(self.tmp, "timestamps.bin"), "wb")
        self._val_f = open(os.path.join(self.tmp, "values.bin"), "wb")
        self._idx_f = open(os.path.join(self.tmp, "index.bin"), "wb")
        self._meta_rows = bytearray()
        self._hdrs: list[bytes] = []
        self._hdr_block_first: TSID | None = None
        self._hdr_min_ts = 1 << 62
        self._hdr_max_ts = -(1 << 62)
        self.rows = 0
        self.blocks = 0
        self.min_ts = 1 << 62
        self.max_ts = -(1 << 62)
        self._prev_key = None
        # incremental per-file crc32, folded as bytes stream out: the
        # finalize checksum costs no re-read of the part
        self._crc = {"timestamps.bin": 0, "values.bin": 0, "index.bin": 0}

    def write_block(self, blk: Block) -> None:
        h, ts_data, val_data = blk.marshal()
        self._write_marshaled(blk.tsid, h, ts_data, val_data)

    def write_blocks_bulk(self, blocks: list[Block]) -> None:
        """Marshal + write a (tsid, min_ts)-sorted run of blocks with ONE
        native call per stream (timestamps, mantissas) instead of
        per-block Python — the flush hot path spends its time in encode,
        and per-block overhead dominates at scrape-sized blocks. Falls
        back to write_block when the native codec is absent or a block
        needs the lossy (<64-bit precision) path."""
        from .. import native
        if (len(blocks) < 8 or not native.available() or
                any(b.precision_bits < 64 for b in blocks)):
            for b in blocks:
                self.write_block(b)
            return
        from ..ops.encoding import (MIN_COMPRESSIBLE_BLOCK_SIZE,
                                    _MIN_COMPRESS_RATIO, MarshalType, zstd)
        K = len(blocks)
        counts = np.fromiter((b.timestamps.size for b in blocks),
                             np.int64, K)
        offs = np.empty(K + 1, np.int64)
        offs[0] = 0
        np.cumsum(counts, out=offs[1:])
        ts_all = np.concatenate([b.timestamps for b in blocks])
        m_all = np.concatenate([np.asarray(b.values, np.int64)
                                for b in blocks])
        ts_pay, ts_t, ts_first, ts_len = native.marshal_i64_many(
            ts_all, offs)
        v_pay, v_t, v_first, v_len = native.marshal_i64_many(m_all, offs)
        ts_off = np.empty(K + 1, np.int64)
        ts_off[0] = 0
        np.cumsum(ts_len, out=ts_off[1:])
        v_off = np.empty(K + 1, np.int64)
        v_off[0] = 0
        np.cumsum(v_len, out=v_off[1:])
        zstd_map = {int(MarshalType.NEAREST_DELTA):
                    MarshalType.ZSTD_NEAREST_DELTA,
                    int(MarshalType.NEAREST_DELTA2):
                    MarshalType.ZSTD_NEAREST_DELTA2}
        for i, blk in enumerate(blocks):
            ts_data = ts_pay[ts_off[i]:ts_off[i + 1]]
            val_data = v_pay[v_off[i]:v_off[i + 1]]
            ts_mt, val_mt = int(ts_t[i]), int(v_t[i])
            if len(ts_data) >= MIN_COMPRESSIBLE_BLOCK_SIZE and \
                    ts_mt in zstd_map:
                packed = zstd.compress(ts_data)
                if len(packed) * _MIN_COMPRESS_RATIO < len(ts_data):
                    ts_data, ts_mt = packed, int(zstd_map[ts_mt])
            if len(val_data) >= MIN_COMPRESSIBLE_BLOCK_SIZE and \
                    val_mt in zstd_map:
                packed = zstd.compress(val_data)
                if len(packed) * _MIN_COMPRESS_RATIO < len(val_data):
                    val_data, val_mt = packed, int(zstd_map[val_mt])
            h = BlockHeader()
            h.tsid = blk.tsid
            h.min_ts = int(blk.timestamps[0])
            h.max_ts = int(blk.timestamps[-1])
            h.rows = int(counts[i])
            h.scale = blk.scale
            h.precision_bits = blk.precision_bits
            h.ts_marshal_type = ts_mt
            h.val_marshal_type = val_mt
            h.ts_first = int(ts_first[i])
            h.val_first = int(v_first[i])
            h.ts_offset = h.val_offset = 0
            h.ts_size = len(ts_data)
            h.val_size = len(val_data)
            self._write_marshaled(blk.tsid, h, ts_data, val_data)

    def _write_marshaled(self, tsid, h, ts_data: bytes,
                         val_data: bytes) -> None:
        key = (tsid.sort_key(), h.min_ts)
        if self._prev_key is not None and key < self._prev_key:
            raise ValueError("part writer: blocks out of order")
        self._prev_key = key
        h.ts_offset = self._ts_f.tell()
        h.val_offset = self._val_f.tell()
        self._ts_f.write(ts_data)
        self._val_f.write(val_data)
        self._crc["timestamps.bin"] = zlib.crc32(ts_data,
                                                 self._crc["timestamps.bin"])
        self._crc["values.bin"] = zlib.crc32(val_data,
                                             self._crc["values.bin"])
        if self._hdr_block_first is None:
            self._hdr_block_first = tsid
        self._hdrs.append(h.marshal())
        self._hdr_min_ts = min(self._hdr_min_ts, h.min_ts)
        self._hdr_max_ts = max(self._hdr_max_ts, h.max_ts)
        self.rows += h.rows
        self.blocks += 1
        self.min_ts = min(self.min_ts, h.min_ts)
        self.max_ts = max(self.max_ts, h.max_ts)
        if len(self._hdrs) >= HEADERS_PER_INDEX_BLOCK:
            self._flush_index_block()

    def _flush_index_block(self):
        if not self._hdrs:
            return
        data = zstd.compress(b"".join(self._hdrs))
        off = self._idx_f.tell()
        self._meta_rows += _META_ROW.pack(
            self._hdr_block_first.marshal(), len(self._hdrs), off, len(data),
            self._hdr_min_ts, self._hdr_max_ts)
        self._idx_f.write(data)
        self._crc["index.bin"] = zlib.crc32(data, self._crc["index.bin"])
        self._hdrs = []
        self._hdr_block_first = None
        self._hdr_min_ts = 1 << 62
        self._hdr_max_ts = -(1 << 62)

    def close(self) -> str:
        """Finalize: fsync everything, record per-file checksums in
        metadata.json, rename into place, fsync the parent dir (the
        rename alone is atomic but not durable).  Crashpoints bracket
        the rename so the kill -9 matrix can die on either side of the
        publish instant."""
        self._flush_index_block()
        for f in (self._ts_f, self._val_f, self._idx_f):
            f.flush()
            os.fsync(f.fileno())
            f.close()
        mi_data = zstd.compress(bytes(self._meta_rows))
        with open(os.path.join(self.tmp, "metaindex.bin"), "wb") as f:
            f.write(mi_data)
            f.flush()
            os.fsync(f.fileno())
        sums = dict(self._crc)
        sums["metaindex.bin"] = zlib.crc32(mi_data)
        fslib.write_meta_json(
            os.path.join(self.tmp, "metadata.json"),
            {"rows": self.rows, "blocks": self.blocks,
             "min_ts": self.min_ts, "max_ts": self.max_ts,
             "resolutionMs": self.resolution_ms,
             "checksums": sums})
        faultinject.fire("part:finalize:pre_rename")
        fslib.rename_durable(self.tmp, self.path)
        faultinject.fire("part:finalize:post_rename")
        return self.path

    def abort(self):
        import shutil
        for f in (self._ts_f, self._val_f, self._idx_f):
            try:
                f.close()
            except OSError:
                pass
        shutil.rmtree(self.tmp, ignore_errors=True)


class Part:
    """Open immutable part: metaindex in RAM, payloads read on demand."""

    def __init__(self, path: str, trusted: bool = False):
        self.path = path
        # integrity gate BEFORE any parsing: a torn/bit-flipped part must
        # fail here with PartIntegrityError (the opener quarantines it),
        # never misparse into wrong data.  metadata.json self-verifies
        # via meta_crc; the four payload files verify against the crc32s
        # recorded at finalize.  `trusted` skips the payload re-read for
        # parts THIS process just finalized (it computed the checksums
        # moments ago; re-reading would double flush/merge I/O) — cold
        # opens always verify.
        meta = fslib.load_meta_json(os.path.join(path, "metadata.json"))
        if not trusted:
            fslib.verify_checksums(path, meta)
        self.rows = meta["rows"]
        self.blocks = meta["blocks"]
        self.min_ts = meta["min_ts"]
        self.max_ts = meta["max_ts"]
        # additive field (wire-schema ratchet): parts written before
        # downsampling existed are raw
        self.resolution_ms = meta.get("resolutionMs", 0)
        raw = zstd.decompress(open(os.path.join(path, "metaindex.bin"), "rb").read())
        self.meta_rows: list[MetaindexRow] = []
        for off in range(0, len(raw), _META_ROW.size):
            tsid_b, cnt, ioff, isize, mn, mx = _META_ROW.unpack_from(raw, off)
            r = MetaindexRow()
            r.first_tsid = TSID.unmarshal(tsid_b)
            r.block_count = cnt
            r.index_offset = ioff
            r.index_size = isize
            r.min_ts = mn
            r.max_ts = mx
            self.meta_rows.append(r)
        self._idx_f = open(os.path.join(path, "index.bin"), "rb")
        self._ts_f = open(os.path.join(path, "timestamps.bin"), "rb")
        self._val_f = open(os.path.join(path, "values.bin"), "rb")
        # read-only mmaps for the batched columnar decode (parts are
        # immutable, so the mapping never goes stale); size-0 files (all
        # blocks CONST) map to empty arrays
        import mmap as _mmap
        self._ts_buf = self._val_buf = None
        try:
            for attr, f in (("_ts_buf", self._ts_f),
                            ("_val_buf", self._val_f)):
                size = os.fstat(f.fileno()).st_size
                if size == 0:
                    setattr(self, attr, np.zeros(0, dtype=np.uint8))
                else:
                    mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                    setattr(self, attr, np.frombuffer(mm, dtype=np.uint8))
        except (OSError, ValueError):
            self._ts_buf = self._val_buf = None  # fall back to pread path
        from ..devtools.locktrace import make_lock
        self._lock = make_lock("storage.Part._lock")
        # serializes the one-time header-column build: with the shared
        # work pool, two workers routinely hit a cold part at once, and
        # racing duplicate builds would double the index decompression
        # (distinct from _lock, which read_headers takes inside the build)
        self._hdr_cols_lock = make_lock("storage.Part._hdr_cols_lock")
        # parts are immutable, so both caches never go stale (the reference
        # keeps compressed blocks in lib/blockcache sized to 25% RAM; here we
        # cache the *decoded* form so warm queries skip unmarshal entirely)
        self._hdr_cache: dict[int, list[BlockHeader]] = {}
        self._block_cache: "OrderedDict[tuple, Block]" = OrderedDict()
        self._block_cache_bytes = 0
        self._hdr_cols = None  # lazy columnar view of all block headers
        # memoized whole-part decode, tagged by representation:
        # ("mant", ts, mantissas, goff) from the split collect path or
        # ("float", ts, float64 values, goff) from the fused assemble
        # kernel; a memo only short-circuits the mode that can use it
        self._dec = None
        self._dec_cost = 0
        # memoized block-membership masks keyed by the wanted-id set:
        # a rolling refresh selects the SAME series every step, so the
        # O(#blocks) membership scan runs once per id set and only the
        # (cheap, vectorized) time clip reruns per refresh
        self._member_memo: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    def close(self):
        self._release_dec()
        for f in (self._idx_f, self._ts_f, self._val_f):
            f.close()

    def _release_dec(self):
        with self._lock:
            cost, self._dec_cost = self._dec_cost, 0
            self._dec = None
        if cost:
            _dec_budget_release(cost)

    def __del__(self):
        # merged-away parts are dropped by GC without close(); give their
        # memo budget back.  __del__ must never raise, and at interpreter
        # teardown module globals the release path touches may be gone
        try:
            self._release_dec()
        except (AttributeError, TypeError, OSError):
            pass

    def _read(self, f, off: int, size: int) -> bytes:
        with self._lock:
            f.seek(off)
            return f.read(size)

    # byte-bounded per part: decoded ts(8B) + mantissas(8B) + the memoized
    # float view (8B) per row; 768MB covers ~33M rows of hot data per part
    # (the reference's lib/blockcache budgets 25% of RAM globally).
    # Override with VM_BLOCK_CACHE_PART_MB for small hosts.
    MAX_BLOCK_CACHE_BYTES = int(os.environ.get(
        "VM_BLOCK_CACHE_PART_MB", 768)) << 20

    def read_headers(self, row: MetaindexRow) -> list[BlockHeader]:
        got = self._hdr_cache.get(row.index_offset)
        if got is not None:
            return got
        raw = zstd.decompress(self._read(self._idx_f, row.index_offset,
                                         row.index_size))
        hdrs = [BlockHeader.unmarshal(raw, o)
                for o in range(0, len(raw), BlockHeader.SIZE)]
        # benign memo race: racing fills decode the same immutable bytes
        # to equal header lists; last-writer-wins is identical content
        self._hdr_cache[row.index_offset] = hdrs  # vmt: disable=VMT015
        return hdrs

    def read_block(self, h: BlockHeader) -> Block:
        # offsets alone can collide: const-encoded payloads are 0 bytes, so
        # consecutive tiny blocks share offsets — include identity fields
        key = (h.tsid.metric_id, h.min_ts, h.rows, h.ts_offset, h.val_offset)
        with self._lock:
            blk = self._block_cache.get(key)
            if blk is not None:
                self._block_cache.move_to_end(key)
                return blk
        ts_data = self._read(self._ts_f, h.ts_offset, h.ts_size)
        val_data = self._read(self._val_f, h.val_offset, h.val_size)
        blk = Block.unmarshal(h, ts_data, val_data)
        # decoded arrays are shared across queries: freeze them so an
        # accidental in-place mutation fails loudly instead of corrupting
        blk.timestamps.setflags(write=False)
        blk.values.setflags(write=False)
        cost = 24 * h.rows
        with self._lock:
            if key not in self._block_cache:
                self._block_cache_bytes += cost
            self._block_cache[key] = blk
            self._block_cache.move_to_end(key)
            while self._block_cache_bytes > self.MAX_BLOCK_CACHE_BYTES and \
                    len(self._block_cache) > 1:
                _, old = self._block_cache.popitem(last=False)
                self._block_cache_bytes -= 24 * old.rows
        return blk

    def iter_headers(self, tsid_set: set | None = None,
                     min_ts: int | None = None, max_ts: int | None = None,
                     tsid_lo=None, tsid_hi=None):
        """Yield BlockHeaders matching the tsid set / time range, in
        (tsid, min_ts) order (partSearch analog). Metaindex rows are pruned
        by time range and, when tsid_lo/tsid_hi sort keys are given, by the
        first_tsid directory (blocks are (tsid, min_ts)-sorted)."""
        rows = self.meta_rows
        for i, row in enumerate(rows):
            if min_ts is not None and row.max_ts < min_ts:
                continue
            if max_ts is not None and row.min_ts > max_ts:
                continue
            if tsid_hi is not None and row.first_tsid.sort_key() > tsid_hi:
                break
            if tsid_lo is not None and i + 1 < len(rows) and \
                    rows[i + 1].first_tsid.sort_key() <= tsid_lo:
                continue  # whole row precedes the wanted tsid range
            for h in self.read_headers(row):
                if tsid_set is not None and h.tsid.metric_id not in tsid_set:
                    continue
                if min_ts is not None and h.max_ts < min_ts:
                    continue
                if max_ts is not None and h.min_ts > max_ts:
                    continue
                yield h

    def iter_blocks(self, tsid_set=None, min_ts=None, max_ts=None,
                    tsid_lo=None, tsid_hi=None):
        for h in self.iter_headers(tsid_set, min_ts, max_ts, tsid_lo, tsid_hi):
            yield self.read_block(h)

    def unique_tsids(self) -> list[TSID]:
        """Every distinct TSID referenced by this part's blocks (the
        registration manifest a part migration must ship alongside the
        bytes — metric_ids are node-local counters, so the receiving
        node cannot resolve them without it)."""
        out: dict[int, TSID] = {}
        for h in self.iter_headers():
            t = h.tsid
            out.setdefault(t.metric_id, t)
        return list(out.values())

    def file_bytes(self) -> int:
        """Total on-disk payload bytes (migration sizing/accounting)."""
        total = 0
        for name in os.listdir(self.path):
            try:
                total += os.path.getsize(os.path.join(self.path, name))
            except OSError:
                pass
        return total

    def header_columns(self):
        """Columnar view of every block header, built ONCE per part
        (immutable): header selection for the batched fetch becomes pure
        numpy masking instead of per-header Python objects."""
        hc = self._hdr_cols
        if hc is None:
            with self._hdr_cols_lock:
                hc = self._hdr_cols
                if hc is not None:
                    return hc
                bufs = []
                for row in self.meta_rows:
                    raw = zstd.decompress(self._read(self._idx_f,
                                                     row.index_offset,
                                                     row.index_size))
                    bufs.append(np.frombuffer(raw, dtype=_HDR_DTYPE))
                arr = (np.concatenate(bufs) if bufs
                       else np.zeros(0, dtype=_HDR_DTYPE))
                hc = {k: arr[k].astype(np.int64)
                      for k in ("mid", "min_ts", "max_ts", "rows", "scale",
                                "ts_first", "val_first", "ts_off", "ts_size",
                                "val_off", "val_size")}
                hc["ts_mt"] = arr["ts_mt"].astype(np.int32)
                hc["val_mt"] = arr["val_mt"].astype(np.int32)
                self._hdr_cols = hc
        return hc

    def collect_columns(self, mids_sorted, min_ts, max_ts):
        """Vectorized header selection + ONE native decode pass over every
        matched block, row-clipped to [min_ts, max_ts]. Returns (mids,
        cnts, scales, ts_concat, mant_concat); None when the native path is
        unavailable (caller falls back to the per-header object path);
        False when the vectorized path RAN and nothing matched (caller
        skips this part — do not collapse the two sentinels,
        Partition.collect_columns branches on them).

        When a whole-part decode fits MAX_BLOCK_CACHE_BYTES, the decoded
        (ts, mantissa) columns are memoized — the part is immutable, so
        every later fetch (rolling dashboard refreshes, cache tail merges,
        device tile slice loads) is a clip+gather with NO decode at all
        (the lib/blockcache role, but holding decoded rows)."""
        from .. import native as _native
        if self._ts_buf is None or not _native.available():
            return None
        if (min_ts is not None and self.max_ts < min_ts) or \
                (max_ts is not None and self.min_ts > max_ts):
            # suffix-aware early-out: a part wholly outside the tail
            # window never builds header columns or scans membership
            return False
        hc, lo, hi, idx = self._select_blocks(mids_sorted, min_ts, max_ts)
        if idx.size == 0:
            return False
        dec = self._dec
        if dec is not None and dec[0] == "mant":
            _, ts_full, m_full, goff_full = dec
            piece = _clip_gather(
                np.ascontiguousarray(hc["mid"][idx]),
                np.ascontiguousarray(hc["scale"][idx]),
                ts_full, m_full, goff_full[idx], goff_full[idx + 1],
                min_ts, max_ts)
            return piece if piece[3].size else False
        ts_mt = np.ascontiguousarray(hc["ts_mt"][idx])
        val_mt = np.ascontiguousarray(hc["val_mt"][idx])
        if not self._compressed_decodable(idx, ts_mt, val_mt):
            return None  # compressed payloads need a codec this build lacks
        cnt = np.ascontiguousarray(hc["rows"][idx])
        total = int(cnt.sum())
        ts_out = np.empty(total, np.int64)
        m_out = np.empty(total, np.int64)
        _native.decode_blocks(
            self._ts_buf, np.ascontiguousarray(hc["ts_off"][idx]),
            np.ascontiguousarray(hc["ts_size"][idx]), ts_mt,
            np.ascontiguousarray(hc["ts_first"][idx]), cnt, ts_out,
            validate_ts=True)
        _native.decode_blocks(
            self._val_buf, np.ascontiguousarray(hc["val_off"][idx]),
            np.ascontiguousarray(hc["val_size"][idx]), val_mt,
            np.ascontiguousarray(hc["val_first"][idx]), cnt, m_out,
            validate_ts=False)
        if idx.size == hc["mid"].size:
            self._maybe_memoize("mant", ts_out, m_out, cnt, idx.size, total)
        return clip_piece(np.ascontiguousarray(hc["mid"][idx]), cnt,
                          np.ascontiguousarray(hc["scale"][idx]),
                          ts_out, m_out, min_ts, max_ts)

    def _select_blocks(self, mids_sorted, min_ts, max_ts):
        """Shared header selection of the batched read paths: returns
        (hc, lo, hi, idx) where idx lists the blocks overlapping
        [min_ts, max_ts] for the wanted metric ids.  The membership mask
        is memoized per id set (suffix-aware fetch: a rolling refresh's
        repeated identical series set pays only the time clip)."""
        hc = self.header_columns()
        lo = -(1 << 62) if min_ts is None else min_ts
        hi = (1 << 62) if max_ts is None else max_ts
        mm = self._member_mask(mids_sorted, hc)
        mask = (hc["max_ts"] >= lo) & (hc["min_ts"] <= hi) & mm
        return hc, lo, hi, np.flatnonzero(mask)

    def _member_mask(self, mids_sorted, hc) -> np.ndarray:
        if mids_sorted is None:
            return sorted_member_mask(mids_sorted, hc["mid"])
        from .. import native as _native
        key = (_native.xxh64(np.ascontiguousarray(mids_sorted)),
               int(mids_sorted.size))
        with self._lock:
            mm = self._member_memo.get(key)
            if mm is not None:
                self._member_memo.move_to_end(key)
                return mm
        mm = sorted_member_mask(mids_sorted, hc["mid"])
        mm.setflags(write=False)
        with self._lock:
            self._member_memo[key] = mm
            while len(self._member_memo) > 4:
                self._member_memo.popitem(last=False)
        return mm

    def _maybe_memoize(self, kind, ts_arr, data_arr, cnt, n_blocks,
                       total) -> None:
        """Publish a whole-part decode as the tagged _dec memo when the
        global budget allows (shared by the mantissa and float paths;
        loser of the publish race gives its budget back)."""
        if self._dec is not None or not _dec_budget_take(16 * total):
            return
        goff_full = np.empty(n_blocks + 1, np.int64)
        goff_full[0] = 0
        np.cumsum(cnt, out=goff_full[1:])
        ts_arr.setflags(write=False)
        data_arr.setflags(write=False)
        with self._lock:
            if self._dec is None:
                self._dec = (kind, ts_arr, data_arr, goff_full)
                self._dec_cost = 16 * total
            else:
                _dec_budget_release(16 * total)

    def _compressed_decodable(self, idx, ts_mt, val_mt) -> bool:
        """Whether every compressed (MarshalType>=5) payload among the
        selected blocks can be inflated natively: peek each one's leading
        byte (zstd frames start 0x28, the zlib fallback streams 0x78) and
        check the matching vm_decompress_caps bit. This replaces the old
        all-or-nothing has_zstd() exclusion: zstd AND zlib-compressed
        blocks now ride the native path whenever the runtime codec
        resolved."""
        from .. import native as _native
        if not (bool((ts_mt >= 5).any()) or bool((val_mt >= 5).any())):
            return True
        caps = _native.decompress_caps()
        if caps & 3 == 3:
            return True
        hc = self.header_columns()
        for buf, off_k, mt in ((self._ts_buf, "ts_off", ts_mt),
                               (self._val_buf, "val_off", val_mt)):
            comp = np.flatnonzero(mt >= 5)
            if comp.size == 0:
                continue
            first = buf[np.ascontiguousarray(hc[off_k][idx])[comp]]
            is_zstd = first == 0x28
            if bool(is_zstd.any()) and not caps & 1:
                return False
            if bool((~is_zstd).any()) and not caps & 2:
                return False
        return True

    def _hdrs_compressed_decodable(self, hdrs) -> bool:
        """Per-header twin of _compressed_decodable for the list-of-
        BlockHeaders fallback path (read_blocks_columns)."""
        from .. import native as _native
        caps = _native.decompress_caps()
        if caps & 3 == 3:
            return True
        for h in hdrs:
            for mt, off, buf in (
                    (int(h.ts_marshal_type), h.ts_offset, self._ts_buf),
                    (int(h.val_marshal_type), h.val_offset, self._val_buf)):
                if mt >= 5 and \
                        not caps & (1 if buf[off] == 0x28 else 2):
                    return False
        return True

    def assemble_columns(self, mids_sorted, min_ts, max_ts):
        """Fused native part read (vm_assemble_part): ONE GIL-released
        call decodes every selected block's timestamp+value streams from
        the mmap'd part, clips rows to [min_ts, max_ts], converts kept
        mantissas straight to float64 with the block exponents and
        compacts into freshly allocated columns — no per-block Python, no
        intermediate mantissa arrays, fully-clipped blocks never decode
        their value stream. Returns a FLOAT piece (mids, cnts, ts,
        vals_f64); None when the native fused path is unavailable (caller
        falls back to the split path and converts); False when it RAN and
        nothing matched.

        An unclipped whole-part call memoizes the decoded float columns
        (same budget as the mantissa memo), so warm rolling-window
        refreshes are a native clip+gather with no decode at all."""
        from .. import native as _native
        if self._ts_buf is None or not _native.available():
            return None
        if (min_ts is not None and self.max_ts < min_ts) or \
                (max_ts is not None and self.min_ts > max_ts):
            # suffix-aware early-out: a part wholly outside the tail
            # window never builds header columns or scans membership
            return False
        hc, lo, hi, idx = self._select_blocks(mids_sorted, min_ts, max_ts)
        if idx.size == 0:
            return False
        dec = self._dec
        if dec is not None:
            kind, ts_full, data_full, goff_full = dec
            mids, cnts, scales, ts_k, d_k = _clip_gather(
                np.ascontiguousarray(hc["mid"][idx]),
                np.ascontiguousarray(hc["scale"][idx]),
                ts_full,
                data_full.view(np.int64) if kind == "float" else data_full,
                goff_full[idx], goff_full[idx + 1], min_ts, max_ts)
            if not ts_k.size:
                return False
            if kind == "float":
                return mids, cnts, ts_k, d_k.view(np.float64)
            return _piece_to_float((mids, cnts, scales, ts_k, d_k))
        ts_mt = np.ascontiguousarray(hc["ts_mt"][idx])
        val_mt = np.ascontiguousarray(hc["val_mt"][idx])
        if not self._compressed_decodable(idx, ts_mt, val_mt):
            return None
        cnt = np.ascontiguousarray(hc["rows"][idx])
        total = int(cnt.sum())
        mids = np.ascontiguousarray(hc["mid"][idx])
        scales = np.ascontiguousarray(hc["scale"][idx])
        # when the query touches every block of the part, decode UNCLIPPED
        # so the whole-part float memo can build even though this query
        # clips rows (the split path memoizes its pre-clip decode the same
        # way) — the query is then served by clip+gather over the decode,
        # and every later rolling refresh skips the decode entirely
        whole = idx.size == hc["mid"].size
        klo, khi = (-(1 << 62), 1 << 62) if whole else (lo, hi)
        kept, ts_k, vals_k = _native.assemble_part(
            self._ts_buf, self._val_buf,
            np.ascontiguousarray(hc["ts_off"][idx]),
            np.ascontiguousarray(hc["ts_size"][idx]), ts_mt,
            np.ascontiguousarray(hc["ts_first"][idx]),
            np.ascontiguousarray(hc["val_off"][idx]),
            np.ascontiguousarray(hc["val_size"][idx]), val_mt,
            np.ascontiguousarray(hc["val_first"][idx]),
            cnt, scales, klo, khi)
        if whole:
            self._maybe_memoize("float", ts_k, vals_k, cnt, idx.size, total)
            goff = np.empty(idx.size + 1, np.int64)
            goff[0] = 0
            np.cumsum(cnt, out=goff[1:])
            mids, cnts, _, ts_c, d_c = _clip_gather(
                mids, scales, ts_k, vals_k.view(np.int64), goff[:-1],
                goff[1:], min_ts, max_ts,
                unchanged=(mids, cnt, scales, ts_k,
                           vals_k.view(np.int64)))
            if not ts_c.size:
                return False
            return mids, cnts, ts_c, d_c.view(np.float64)
        if ts_k.size == 0:
            return False
        nz = kept > 0
        if not nz.all():
            return mids[nz], kept[nz], ts_k, vals_k
        return mids, kept, ts_k, vals_k

    def read_blocks_columns(self, hdrs: list[BlockHeader]):
        """Batched decode of many blocks in ONE native call per stream
        (vm_decode_blocks): returns (ts_concat int64, mant_concat int64),
        laid out block-after-block in `hdrs` order. The netstorage
        unpack-worker analog (netstorage.go:374-404) — here the workers are
        replaced by a single vectorized native pass over the mmap'd part.
        Falls back to the per-block Python path when native/mmap is
        unavailable."""
        from .. import native as _native
        K = len(hdrs)
        cnt = np.fromiter((h.rows for h in hdrs), np.int64, K)
        total = int(cnt.sum())
        zstd_blocks = any(int(h.ts_marshal_type) >= 5 or
                          int(h.val_marshal_type) >= 5 for h in hdrs)
        if self._ts_buf is None or not _native.available() or \
                (zstd_blocks and not self._hdrs_compressed_decodable(hdrs)):
            blocks = [self.read_block(h) for h in hdrs]
            ts_all = (np.concatenate([b.timestamps for b in blocks])
                      if blocks else np.zeros(0, np.int64))
            m_all = (np.concatenate([b.values for b in blocks])
                     if blocks else np.zeros(0, np.int64))
            return ts_all, m_all
        ts_out = np.empty(total, np.int64)
        m_out = np.empty(total, np.int64)
        off = np.fromiter((h.ts_offset for h in hdrs), np.int64, K)
        sz = np.fromiter((h.ts_size for h in hdrs), np.int64, K)
        mt = np.fromiter((int(h.ts_marshal_type) for h in hdrs), np.int32, K)
        first = np.fromiter((h.ts_first for h in hdrs), np.int64, K)
        _native.decode_blocks(self._ts_buf, off, sz, mt, first, cnt, ts_out,
                              validate_ts=True)
        off = np.fromiter((h.val_offset for h in hdrs), np.int64, K)
        sz = np.fromiter((h.val_size for h in hdrs), np.int64, K)
        mt = np.fromiter((int(h.val_marshal_type) for h in hdrs), np.int32, K)
        first = np.fromiter((h.val_first for h in hdrs), np.int64, K)
        _native.decode_blocks(self._val_buf, off, sz, mt, first, cnt, m_out,
                              validate_ts=False)
        return ts_out, m_out
