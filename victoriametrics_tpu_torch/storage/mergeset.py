"""Sorted-byte-string LSM (capability of reference lib/mergeset: Table with
AddItems/search/CreateSnapshotAt, table.go:74,349,663; prefix-compressed 64KB
blocks, encoding.go:18-47).

Design (simplified for a single-writer host plane, same observable shape):

- pending items -> sorted in-memory parts (list[bytes]) -> immutable file
  parts, with merges collapsing duplicates (set semantics).
- file part layout: `items.bin` = concatenated zstd blocks of prefix-
  compressed items; `index.bin` = zstd'd block directory (first item,
  offset, size, count per block); `metadata.json`.
- search: merged iteration over pending/memory/file parts via heapq.merge;
  prefix scans binary-search the block directory.
- snapshots: hardlinks of immutable part files (fs.go:182 analog).

The port's copy of ``victoriametrics_tpu/storage/mergeset.py``, whole.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import os
import struct
import time
import zlib
from collections import OrderedDict

from ..devtools import faultinject
from ..devtools.locktrace import make_lock, make_rlock
from ..devtools.racetrace import traced_fields
from ..ops import compress as zstd
from ..ops.varint import marshal_varuint64, unmarshal_varuint64
from ..utils import flightrec, logger
from ..utils import fs as fslib
from ..utils import metrics as metricslib
from ..utils import workpool

_FLUSH_DURATION = metricslib.REGISTRY.histogram(
    'vm_storage_flush_duration_seconds{type="indexdb/mergeset"}')
_MERGE_DURATION = metricslib.REGISTRY.histogram(
    'vm_storage_merge_duration_seconds{type="indexdb/mergeset"}')
_MERGES_TOTAL = metricslib.REGISTRY.counter(
    'vm_merges_total{type="indexdb/mergeset"}')
_ACTIVE_MERGES = metricslib.REGISTRY.gauge(
    'vm_active_merges{type="indexdb/mergeset"}')
_ING_FLUSH = metricslib.ingest_phase("flush")
_ING_MERGE = metricslib.ingest_phase("merge")
_PARTS_QUARANTINED = metricslib.REGISTRY.counter(
    'vm_parts_quarantined_total{store="mergeset"}')
_PARTS_OPEN_ERRORS = metricslib.REGISTRY.counter(
    'vm_parts_open_errors_total{store="mergeset"}')

MAX_BLOCK_BYTES = 64 << 10
MAX_INMEMORY_PARTS = 15
MAX_PENDING_ITEMS = 64 << 10
# decoded-block cache: ~64KB of items per block; 512 blocks ~ 32MB+overhead
# (the indexdb/data blockcache analog of reference lib/blockcache)
MAX_CACHED_BLOCKS = 512


def _encode_block(items: list[bytes]) -> bytes:
    """Prefix-compress a run of sorted items, then zstd."""
    out = bytearray()
    prev = b""
    for it in items:
        common = os.path.commonprefix([prev, it])
        cp = len(common)
        out += marshal_varuint64(cp)
        out += marshal_varuint64(len(it) - cp)
        out += it[cp:]
        prev = it
    return zstd.compress(bytes(out))


def _decode_block(data: bytes, count: int) -> list[bytes]:
    raw = zstd.decompress(data)
    items = []
    prev = b""
    off = 0
    for _ in range(count):
        cp, off = unmarshal_varuint64(raw, off)
        sl, off = unmarshal_varuint64(raw, off)
        it = prev[:cp] + raw[off:off + sl]
        off += sl
        items.append(it)
        prev = it
    if off != len(raw):
        raise ValueError("mergeset block: trailing garbage")
    return items


@traced_fields("_block_cache")
class _FilePart:
    """Immutable on-disk sorted run."""

    def __init__(self, path: str, trusted: bool = False):
        self.path = path
        # integrity gate first: torn/bit-flipped parts must fail loudly
        # here (IntegrityError) so the table opener quarantines them.
        # `trusted` skips the payload re-read for parts THIS process just
        # finalized (it computed the checksums moments ago) — cold opens
        # always verify.
        meta = fslib.load_meta_json(os.path.join(path, "metadata.json"))
        if not trusted:
            fslib.verify_checksums(path, meta)
        self.item_count = meta["item_count"]
        idx_raw = zstd.decompress(
            open(os.path.join(path, "index.bin"), "rb").read())
        self.blocks = []  # (first_item, offset, size, count)
        off = 0
        while off < len(idx_raw):
            flen, off = unmarshal_varuint64(idx_raw, off)
            first = idx_raw[off:off + flen]
            off += flen
            boff, off = unmarshal_varuint64(idx_raw, off)
            bsize, off = unmarshal_varuint64(idx_raw, off)
            cnt, off = unmarshal_varuint64(idx_raw, off)
            self.blocks.append((first, boff, bsize, cnt))
        self._firsts = [b[0] for b in self.blocks]
        self._f = open(os.path.join(path, "items.bin"), "rb")
        self._lock = make_lock("mergeset._FilePart._lock")
        self._block_cache: "OrderedDict[int, list[bytes]]" = OrderedDict()

    def close(self):
        self._f.close()

    def _read_block(self, i: int) -> list[bytes]:
        with self._lock:
            got = self._block_cache.get(i)
            if got is not None:
                self._block_cache.move_to_end(i)
                return got
            first, off, size, cnt = self.blocks[i]
            self._f.seek(off)
            data = self._f.read(size)
        items = _decode_block(data, cnt)
        with self._lock:
            self._block_cache[i] = items
            self._block_cache.move_to_end(i)
            while len(self._block_cache) > MAX_CACHED_BLOCKS:
                self._block_cache.popitem(last=False)
        return items

    def iter_from(self, start: bytes):
        """Yield items >= start in order."""
        i = bisect.bisect_right(self._firsts, start) - 1
        i = max(i, 0)
        for bi in range(i, len(self.blocks)):
            items = self._read_block(bi)
            j = bisect.bisect_left(items, start) if bi == i else 0
            yield from items[j:]

    def first_ge(self, key: bytes) -> bytes | None:
        """First item >= key, or None (point-lookup fast path: decodes at
        most one cached block instead of setting up a merge iteration)."""
        i = max(bisect.bisect_right(self._firsts, key) - 1, 0)
        for bi in (i, i + 1):
            if bi >= len(self.blocks):
                return None
            items = self._read_block(bi)
            j = bisect.bisect_left(items, key)
            if j < len(items):
                return items[j]
        return None

    def iter_all(self):
        for bi in range(len(self.blocks)):
            yield from self._read_block(bi)

    @staticmethod
    def write(path: str, items_iter, tmp_suffix=".tmp") -> int:
        """Stream sorted unique items into a new part dir; returns count."""
        tmp = path + tmp_suffix
        os.makedirs(tmp, exist_ok=True)
        index = bytearray()
        count = 0
        items_crc = 0
        with open(os.path.join(tmp, "items.bin"), "wb") as f:
            block: list[bytes] = []
            bbytes = 0

            def flush_block():
                nonlocal block, bbytes, items_crc
                if not block:
                    return
                data = _encode_block(block)
                off = f.tell()
                index.extend(marshal_varuint64(len(block[0])))
                index.extend(block[0])
                index.extend(marshal_varuint64(off))
                index.extend(marshal_varuint64(len(data)))
                index.extend(marshal_varuint64(len(block)))
                f.write(data)
                items_crc = zlib.crc32(data, items_crc)
                block = []
                bbytes = 0

            for it in items_iter:
                block.append(it)
                bbytes += len(it) + 4
                count += 1
                if bbytes >= MAX_BLOCK_BYTES:
                    flush_block()
            flush_block()
            f.flush()
            os.fsync(f.fileno())
        idx_data = zstd.compress(bytes(index))
        with open(os.path.join(tmp, "index.bin"), "wb") as f:
            f.write(idx_data)
            f.flush()
            os.fsync(f.fileno())
        fslib.write_meta_json(
            os.path.join(tmp, "metadata.json"),
            {"item_count": count,
             "checksums": {"items.bin": items_crc,
                           "index.bin": zlib.crc32(idx_data)}})
        faultinject.fire("mergeset:flush")
        # atomic AND durable publish: rename + parent-dir fsync
        fslib.rename_durable(tmp, path)
        return count


def _dedup_sorted(it):
    prev = None
    for x in it:
        if x != prev:
            yield x
            prev = x


@traced_fields("_pending", "_pending_sorted", "_mem_parts", "_file_parts")
class Table:
    """The mergeset table: add_items / prefix search / snapshot."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._lock = make_rlock("mergeset.Table._lock")
        # serializes heavy mem->file / file->file merges per table; the
        # merge itself runs OUTSIDE _lock (immutable inputs), so adds
        # and searches proceed while a part is being written.  Ordering
        # is strictly _merge_mutex -> _lock, never the reverse.
        self._merge_mutex = make_rlock("mergeset.Table._merge_mutex")
        self._pending: list[bytes] = []
        self._pending_sorted: list[bytes] | None = []  # None = dirty
        self._mem_parts: list[list[bytes]] = []
        self._file_parts: list[_FilePart] = []
        self._part_seq = itertools.count()
        #: parts moved aside by the open-time integrity check (same
        #: quarantine semantics as storage data parts — loud, partial)
        self.quarantined: list[dict] = []
        self._open_existing()

    # -- lifecycle ---------------------------------------------------------

    def _open_existing(self):
        # previously quarantined parts keep the store loudly partial
        # across restarts (same persistence rule as data partitions)
        where = os.path.basename(self.path)
        self.quarantined.extend(fslib.resident_quarantine_entries(
            self.path, "mergeset", where))
        names = sorted(n for n in os.listdir(self.path)
                       if not n.endswith(".tmp") and
                       n != fslib.QUARANTINE_DIR and
                       os.path.isdir(os.path.join(self.path, n)))
        for n in names:
            try:
                # open-phase: runs from __init__ before the Table is
                # published to any other thread
                self._file_parts.append(  # vmt: disable=VMT015
                    _FilePart(os.path.join(self.path, n)))
            except (fslib.IntegrityError, ValueError, KeyError) as e:
                # torn/corrupt part: quarantine it LOUDLY (counter +
                # partial flag + status listing) instead of the old
                # warn-and-drop that silently lost index entries
                try:
                    self.quarantined.append(fslib.quarantine_dir_entry(
                        self.path, n, e, "mergeset", where))
                    _PARTS_QUARANTINED.inc()
                except OSError as move_err:
                    logger.errorf("mergeset: cannot quarantine part "
                                  "%s: %s", n, move_err)
                    self.quarantined.append(
                        {"store": "mergeset", "in": where, "part": n,
                         "path": os.path.join(self.path, n),
                         "error": str(e)})
                    _PARTS_OPEN_ERRORS.inc()
            except OSError as e:
                # transient open failure (fd exhaustion, permissions):
                # keep the part in place — a fixed environment serves it
                # again — but report it loudly meanwhile
                logger.errorf("mergeset %s: cannot open part %s (kept in "
                              "place, serving partial): %s", where, n, e)
                self.quarantined.append(
                    {"store": "mergeset", "in": where, "part": n,
                     "path": os.path.join(self.path, n), "error": str(e)})
                _PARTS_OPEN_ERRORS.inc()
        # tmp dirs are leftovers from a crash mid-write
        for n in os.listdir(self.path):
            if n.endswith(".tmp"):
                import shutil
                shutil.rmtree(os.path.join(self.path, n), ignore_errors=True)
        if self._file_parts:
            seqs = [int(os.path.basename(p.path).split("_")[1])
                    for p in self._file_parts]
            # open-phase (see above): pre-publication, thread-local
            self._part_seq = itertools.count(max(seqs) + 1)  # vmt: disable=VMT015

    def close(self):
        self.flush_to_disk()
        with self._lock:
            for p in self._file_parts:
                p.close()
            self._file_parts.clear()

    # -- writes ------------------------------------------------------------

    def add_items(self, items) -> None:
        with self._lock:
            items = list(items)
            self._pending.extend(items)
            # keep the sorted view incrementally: series churn interleaves
            # point lookups with small add batches, and a full re-sort per
            # lookup would be quadratic in churn
            if self._pending_sorted is not None and len(items) <= 64:
                for it in items:
                    bisect.insort(self._pending_sorted, it)
            else:
                self._pending_sorted = None
            compact = False
            if len(self._pending) >= MAX_PENDING_ITEMS:
                self._flush_pending_locked()
                compact = len(self._mem_parts) > MAX_INMEMORY_PARTS
        if compact:
            # the heavy merge runs OUTSIDE _lock: concurrent add_items
            # and searches proceed while the part is written; the
            # threshold is re-checked under the merge mutex so queued
            # adders don't stampede into serial tiny compactions
            self._compact_mem_parts(min_parts=MAX_INMEMORY_PARTS + 1)

    def _flush_pending_locked(self):
        if not self._pending:
            return
        part = sorted(set(self._pending))
        self._pending = []
        self._pending_sorted = []
        self._mem_parts.append(part)

    def _sorted_pending_locked(self) -> list[bytes]:
        if self._pending_sorted is None:
            self._pending_sorted = sorted(set(self._pending))
        return self._pending_sorted

    def _compact_mem_parts(self, min_parts: int = 1):
        """Merge the in-memory parts into one file part.  The write runs
        with no data lock held (mem parts are immutable once listed) and
        under the process-wide MERGE_GATE, so index compactions and data
        part writes together stay bounded at VM_MERGE_WORKERS.

        `min_parts` is re-checked AFTER the merge mutex is acquired:
        concurrent adders that all crossed the threshold queue here, and
        the first compaction usually swallows every mem part — the rest
        must not each write a near-empty file part."""
        with self._merge_mutex:
            with self._lock:
                mems = list(self._mem_parts)
            if len(mems) < min_parts:
                return
            with workpool.MERGE_GATE:
                # timed inside the gate: pure write time (queue wait is
                # visible as vm_merge_pending)
                t0 = time.perf_counter()
                merged = _dedup_sorted(heapq.merge(*mems))
                name = f"part_{next(self._part_seq):016d}"
                p = os.path.join(self.path, name)
                _FilePart.write(p, merged)
                dt = time.perf_counter() - t0
            with self._lock:
                flushed = {id(m) for m in mems}
                self._mem_parts = [m for m in self._mem_parts
                                   if id(m) not in flushed]
                self._file_parts.append(_FilePart(p, trusted=True))
                merge_files = len(self._file_parts) > MAX_INMEMORY_PARTS
            _FLUSH_DURATION.update(dt)
            _ING_FLUSH.inc(dt)
            flightrec.rec("flush:index", t0, dt)
        if merge_files:
            self._merge_file_parts()

    def _merge_file_parts(self):
        """Collapse every file part into one (set semantics); the k-way
        merge runs outside _lock — readers keep iterating the old parts
        (open fds keep the bytes alive) until the swap."""
        with self._merge_mutex:
            with self._lock:
                olds = list(self._file_parts)
            if len(olds) <= 1:
                return
            _ACTIVE_MERGES.inc()
            try:
                with workpool.MERGE_GATE:
                    t0 = time.perf_counter()
                    merged = _dedup_sorted(
                        heapq.merge(*[p.iter_all() for p in olds]))
                    name = f"part_{next(self._part_seq):016d}"
                    p = os.path.join(self.path, name)
                    _FilePart.write(p, merged)
                    dt = time.perf_counter() - t0
                new_part = _FilePart(p, trusted=True)
                with self._lock:
                    keep = [q for q in self._file_parts if q not in olds]
                    self._file_parts = [new_part] + keep
                # success only: aborted merges must not count as progress
                _MERGE_DURATION.update(dt)
                _ING_MERGE.inc(dt)
                _MERGES_TOTAL.inc()
                flightrec.rec("merge:index", t0, dt)
            finally:
                _ACTIVE_MERGES.dec()
            for old in olds:
                # Unlink only: concurrent readers may still iterate `old`;
                # the open fds keep the data alive until the last
                # reference drops (the part-refcount pattern, via GC).
                import shutil
                shutil.rmtree(old.path, ignore_errors=True)

    def flush_to_disk(self):
        """Durably persist everything buffered (shutdown / snapshot prep)."""
        with self._merge_mutex:
            with self._lock:
                self._flush_pending_locked()
            self._compact_mem_parts()

    def force_merge(self):
        self.flush_to_disk()
        self._merge_file_parts()

    # -- reads -------------------------------------------------------------

    def _sources_from(self, start: bytes):
        with self._lock:
            # copy: the live sorted-pending list mutates under concurrent
            # add_items insorts while these iterators are being consumed
            pending = list(self._sorted_pending_locked())
            mems = list(self._mem_parts)
            files = list(self._file_parts)
        srcs = []
        if pending:
            i = bisect.bisect_left(pending, start)
            srcs.append(iter(pending[i:]))
        for m in mems:
            i = bisect.bisect_left(m, start)
            srcs.append(iter(m[i:]))
        for fp in files:
            srcs.append(fp.iter_from(start))
        return srcs

    def iter_from(self, start: bytes):
        """All items >= start, sorted, deduped."""
        return _dedup_sorted(heapq.merge(*self._sources_from(start)))

    def search_prefix(self, prefix: bytes):
        """All items with the given prefix."""
        for it in self.iter_from(prefix):
            if not it.startswith(prefix):
                return
            yield it

    def has_item(self, item: bytes) -> bool:
        return self.first_with_prefix(item) == item

    def first_with_prefix(self, prefix: bytes) -> bytes | None:
        """Point lookup: the smallest item with the given prefix, or None.
        Bisects each source directly (no merge-iterator setup, cached block
        decode) — the hot path for unique-key namespaces."""
        best: bytes | None = None
        with self._lock:
            # bisect the mutable lists while still holding the lock —
            # concurrent insorts would shift indices under our feet
            pending = self._sorted_pending_locked()
            for lst in ([pending] if pending else []) + self._mem_parts:
                i = bisect.bisect_left(lst, prefix)
                if i < len(lst) and (best is None or lst[i] < best):
                    best = lst[i]
            files = list(self._file_parts)
        for fp in files:
            it = fp.first_ge(prefix)
            if it is not None and (best is None or it < best):
                best = it
        if best is not None and best.startswith(prefix):
            return best
        return None

    def item_count(self) -> int:
        with self._lock:
            n = len(self._pending) + sum(len(m) for m in self._mem_parts)
            n += sum(p.item_count for p in self._file_parts)
        return n  # approximate: duplicates across parts counted once each

    # -- snapshots ---------------------------------------------------------

    def create_snapshot_at(self, dst: str):
        """Hardlink-copy all immutable file parts (in-memory state is flushed
        first, like reference CreateSnapshotAt table.go:349)."""
        self.flush_to_disk()
        os.makedirs(dst, exist_ok=True)
        with self._lock:
            for fp in self._file_parts:
                name = os.path.basename(fp.path)
                pdst = os.path.join(dst, name)
                os.makedirs(pdst, exist_ok=True)
                for fn in os.listdir(fp.path):
                    os.link(os.path.join(fp.path, fn), os.path.join(pdst, fn))
        fslib.fsync_dir(dst)  # snapshot dir entries durable, like parts
