"""Monthly partition LSM (reference lib/storage/partition.go:75).

Write path per partition (partition.go:461-877 analog, single-writer):
  pending raw rows -> (flush, 2s or size cap) in-memory parts
  in-memory parts  -> (flush, 5s durability) small file parts
  small parts      -> merged into bigger parts (k-way by (tsid, min_ts)),
                      dropping deleted series and out-of-retention rows

parts.json lists live file parts; it is rewritten atomically after every
structural change so a crash leaves either the old or the new part set
(partition.go:282-295 analog). Unlisted dirs are removed at open.

The port's copy of ``victoriametrics_tpu/storage/partition.py``, whole.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import shutil
import time

import numpy as np

from ..devtools import faultinject
from ..devtools.locktrace import make_rlock
from ..devtools.racetrace import traced_fields
from ..utils import flightrec, logger
from ..utils import fs as fslib
from ..utils import metrics as metricslib
from ..utils import workpool
from . import downsample as dslib
from .block import MAX_ROWS_PER_BLOCK, Block, rows_to_blocks
from .dedup import deduplicate
from .part import Part, PartWriter

# engine self-metrics (reference vm_active_merges / vm_merges_total per
# part type): flush = pending+mem parts -> one small file part; merge =
# small file parts -> one bigger part
_FLUSH_DURATION = metricslib.REGISTRY.histogram(
    'vm_storage_flush_duration_seconds{type="storage/small"}')
_MERGE_DURATION = metricslib.REGISTRY.histogram(
    'vm_storage_merge_duration_seconds{type="storage/file"}')
_MERGES_TOTAL = metricslib.REGISTRY.counter(
    'vm_merges_total{type="storage/file"}')
_ACTIVE_MERGES = metricslib.REGISTRY.gauge(
    'vm_active_merges{type="storage/file"}')
_ING_FLUSH = metricslib.ingest_phase("flush")
_ING_MERGE = metricslib.ingest_phase("merge")
_SPILL_ERRORS = metricslib.REGISTRY.counter("vm_ingest_spill_errors_total")
# torn/corrupt parts moved aside at open instead of being served or
# silently dropped (one series per store kind; mergeset ticks its own)
_PARTS_QUARANTINED = metricslib.REGISTRY.counter(
    'vm_parts_quarantined_total{store="storage"}')
# listed parts that failed to open but were KEPT IN PLACE (transient
# OSError / failed quarantine move): loud and partial, but NOT moved —
# the quarantined counter must mean what its name says
_PARTS_OPEN_ERRORS = metricslib.REGISTRY.counter(
    'vm_parts_open_errors_total{store="storage"}')

QUARANTINE_DIR = fslib.QUARANTINE_DIR
quarantine_dir_entry = fslib.quarantine_dir_entry

MAX_PENDING_ROWS = 256 << 10
MAX_SMALL_PARTS = 15
# async pending->InmemoryPart conversions in flight per partition before
# the ingest thread blocks on the oldest: 2 keeps the produce/convert
# pipeline full while bounding both resident raw rows (~3x cap) and how
# long a reader's visibility barrier can wait behind conversions
_MAX_INFLIGHT_PARTS = 2
# merged blocks span at most this much time, so tail fetches prune at the
# block-header level instead of decoding a series' whole history (0 = off).
# The rows floor keeps sparse series (e.g. 1/min scrapes) from exploding
# into tiny blocks: a span split never produces blocks under 256 rows, so
# header/index overhead stays <~0.4B per sample.
MAX_BLOCK_SPAN_MS = int(os.environ.get("VM_BLOCK_SPAN_MS", 3600 * 1000))
MIN_SPAN_SPLIT_ROWS = 256
# blocks buffered per bulk-marshal call on the flush/merge write path
# (bounds the transient concat memory: ~8k blocks x 8k rows x 16B = cap)
_BULK_WRITE_BLOCKS = 4096


class InmemoryPart:
    """Sorted blocks held in RAM (inmemoryPart analog)."""

    def __init__(self, blocks: list[Block]):
        self._blocks = blocks
        self._segs = None
        self._lazy = None
        self.rows = sum(b.rows for b in blocks)
        self.min_ts = min((int(b.timestamps[0]) for b in blocks),
                          default=1 << 62)
        self.max_ts = max((int(b.timestamps[-1]) for b in blocks),
                          default=-(1 << 62))
        self._cols = None

    @classmethod
    def from_columns(cls, segs, all_ts, mants, exps, precision_bits=64):
        """Columnar-first construction (the query-time pending view):
        Block objects are only materialized if a legacy per-block consumer
        iterates them; the batched fetch path reads the arrays directly."""
        self = cls.__new__(cls)
        self._blocks = None
        self._lazy = None
        self._segs = (segs, all_ts, mants, exps, precision_bits)
        self.rows = int(all_ts.size)
        self.min_ts = int(all_ts.min()) if all_ts.size else 1 << 62
        self.max_ts = int(all_ts.max()) if all_ts.size else -(1 << 62)
        K = len(segs)
        mids = np.fromiter((t.metric_id for t, _, _ in segs), np.uint64,
                           K).astype(np.int64)
        starts = np.fromiter((a for _, a, _ in segs), np.int64, K)
        ends = np.fromiter((b for _, _, b in segs), np.int64, K)
        cnts = ends - starts
        bmin = all_ts[starts] if K else np.zeros(0, np.int64)
        bmax = all_ts[ends - 1] if K else np.zeros(0, np.int64)
        self._cols = (mids, cnts, np.asarray(exps, np.int64), bmin, bmax,
                      starts, all_ts, mants)
        return self

    @classmethod
    def from_seg_arrays(cls, starts, ends, mids_sorted, tsid_at, all_ts,
                        mants, exps, precision_bits=64):
        """Fully array-backed construction: per-block TSID objects resolve
        LAZILY (tsid_at(row_index) -> TSID) only if a legacy per-block
        consumer iterates — the columnar fetch path never pays the
        per-series Python object loop."""
        self = cls.__new__(cls)
        self._blocks = None
        self._segs = None
        self._lazy = (starts, ends, tsid_at, precision_bits)
        self.rows = int(all_ts.size)
        self.min_ts = int(all_ts.min()) if all_ts.size else 1 << 62
        self.max_ts = int(all_ts.max()) if all_ts.size else -(1 << 62)
        cnts = ends - starts
        bmin = all_ts[starts] if starts.size else np.zeros(0, np.int64)
        bmax = all_ts[ends - 1] if starts.size else np.zeros(0, np.int64)
        self._cols = (mids_sorted[starts].astype(np.int64), cnts,
                      np.asarray(exps, np.int64), bmin, bmax, starts,
                      all_ts, mants)
        return self

    @property
    def block_list(self):
        if self._blocks is None:
            if self._segs is not None:
                segs, all_ts, mants, exps, prec = self._segs
                self._blocks = [
                    Block(tsid, all_ts[a:b], mants[a:b], int(exps[k]), prec)
                    for k, (tsid, a, b) in enumerate(segs)]
            else:
                starts, ends, tsid_at, prec = self._lazy
                _, _, exps, _, _, _, all_ts, mants = self._cols
                self._blocks = [
                    Block(tsid_at(int(a)), all_ts[a:b], mants[a:b],
                          int(exps[k]), prec)
                    for k, (a, b) in enumerate(zip(starts, ends))]
        return self._blocks

    def iter_blocks(self, tsid_set=None, min_ts=None, max_ts=None):
        for b in self.block_list:
            if tsid_set is not None and b.tsid.metric_id not in tsid_set:
                continue
            if min_ts is not None and int(b.timestamps[-1]) < min_ts:
                continue
            if max_ts is not None and int(b.timestamps[0]) > max_ts:
                continue
            yield b

    def columns(self):
        """Lazily built columnar view (the part is immutable): per-block
        metadata arrays + concatenated sample columns, so query-time block
        collection is numpy masking instead of per-block Python — the
        fixed per-series cost of the fresh-data fetch path."""
        c = self._cols
        if c is None:
            K = len(self.block_list)
            bl = self.block_list
            mids = np.fromiter((b.tsid.metric_id for b in bl), np.int64, K)
            cnts = np.fromiter((b.rows for b in bl), np.int64, K)
            scales = np.fromiter((b.scale for b in bl), np.int64, K)
            bmin = np.fromiter((b.timestamps[0] for b in bl), np.int64, K)
            bmax = np.fromiter((b.timestamps[-1] for b in bl), np.int64, K)
            if K:
                ts_all = np.concatenate([b.timestamps for b in bl])
                m_all = np.concatenate([b.values for b in bl])
            else:
                ts_all = np.zeros(0, np.int64)
                m_all = np.zeros(0, np.int64)
            offs = np.cumsum(cnts) - cnts
            c = (mids, cnts, scales, bmin, bmax, offs, ts_all, m_all)
            self._cols = c
        return c

    def collect_columns(self, mids_sorted, min_ts, max_ts):
        """Vectorized block selection -> (mids, cnts, scales, ts, mants)
        or None when nothing matches. `mids_sorted` is a sorted int64 array
        of wanted metric ids (None = all)."""
        from .part import sorted_member_mask
        mids, cnts, scales, bmin, bmax, offs, ts_all, m_all = self.columns()
        lo = -(1 << 62) if min_ts is None else min_ts
        hi = (1 << 62) if max_ts is None else max_ts
        mask = (bmax >= lo) & (bmin <= hi) & \
            sorted_member_mask(mids_sorted, mids)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        sel_cnts = cnts[idx]
        tot = int(sel_cnts.sum())
        excl = np.cumsum(sel_cnts) - sel_cnts
        pos = np.repeat(offs[idx] - excl, sel_cnts) + \
            np.arange(tot, dtype=np.int64)
        return (mids[idx], sel_cnts, scales[idx], ts_all[pos], m_all[pos])


class PendingChunk:
    """A columnar ingest batch parked in a partition's pending list: dense
    id rows resolved by the native key map (Storage.add_rows_columnar).
    Per-id TSID sort-key columns live in the owning id space, so chunk
    construction is pure numpy gathers — no per-row Python objects exist
    anywhere on the columnar ingest hot path."""

    __slots__ = ("space", "ids", "ts", "vals")

    def __init__(self, space, ids, ts, vals):
        self.space = space
        self.ids = ids
        self.ts = ts
        self.vals = vals

    def __len__(self):
        return int(self.ids.size)


def _rows_to_inmemory_part(rows: list, precision_bits: int = 64) -> InmemoryPart:
    """rows: list of (TSID, ts_ms, float_value) tuples and/or PendingChunks.
    Sorts by (tsid, ts) and builds <=8k-row blocks (createInmemoryPart,
    partition.go:877 analog).

    The float->decimal conversion is BATCHED across all blocks
    (float_to_decimal_grouped): per-series scrape flushes produce thousands
    of ~tens-of-rows blocks, where per-block conversion overhead dominates
    the flush."""
    if any(isinstance(r, PendingChunk) for r in rows):
        return _mixed_to_inmemory_part(rows, precision_bits)
    from ..ops.decimal import float_to_decimal_grouped
    from .block import MAX_ROWS_PER_BLOCK, Block
    n = len(rows)
    if n > 512:
        # vectorized (tsid sort_key, ts) ordering: the tuple-key list sort
        # costs ~25us/row in Python and dominates query-visible pending
        # conversion during live ingest
        acc = np.fromiter((r[0].account_id for r in rows), np.uint64, n)
        proj = np.fromiter((r[0].project_id for r in rows), np.uint64, n)
        grp = np.fromiter((r[0].metric_group_id for r in rows),
                          np.uint64, n)
        job = np.fromiter((r[0].job_id for r in rows), np.uint64, n)
        inst = np.fromiter((r[0].instance_id for r in rows), np.uint64, n)
        mid = np.fromiter((r[0].metric_id for r in rows), np.uint64, n)
        all_ts = np.fromiter((r[1] for r in rows), np.int64, n)
        all_vals = np.fromiter((r[2] for r in rows), np.float64, n)
        order = np.lexsort((all_ts, mid, inst, job, grp, proj, acc))
        rows = [rows[i] for i in order]
        all_ts = all_ts[order]
        all_vals = all_vals[order]
        mid = mid[order]
        series_starts = np.concatenate(
            [[0], np.flatnonzero(mid[1:] != mid[:-1]) + 1, [n]]) \
            if n else np.array([0, 0])
    else:
        rows.sort(key=lambda r: (r[0].sort_key(), r[1]))
        all_ts = np.fromiter((r[1] for r in rows), dtype=np.int64, count=n)
        all_vals = np.fromiter((r[2] for r in rows), dtype=np.float64,
                               count=n)
        series_starts = None
    segs = []          # (tsid, start, end) per block
    if series_starts is not None:
        for a, b in zip(series_starts[:-1], series_starts[1:]):
            tsid = rows[a][0]
            for x in range(a, b, MAX_ROWS_PER_BLOCK):
                segs.append((tsid, x, min(x + MAX_ROWS_PER_BLOCK, b)))
    else:
        i = 0
        while i < n:
            j = i
            tsid = rows[i][0]
            while j < n and rows[j][0].metric_id == tsid.metric_id:
                j += 1
            for a in range(i, j, MAX_ROWS_PER_BLOCK):
                segs.append((tsid, a, min(a + MAX_ROWS_PER_BLOCK, j)))
            i = j
    if not segs:
        return InmemoryPart([])
    starts = np.array([a for _, a, _ in segs], dtype=np.int64)
    m_all, exps = float_to_decimal_grouped(all_vals, starts)
    return InmemoryPart.from_columns(segs, all_ts, m_all, exps,
                                     precision_bits)


def _mixed_to_inmemory_part(items: list, precision_bits: int) -> InmemoryPart:
    """Columnar InmemoryPart construction over a mix of PendingChunks and
    legacy (TSID, ts, val) tuples: sort-key columns are gathered/concatenated
    and lexsorted; TSID objects are resolved per BLOCK (not per row) via
    (owner, loc) provenance arrays."""
    from ..ops.decimal import float_to_decimal_grouped
    from .block import MAX_ROWS_PER_BLOCK
    chunks = [x for x in items if isinstance(x, PendingChunk)]
    tups = [x for x in items if not isinstance(x, PendingChunk)]
    accs, projs, grps, jobs, insts, mids = [], [], [], [], [], []
    tss, valss, owners, locs = [], [], [], []
    n_t = len(tups)
    if n_t:
        accs.append(np.fromiter((r[0].account_id for r in tups), np.uint64, n_t))
        projs.append(np.fromiter((r[0].project_id for r in tups), np.uint64, n_t))
        grps.append(np.fromiter((r[0].metric_group_id for r in tups), np.uint64, n_t))
        jobs.append(np.fromiter((r[0].job_id for r in tups), np.uint64, n_t))
        insts.append(np.fromiter((r[0].instance_id for r in tups), np.uint64, n_t))
        mids.append(np.fromiter((r[0].metric_id for r in tups), np.uint64, n_t))
        tss.append(np.fromiter((r[1] for r in tups), np.int64, n_t))
        valss.append(np.fromiter((r[2] for r in tups), np.float64, n_t))
        owners.append(np.full(n_t, -1, np.int64))
        locs.append(np.arange(n_t, dtype=np.int64))
    for ci, ch in enumerate(chunks):
        ids = ch.ids
        sp = ch.space
        accs.append(sp.acc[ids])
        projs.append(sp.proj[ids])
        grps.append(sp.grp[ids])
        jobs.append(sp.job[ids])
        insts.append(sp.inst[ids])
        mids.append(sp.mid[ids])
        tss.append(ch.ts)
        valss.append(ch.vals)
        owners.append(np.full(ids.size, ci, np.int64))
        locs.append(ids)
    acc = np.concatenate(accs)
    proj = np.concatenate(projs)
    grp = np.concatenate(grps)
    job = np.concatenate(jobs)
    inst = np.concatenate(insts)
    mid = np.concatenate(mids)
    all_ts = np.concatenate(tss)
    all_vals = np.concatenate(valss)
    owner = np.concatenate(owners)
    loc = np.concatenate(locs)
    n = int(all_ts.size)
    if n == 0:
        return InmemoryPart([])
    order = np.lexsort((all_ts, mid, inst, job, grp, proj, acc))
    all_ts = all_ts[order]
    all_vals = all_vals[order]
    mid = mid[order]
    owner = owner[order]
    loc = loc[order]
    series_starts = np.concatenate(
        [[0], np.flatnonzero(mid[1:] != mid[:-1]) + 1, [n]]).astype(np.int64)

    def tsid_at(r: int):
        o = owner[r]
        return tups[loc[r]][0] if o < 0 else chunks[o].space.tsids[loc[r]]

    lens = np.diff(series_starts)
    if int(lens.max(initial=0)) <= MAX_ROWS_PER_BLOCK:
        # common case (scrape batches are tiny per series): one block per
        # series, fully vectorized — no per-series Python loop
        starts = series_starts[:-1]
        ends = series_starts[1:]
    else:
        pieces_s = []
        pieces_e = []
        for a, b in zip(series_starts[:-1], series_starts[1:]):
            xs = np.arange(a, b, MAX_ROWS_PER_BLOCK, dtype=np.int64)
            pieces_s.append(xs)
            pieces_e.append(np.minimum(xs + MAX_ROWS_PER_BLOCK, b))
        starts = np.concatenate(pieces_s)
        ends = np.concatenate(pieces_e)
    if starts.size == 0:
        return InmemoryPart([])
    m_all, exps = float_to_decimal_grouped(all_vals, starts)
    return InmemoryPart.from_seg_arrays(starts, ends, mid, tsid_at, all_ts,
                                        m_all, exps, precision_bits)


def _merge_block_streams(sources, deleted_ids: np.ndarray | None,
                         min_valid_ts: int | None,
                         dedup_interval: int = 0):
    """K-way merge of block iterators into (tsid, ts)-ordered blocks, with
    tombstone / retention / dedup filtering (mergeBlockStreams, merge.go:19
    analog). Yields Blocks."""
    del_set = set(int(x) for x in deleted_ids) if deleted_ids is not None else set()

    def keyed(src):
        for b in src:
            yield ((b.tsid.sort_key(), int(b.timestamps[0])), b)

    pending_tsid = None
    pend_ts: list[np.ndarray] = []
    pend_vals: list[np.ndarray] = []
    pend_scales: list[int] = []

    def flush():
        nonlocal pend_ts, pend_vals, pend_scales, pending_tsid
        if pending_tsid is None:
            return []
        from ..ops import decimal as dec
        # merge rows of one series across source blocks
        ts = np.concatenate(pend_ts)
        if len(set(pend_scales)) == 1:
            vals = np.concatenate(pend_vals)
            scale = pend_scales[0]
        else:
            floats = np.concatenate([
                dec.decimal_to_float(v, s)
                for v, s in zip(pend_vals, pend_scales)])
            vals, scale = dec.float_to_decimal(floats)
        order = np.argsort(ts, kind="stable")
        ts = ts[order]
        vals = vals[order]
        if min_valid_ts is not None:
            keep = ts >= min_valid_ts
            ts, vals = ts[keep], vals[keep]
        if dedup_interval > 0:
            ts, vals = deduplicate(ts, vals, dedup_interval)
        out = []
        tsid = pending_tsid
        # split by row cap AND time span: span-capped blocks keep the
        # header-level time pruning effective after big merges collapse a
        # series into few blocks, so a tail fetch decodes O(tail) rows (the
        # reference's 8k-row cap does this implicitly at real scrape rates,
        # lib/storage/block.go:15)
        i, n = 0, int(ts.size)
        while i < n:
            j = min(i + MAX_ROWS_PER_BLOCK, n)
            if MAX_BLOCK_SPAN_MS > 0 and j > i + MIN_SPAN_SPLIT_ROWS:
                j_span = i + int(np.searchsorted(
                    ts[i:j], ts[i] + MAX_BLOCK_SPAN_MS, side="left"))
                if j_span < j:
                    j = max(i + MIN_SPAN_SPLIT_ROWS, j_span)
            out.append(Block(tsid, ts[i:j], vals[i:j], scale))
            i = j
        pending_tsid = None
        pend_ts, pend_vals, pend_scales = [], [], []
        return out

    for _, b in heapq.merge(*(keyed(s) for s in sources), key=lambda kv: kv[0]):
        if b.tsid.metric_id in del_set:
            continue
        if pending_tsid is not None and b.tsid.metric_id != pending_tsid.metric_id:
            yield from flush()
        if pending_tsid is None:
            pending_tsid = b.tsid
        pend_ts.append(b.timestamps)
        pend_vals.append(b.values)
        pend_scales.append(b.scale)
    yield from flush()


@traced_fields("_pending", "_pending_nrows", "_pending_parts",
               "_pending_off", "_pending_gen", "_mem_parts", "_file_parts",
               "_pending_inflight", "_inflight_nrows", "_spill_done",
               "_spill_next")
class Partition:
    """One month of data ("2006_01" naming, time.go:79 analog)."""

    def __init__(self, path: str, name: str, dedup_interval_ms: int = 0):
        self.path = path
        self.name = name
        self.dedup_interval_ms = dedup_interval_ms
        self._lock = make_rlock("storage.Partition._lock")
        # serializes whole flush/merge operations (heavy part writes run
        # outside _lock so ingest/reads never stall behind them)
        self._flush_mutex = make_rlock("storage.Partition._flush_mutex")
        self._pending: list = []        # row tuples and/or PendingChunks
        self._pending_nrows = 0
        # incremental InmemoryPart views over _pending: each query converts
        # only rows ingested since the previous query (the flusher compacts
        # everything into one part every couple of seconds anyway);
        # _pending_gen detects a flush racing a lock-free conversion
        self._pending_parts: list = []
        self._pending_off = 0
        self._pending_gen = 0
        # cap-triggered pending conversions handed to the work pool.
        # Each conversion TASK lands its own part into _mem_parts under
        # _lock, strictly in spill-sequence order (_spill_done holds
        # out-of-order completions), so parts are byte-identical to the
        # sequential path; _pending_inflight only tracks completion
        # Futures for waiters — no consumer-side mutual exclusion is
        # needed, so waiters hold NO locks while pool-helping (a waiter
        # that held one could help-execute another partition's flush and
        # deadlock ABBA-style on the pair of consumer locks).
        self._pending_inflight: list = []
        self._inflight_nrows = 0
        self._spill_seq = 0       # next spill's sequence number
        self._spill_next = 0      # next sequence to land in _mem_parts
        self._spill_done: dict[int, tuple] = {}  # seq -> (part|None, nrows)
        self._mem_parts: list[InmemoryPart] = []
        self._file_parts: list[Part] = []
        self._seq = itertools.count()
        #: parts moved aside by the open-time integrity check (report
        #: entries; a non-empty list marks every result partial)
        self.quarantined: list[dict] = []
        #: listed parts that failed to open but were NOT moved (transient
        #: OSError, or the quarantine move itself failed): they must stay
        #: in parts.json — delisting them would hand the bytes to the
        #: next open's unlisted-dir sweep
        self._keep_listed: list[str] = []
        #: downsampled tiers by resolution_ms (ds_<res> dirs; see
        #: storage/downsample.py) — raw parts and tier parts never mix
        self._tiers: dict[int, "dslib.PartitionTier"] = {}
        os.makedirs(path, exist_ok=True)
        self._open_existing()

    # -- lifecycle ---------------------------------------------------------

    def _parts_json(self):
        return os.path.join(self.path, "parts.json")

    def _write_parts_json_locked(self):
        names = [os.path.basename(p.path) for p in self._file_parts]
        # broken-but-unmoved parts stay listed: the manifest is the only
        # thing standing between their bytes and the unlisted-dir sweep
        names += [n for n in self._keep_listed if n not in names]
        tmp = self._parts_json() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"parts": names}, f)
            f.flush()
            os.fsync(f.fileno())
        faultinject.fire("partition:parts_json:pre_replace")
        # replace + parent fsync: the manifest swap must be durable, not
        # just atomic — a crash after the rename but before the dir entry
        # hits disk could resurrect the OLD part list
        fslib.rename_durable(tmp, self._parts_json())

    def _open_existing(self):
        # parts quarantined by a PREVIOUS open still poison completeness:
        # report them (and serve partial) until the operator restores or
        # deletes them — a restart must not silently un-flag the loss
        self.quarantined.extend(fslib.resident_quarantine_entries(
            self.path, "storage", self.name))
        listed = []
        if os.path.exists(self._parts_json()):
            with open(self._parts_json()) as f:
                # corrupt parts.json = on-disk corruption, the same
                # true-internal-error class as a checksum mismatch: the
                # anonymous 500/error frame is the contract (operator
                # must inspect the partition, no client status helps)
                listed = json.load(f)["parts"]  # vmt: disable=VMT016
        for name in listed:
            p = os.path.join(self.path, name)
            try:
                # open-phase: runs from __init__ before the Partition is
                # published to any other thread
                self._file_parts.append(Part(p))  # vmt: disable=VMT015
            except (fslib.IntegrityError, ValueError, KeyError) as e:
                # torn/corrupt/unparsable LISTED part: move it to the
                # quarantine dir and serve LOUDLY PARTIAL — never the old
                # behavior of logging once and silently dropping the data
                # from every future result
                try:
                    self.quarantined.append(quarantine_dir_entry(
                        self.path, name, e, "storage", self.name))
                    _PARTS_QUARANTINED.inc()
                except OSError as move_err:
                    # cannot even move it (permissions?): keep the dir in
                    # place AND LISTED (delisting would hand its bytes to
                    # the next open's unlisted-dir sweep) — still loud
                    logger.errorf("partition %s: cannot quarantine part "
                                  "%s: %s", self.name, name, move_err)
                    self.quarantined.append(
                        {"store": "storage", "in": self.name, "part": name,
                         "path": p, "error": str(e)})
                    # open-phase (see above): pre-publication
                    self._keep_listed.append(name)  # vmt: disable=VMT015
                    _PARTS_OPEN_ERRORS.inc()
            except OSError as e:
                # transient open failure (fd exhaustion, permissions) is
                # NOT evidence of torn bytes: keep the part in place and
                # listed so a fixed environment serves it again, but
                # report it — the data is missing from results NOW, and
                # that must be loud, not silent
                logger.errorf("partition %s: cannot open part %s (kept "
                              "listed, serving partial): %s",
                              self.name, name, e)
                self.quarantined.append(
                    {"store": "storage", "in": self.name, "part": name,
                     "path": p, "error": str(e)})
                self._keep_listed.append(name)
                _PARTS_OPEN_ERRORS.inc()
        # remove crash leftovers: only dirs NOT listed in parts.json
        # (the quarantine dir is bookkeeping, never a leftover; ds_* tier
        # dirs carry their OWN manifest + sweep — see PartitionTier.open)
        for name in os.listdir(self.path):
            full = os.path.join(self.path, name)
            if name == "parts.json" or name == QUARANTINE_DIR or \
                    not os.path.isdir(full):
                continue
            if name.startswith(dslib.TIER_DIR_PREFIX):
                try:
                    res = int(name[len(dslib.TIER_DIR_PREFIX):])
                except ValueError:
                    shutil.rmtree(full, ignore_errors=True)
                    continue
                # open-phase (see above): pre-publication
                self._tiers[res] = dslib.PartitionTier.open(  # vmt: disable=VMT015
                    full, res, self.quarantined, self.name)
                continue
            if name not in listed:
                shutil.rmtree(full, ignore_errors=True)
        if self.quarantined:
            # drop MOVED names from the manifest (kept-in-place failures
            # stay listed via _keep_listed) so a later restart doesn't
            # re-sweep or re-report healed state
            self._write_parts_json_locked()
        if self._file_parts:
            seqs = [int(os.path.basename(p.path).split("_")[1])
                    for p in self._file_parts]
            # open-phase (see above): pre-publication, thread-local
            self._seq = itertools.count(max(seqs) + 1)  # vmt: disable=VMT015

    def close(self):
        with self._lock:
            for p in self._file_parts:
                p.close()
            self._file_parts = []
            for st in self._tiers.values():
                st.close()
            self._tiers = {}

    # -- writes ------------------------------------------------------------

    def add_rows(self, rows) -> None:
        """rows: list of (TSID, ts_ms, float_value)."""
        with self._lock:
            self._pending.extend(rows)
            self._pending_nrows += len(rows)
            spill = self._pending_nrows >= MAX_PENDING_ROWS
            if spill:
                self._cap_flush_locked()
        if spill:
            self._drain_inflight(keep=_MAX_INFLIGHT_PARTS)

    def add_rows_columnar(self, chunk: PendingChunk) -> None:
        """Columnar ingest: the whole batch parks as ONE pending element
        (no per-row tuples), counted by its row total."""
        with self._lock:
            self._pending.append(chunk)
            self._pending_nrows += len(chunk)
            spill = self._pending_nrows >= MAX_PENDING_ROWS
            if spill:
                self._cap_flush_locked()
        if spill:
            self._drain_inflight(keep=_MAX_INFLIGHT_PARTS)

    def _cap_flush_locked(self):
        """Pending hit the row cap: convert to an InmemoryPart.  With the
        sharded write path enabled the conversion (lexsort + decimal
        encode — GIL-releasing numpy) runs on the work pool while ingest
        continues; the conversion task lands its part into _mem_parts in
        SPILL ORDER itself (_convert_spill), so part contents equal the
        sequential path's byte for byte.  VM_INGEST_SHARDS=1 (or the
        deterministic scheduler) keeps today's inline conversion."""
        if not self._pending_inflight and \
                not workpool.ingest_parallel_enabled():
            self._flush_pending_locked()
            return
        # NOTE: with older spills still in flight the conversion must go
        # through the spill sequence even when the pool is now disabled
        # (submit executes inline then), or _mem_parts would be appended
        # out of ingest order
        rows, n = self._take_pending_locked()
        seq = self._spill_seq
        self._spill_seq += 1
        self._inflight_nrows += n
        from functools import partial
        self._pending_inflight.append(
            workpool.POOL.submit(partial(self._convert_spill, rows, n,
                                         seq)))

    def _convert_spill(self, rows, n, seq):
        """Pool task: convert one spilled pending batch and land every
        ready part into _mem_parts in spill order (out-of-order
        completions park in _spill_done until their turn).  On a
        conversion error the batch is dropped with consistent
        bookkeeping — the same outcome as a failed inline conversion,
        whose rows were already swapped out — and the error propagates
        to whoever waits on the Future (the flusher logs it)."""
        part = err = None
        try:
            part = _rows_to_inmemory_part(rows)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err = e
            _SPILL_ERRORS.inc()
            logger.errorf("partition %s: async pending conversion failed, "
                          "%d rows dropped: %s", self.name, n, e)
        with self._lock:
            self._spill_done[seq] = (part, n)
            while self._spill_next in self._spill_done:
                p, pn = self._spill_done.pop(self._spill_next)
                self._spill_next += 1
                self._inflight_nrows -= pn
                if self._pending_inflight:
                    self._pending_inflight.pop(0)
                if p is not None:
                    self._mem_parts.append(p)
        if err is not None:
            raise err
        return part

    def _drain_inflight(self, keep: int = 0) -> None:
        """Wait until at most `keep` conversions remain in flight (the
        tasks land their own parts; this only blocks on completion).
        keep=0 is the visibility barrier for queries/flushes; keep>0 is
        ingest backpressure.  Holds NO locks across the wait: the
        pool-helping wait may execute arbitrary queued tasks, including
        other partitions' flushes."""
        while True:
            with self._lock:
                if len(self._pending_inflight) <= keep:
                    return
                fut = self._pending_inflight[0]
            # multi-waiter safe (the completion token re-arms); when the
            # head future resolves its task has already landed the part
            # and popped itself, so the loop re-check makes progress
            try:
                # help-draining workpool future (bounded progress: the
                # waiter executes queued tasks, and conversion units are
                # small); the receiver comes out of a list so the taint
                # pass cannot resolve it to the workpool seam statically
                fut.result()  # vmt: disable=VMT012
            except Exception:  # vmt: disable=VMT003 — the failing task
                # already logged the error, counted it in
                # vm_ingest_spill_errors_total and dropped its batch with
                # consistent books; re-raising here would fail an
                # unrelated READER for an ingest-side error
                pass

    def _take_pending_locked(self):
        """Swap the pending rows out and invalidate the incremental
        query views; returns (rows, row_count)."""
        rows, self._pending = self._pending, []
        n = self._pending_nrows
        self._pending_nrows = 0
        self._pending_parts = []
        self._pending_off = 0
        self._pending_gen += 1
        return rows, n

    def _flush_pending_locked(self):
        if not self._pending:
            return
        rows, _ = self._take_pending_locked()
        self._mem_parts.append(_rows_to_inmemory_part(rows))

    def _pending_views(self):
        """InmemoryParts covering the current pending rows; only rows
        ingested since the last call are converted, and the conversion runs
        OUTSIDE the partition lock so concurrent add_rows never stalls
        behind it. Returns (views, generation): the caller re-checks the
        generation under the lock before combining with the part lists."""
        while True:
            with self._lock:
                gen = self._pending_gen
                off = self._pending_off
                n = len(self._pending)
                if off >= n:
                    return list(self._pending_parts), gen
                tail = list(self._pending[off:n])
            part = _rows_to_inmemory_part(tail)
            with self._lock:
                if self._pending_gen == gen and self._pending_off == off:
                    self._pending_parts.append(part)
                    self._pending_off = n
                # else: flushed (or another query converted) while we
                # worked — loop and re-snapshot

    def flush_pending(self):
        while True:
            self._drain_inflight()
            with self._lock:
                if not self._pending_inflight:
                    self._flush_pending_locked()
                    return
                # spilled between the drain and the lock: drain again so
                # _mem_parts keeps ingest order

    def flush_to_disk(self):
        """pending + in-memory parts -> one small file part (durable).

        The heavy encode+fsync runs OUTSIDE the partition data lock:
        ingest only pauses for the two brief list swaps, not the multi-
        second part write (the reference's background merger pool
        behavior, partition.go:663 — here the flusher thread is that
        pool, fanned across partitions by Table).  _flush_mutex
        serializes concurrent flushers/mergers per partition; the
        process-wide MERGE_GATE (VM_MERGE_WORKERS) bounds how many part
        writes run at once across all partitions and mergesets.

        In-flight async conversions are drained BEFORE taking
        _flush_mutex (never while holding it: the pool-helping wait may
        execute another partition's flush task, and flush-inside-drain
        plus drain-inside-flush would deadlock)."""
        while True:
            self._drain_inflight()
            if self._flush_to_disk_once():
                return

    def _flush_to_disk_once(self) -> bool:
        with self._flush_mutex:
            with self._lock:
                if self._pending_inflight:
                    return False  # spilled since the drain: retry
                self._flush_pending_locked()
                if not self._mem_parts:
                    return True
                mems = list(self._mem_parts)
            with workpool.MERGE_GATE:
                # timed inside the gate: the histograms mean pure write
                # time; queue wait is visible as vm_merge_pending
                t0 = time.perf_counter()
                p = self._write_part([m.iter_blocks() for m in mems])
                dt = time.perf_counter() - t0
            _FLUSH_DURATION.update(dt)
            _ING_FLUSH.inc(dt)
            flightrec.rec("flush:part", t0, dt, arg=self.name)
            with self._lock:
                if p is not None:
                    self._file_parts.append(p)
                    self._write_parts_json_locked()
                # drop exactly the flushed parts; newer mem parts appended
                # during the write stay (an ENOSPC abort keeps everything)
                flushed = {id(m) for m in mems}
                self._mem_parts = [m for m in self._mem_parts
                                   if id(m) not in flushed]
                merge_now = len(self._file_parts) > MAX_SMALL_PARTS
            if merge_now:
                self._merge_file_parts(self._file_parts)
            return True

    def _write_part(self, sources, deleted_ids=None, min_valid_ts=None):
        """Merge block streams into a new on-disk part (no data lock held;
        callers register the returned Part under the lock)."""
        name = f"p_{next(self._seq):016d}"
        w = PartWriter(os.path.join(self.path, name))
        wrote = False
        try:
            buf: list = []
            for b in _merge_block_streams(sources, deleted_ids, min_valid_ts,
                                          self.dedup_interval_ms):
                buf.append(b)
                if len(buf) >= _BULK_WRITE_BLOCKS:
                    w.write_blocks_bulk(buf)
                    wrote = True
                    buf = []
            if buf:
                w.write_blocks_bulk(buf)
                wrote = True
            if not wrote:
                w.abort()
                return None
            w.close()
        except BaseException:
            w.abort()
            raise
        # trusted: this process computed the checksums moments ago;
        # re-verifying would re-read the whole part per flush/merge
        return Part(os.path.join(self.path, name), trusted=True)

    def _merge_file_parts(self, parts, deleted_ids=None,
                          min_valid_ts=None):
        """Merge `parts` into one; the heavy merge runs outside the data
        lock (ingest and reads proceed), list swap + unlink under it."""
        with self._flush_mutex:
            with self._lock:
                olds = [p for p in parts if p in self._file_parts]
            if not olds:
                return
            _ACTIVE_MERGES.inc()
            try:
                with workpool.MERGE_GATE:
                    t0 = time.perf_counter()
                    merged = self._write_part(
                        [p.iter_blocks() for p in olds],
                        deleted_ids, min_valid_ts)
                    dt = time.perf_counter() - t0
                # counted only on success: an aborted merge (ENOSPC)
                # must not look like the compactor making progress
                _MERGE_DURATION.update(dt)
                _ING_MERGE.inc(dt)
                _MERGES_TOTAL.inc()
                flightrec.rec("merge:part", t0, dt, arg=self.name)
            finally:
                _ACTIVE_MERGES.dec()
            # the merged part dir is renamed into place but NOT yet in
            # parts.json: a crash here must recover to the OLD part set
            # (the unlisted merged dir is swept at reopen)
            faultinject.fire("merge:post_rename_pre_manifest")
            with self._lock:
                survivors = [p for p in self._file_parts if p not in olds]
                self._file_parts = survivors + (
                    [merged] if merged is not None else [])
                self._write_parts_json_locked()
            for old in olds:
                # Unlink only: concurrent readers may still iterate `old`;
                # open fds keep the data alive until the last reference
                # drops (the reference's part-refcount pattern, via GC).
                shutil.rmtree(old.path, ignore_errors=True)

    def force_merge(self, deleted_ids=None, min_valid_ts=None):
        """Merge everything into one part, applying tombstones/retention
        (the /internal/force_merge + final-dedup path)."""
        self.flush_to_disk()
        with self._flush_mutex:
            with self._lock:
                parts = list(self._file_parts)
            if parts:
                self._merge_file_parts(parts, deleted_ids, min_valid_ts)

    # -- downsampling (storage/downsample.py drives per-tier state) --------

    def run_downsample(self, tiers, deleted_ids=None, now_ms=None) -> int:
        """Re-rollup aged raw rows into coarser tier parts (the
        historicalMergeWatcher-shaped pass).  Consumes DURABLE file parts
        only — tier coverage must never run ahead of what raw has
        fsynced (callers flush first); the heavy merge+aggregate runs
        behind the process-wide MERGE_GATE so it defers to serving
        exactly like flush/merge.  Returns aggregated rows written."""
        from .table import _partition_bounds
        lo_p, hi_p = _partition_bounds(self.name)
        written = 0
        for tier in tiers:
            res = tier.resolution_ms
            # only COMPLETE buckets whose right edge has aged past the
            # tier offset (right-inclusive buckets: edge b*res covers
            # raw ts in ((b-1)*res, b*res])
            cutoff = ((now_ms - tier.offset_ms) // res) * res
            hi = min(cutoff, hi_p)
            with self._flush_mutex:
                with self._lock:
                    st = self._tiers.get(res)
                    covered = (st.covered_max_ts if st is not None
                               else -(1 << 62))
                    files = list(self._file_parts)
                lo = max(covered, lo_p - 1)
                if hi <= lo or not files:
                    continue
                if not any(p.min_ts <= hi and p.max_ts > lo
                           for p in files):
                    continue
                if st is None:
                    st = dslib.PartitionTier(
                        os.path.join(self.path,
                                     f"{dslib.TIER_DIR_PREFIX}{res}"), res)
                    os.makedirs(st.path, exist_ok=True)
                with workpool.MERGE_GATE:
                    t0 = time.perf_counter()
                    merged = _merge_block_streams(
                        [p.iter_blocks(min_ts=lo + 1, max_ts=hi)
                         for p in files],
                        deleted_ids, lo + 1, self.dedup_interval_ms)
                    _, rows_out, parts, names = dslib.rewrite_range(
                        st, merged, hi, res)
                    dt = time.perf_counter() - t0
                # tier part dirs are renamed into place but NOT yet in
                # tier.json: a crash here recovers to the OLD tier state
                # (the unlisted dirs are swept at reopen) — same seam
                # shape as merge:post_rename_pre_manifest
                faultinject.fire("downsample:post_rename_pre_manifest")
                with self._lock:
                    if names:
                        st.publish_parts(names, parts, hi)
                    else:
                        st.covered_max_ts = hi  # empty range: advance only
                    st.write_manifest()
                    self._tiers[res] = st
                dslib.note_pass(dt)
                flightrec.rec("downsample:part", t0, dt, arg=self.name)
                written += rows_out
        return written

    def tier_states(self) -> list:
        """Snapshot of open tiers (metrics/status; read-only)."""
        with self._lock:
            return list(self._tiers.values())

    def drop_raw_parts(self) -> int:
        """Raw retention expired while a downsampled tier still covers
        this partition: delist + delete every raw part (pending/mem rows
        included — they are older than raw retention too) and keep the
        tier dirs.  Returns 1 when anything was dropped."""
        self._drain_inflight()
        with self._flush_mutex:
            with self._lock:
                victims = self._file_parts
                had = bool(victims or self._mem_parts or self._pending)
                if not had:
                    return 0
                self._file_parts = []
                self._mem_parts = []
                self._take_pending_locked()
                self._write_parts_json_locked()
            for p in victims:
                # unlink only: concurrent readers holding the old Part
                # keep valid fds until the last reference drops
                shutil.rmtree(p.path, ignore_errors=True)
        return 1

    def drop_tier(self, resolution_ms: int) -> int:
        """Drop one tier past its own retention deadline."""
        with self._flush_mutex:
            with self._lock:
                st = self._tiers.pop(resolution_ms, None)
            if st is None:
                return 0
            st.close()
            shutil.rmtree(st.path, ignore_errors=True)
        return 1

    @property
    def has_tier_parts(self) -> bool:
        with self._lock:
            return any(st.has_parts for st in self._tiers.values())

    # -- reads -------------------------------------------------------------

    def iter_blocks(self, tsid_set=None, min_ts=None, max_ts=None,
                    tsid_lo=None, tsid_hi=None):
        """Blocks from all parts (NOT cross-part merged; the search layer
        merges rows per series)."""
        while True:
            self._drain_inflight()
            pend, gen = self._pending_views()
            with self._lock:
                if self._pending_gen == gen and not self._pending_inflight:
                    mems = list(self._mem_parts)
                    files = list(self._file_parts)
                    break
        mems = mems + pend
        for src in mems:
            yield from src.iter_blocks(tsid_set, min_ts, max_ts)
        for p in files:
            yield from p.iter_blocks(tsid_set, min_ts, max_ts,
                                     tsid_lo, tsid_hi)

    def collect_units(self, tsid_set=None, min_ts=None, max_ts=None,
                      tsid_lo=None, tsid_hi=None, mids_sorted=None,
                      as_float=False, ds=None, note=None):
        """Batched block collection, split into independent work units
        for the shared fetch pool (utils/workpool): returns a list of
        zero-arg callables, each yielding a list of (mids, cnts, scales,
        ts_concat, mant_concat) pieces.  Executing the units in ORDER and
        concatenating their outputs is bit-identical to the sequential
        collection — the pool preserves submit order, so parallel and
        sequential fetches return the same bytes.

        With ``as_float=True`` (the VM_NATIVE_ASSEMBLE fused read path)
        every unit instead yields FLOAT pieces (mids, cnts, ts_concat,
        vals_f64): file parts run the one-call native fetch→decode→clip→
        float kernel (Part.assemble_columns), and the in-memory /
        fallback sub-paths convert their mantissa pieces per block so the
        bytes match the split path exactly.

        Unit granularity: all in-memory parts form ONE unit (masked
        columnar views, pure numpy — cheap); each file part is its own
        unit (zstd + native decode release the GIL, so units genuinely
        overlap on workers).  Snapshotting the part lists (and converting
        pending rows) happens HERE on the calling thread, under the
        partition lock discipline; the returned closures touch only
        immutable parts.

        ``ds`` = ``(agg_column, max_resolution_ms)`` opts the fetch into
        downsampled tiers, CASCADING coarsest-to-finest: the coarsest
        tier whose resolution satisfies the bound serves up to its
        coverage watermark, each finer satisfying tier serves the span
        between the previous watermark and its own, and raw parts serve
        only past the finest contributing watermark.  Without any
        satisfying tier, a partition whose raw parts were dropped by
        retention falls back to the FINEST surviving tier (``last``
        column unless ``ds`` names one) and flags the result partial-
        resolution via ``note`` — loudly degraded, never silently wrong.
        ``note`` (dict) reports the choice: ``ds_res`` (max resolution
        actually served) and ``partial_res``."""
        while True:
            self._drain_inflight()
            pend, gen = self._pending_views()
            with self._lock:
                if self._pending_gen == gen and not self._pending_inflight:
                    mems = list(self._mem_parts)
                    files = list(self._file_parts)
                    tier_snap = [(st, st.covered_max_ts)
                                 for st in self._tiers.values()
                                 if st.has_parts]
                    break
        mems = mems + pend
        if mids_sorted is None and tsid_set is not None:
            mids_sorted = np.fromiter(tsid_set, np.int64, len(tsid_set))
            mids_sorted.sort()
        lo = -(1 << 62) if min_ts is None else min_ts
        hi = (1 << 62) if max_ts is None else max_ts
        from .part import _piece_to_float, clip_piece
        units = []

        # -- tier selection (see docstring) --------------------------------
        # chosen tier SEGMENTS, coarsest first: each (tier, seg_lo,
        # seg_hi) serves a disjoint span, the next finer tier picks up
        # at the previous watermark + 1, raw serves only past the FINEST
        # contributing watermark — a long-range query cascades
        # 1h-tier -> 5m-tier -> raw instead of paying raw for everything
        # the coarsest tier has not yet covered.
        chosen: list = []
        raw_lo = min_ts
        # COUNT-hinted fetch: raw samples contribute 1 each (see
        # downsample.count_tail_piece) — unconditional on whether a tier
        # serves, so the eval-level count->sum rewrite is always sound
        count_ones = (note is not None and ds is not None
                      and ds[0] == "count")
        # a note dict is the enable switch: Storage only passes one when
        # tiers are configured AND VM_DOWNSAMPLE_READ is on
        if tier_snap and note is not None:
            agg = ds[0] if ds is not None else "last"
            if ds is not None:
                cands = [(st, c) for st, c in tier_snap
                         if st.resolution_ms <= ds[1]]
                cands.sort(key=lambda tc: -tc[0].resolution_ms)
                cur_lo, cur_lo_i = min_ts, lo
                for st, c in cands:
                    if c < cur_lo_i:
                        continue  # extends nothing the cascade has
                    chosen.append((st, cur_lo, min(hi, c)))
                    cur_lo = cur_lo_i = c + 1
                    if c >= hi:
                        break
                if chosen:
                    raw_lo = cur_lo
            if not chosen and not mems and not files:
                # raw dropped by retention, no satisfying tier: finest
                # surviving tier, LOUDLY partial-resolution
                cands = [(st, c) for st, c in tier_snap if c >= lo]
                if cands:
                    st, c = min(cands,
                                key=lambda tc: tc[0].resolution_ms)
                    chosen = [(st, min_ts, min(hi, c))]
                    raw_lo = c + 1
                    note["partial_res"] = True
            if chosen:
                # coarsest resolution actually served
                note["ds_res"] = max(note.get("ds_res", 0),
                                     chosen[0][0].resolution_ms)
        raw_lo_i = -(1 << 62) if raw_lo is None else raw_lo

        mems = [src for src in mems
                if src.max_ts >= raw_lo_i and src.min_ts <= hi]
        if mems:
            def mem_unit(mems=mems, u_lo=raw_lo):
                pieces = []
                for src in mems:
                    piece = src.collect_columns(mids_sorted, u_lo, max_ts)
                    if piece is not None:
                        piece = clip_piece(*piece, u_lo, max_ts)
                        piece = (_piece_to_float(piece) if as_float
                                 else piece)
                        if count_ones:
                            piece = dslib.count_tail_piece(piece, as_float)
                        pieces.append(piece)
                return pieces
            units.append(mem_unit)
        for p, u_lo, u_hi, is_raw in (
                [(p, raw_lo, max_ts, True) for p in files] +
                [(p, s_lo, s_hi, False)
                 for st, s_lo, s_hi in chosen
                 for p in st.parts_for(agg)]):
            u_lo_i = -(1 << 62) if u_lo is None else u_lo
            u_hi_i = (1 << 62) if u_hi is None else u_hi
            if p.max_ts < u_lo_i or p.min_ts > u_hi_i:
                continue
            ones = count_ones and is_raw

            def file_unit(p=p, u_lo=u_lo, u_hi=u_hi, ones=ones):
                if as_float:
                    piece = p.assemble_columns(mids_sorted, u_lo, u_hi)
                else:
                    piece = p.collect_columns(mids_sorted, u_lo, u_hi)
                if piece is False:
                    return []  # vectorized path ran; nothing matched
                if piece is not None:  # already row-clipped
                    return [dslib.count_tail_piece(piece, as_float)
                            if ones else piece]
                # fallback: native decode unavailable — per-header path
                hdrs = list(p.iter_headers(tsid_set, u_lo, u_hi,
                                           tsid_lo, tsid_hi))
                if not hdrs:
                    return []
                K = len(hdrs)
                ts_c, m_c = p.read_blocks_columns(hdrs)
                piece = clip_piece(
                    np.fromiter((h.tsid.metric_id for h in hdrs),
                                np.int64, K),
                    np.fromiter((h.rows for h in hdrs), np.int64, K),
                    np.fromiter((h.scale for h in hdrs), np.int64, K),
                    ts_c, m_c, u_lo, u_hi)
                piece = _piece_to_float(piece) if as_float else piece
                return [dslib.count_tail_piece(piece, as_float)
                        if ones else piece]
            units.append(file_unit)
        return units

    def collect_columns(self, tsid_set=None, min_ts=None, max_ts=None,
                        tsid_lo=None, tsid_hi=None, mids_sorted=None,
                        as_float=False, ds=None, note=None):
        """Batched block collection: returns (mids, cnts, scales, ts_concat,
        mant_concat) numpy arrays over every matching block in this
        partition (float pieces under ``as_float`` — see collect_units).
        File parts decode ALL their matched blocks in one native
        call (part.read_blocks_columns); in-memory parts are masked
        columnar views with zero per-block Python.  (Sequential execution
        of collect_units; Table.collect_columns fans the same units across
        the shared work pool.)"""
        return [piece
                for unit in self.collect_units(tsid_set, min_ts, max_ts,
                                               tsid_lo, tsid_hi, mids_sorted,
                                               as_float, ds, note)
                for piece in unit()]

    @property
    def rows(self) -> int:
        with self._lock:
            return (self._pending_nrows + self._inflight_nrows
                    + sum(m.rows for m in self._mem_parts)
                    + sum(p.rows for p in self._file_parts))

    # -- live resharding (part migration) ----------------------------------

    def list_file_parts(self) -> list[dict]:
        """Finalized on-disk parts: migration inventory rows
        ``{part, rows, bytes, min_ts, max_ts}``."""
        with self._lock:
            parts = list(self._file_parts)
        return [{"part": os.path.basename(p.path), "rows": int(p.rows),
                 "bytes": p.file_bytes(), "min_ts": int(p.min_ts),
                 "max_ts": int(p.max_ts)} for p in parts]

    def get_file_part(self, name: str):
        """The open Part for one finalized part name (None when merged
        away/removed since listing — callers re-list and retry)."""
        with self._lock:
            for p in self._file_parts:
                if os.path.basename(p.path) == name:
                    return p
        return None

    def stage_part(self, files: list[tuple[str, bytes]]) -> str:
        """First half of adopting a part shipped from another node:
        write the files to a fresh local ``<name>.tmp`` dir, fsync, and
        VERIFY the recorded crc32s against the transferred bytes (the
        PR-10 integrity gate — a torn transfer is rejected here, before
        the caller commits ANY other state for the part, e.g. series
        registrations).  Returns the reserved part name; a crash leaves
        only a ``.tmp`` dir the next open sweeps."""
        for fname, _ in files:
            if os.sep in fname or fname != os.path.basename(fname) or \
                    fname.startswith("."):
                raise ValueError(f"bad part file name {fname!r}")
        with self._lock:
            name = f"p_{next(self._seq):016d}"
        tmp = os.path.join(self.path, name) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        try:
            for fname, data in files:
                fp = os.path.join(tmp, fname)
                with open(fp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            meta = fslib.load_meta_json(os.path.join(tmp, "metadata.json"))
            fslib.verify_checksums(tmp, meta)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return name

    def discard_staged(self, name: str) -> None:
        shutil.rmtree(os.path.join(self.path, name) + ".tmp",
                      ignore_errors=True)

    def publish_staged(self, name: str):
        """Second half: durably publish a verified staged part and
        register it in parts.json.  Returns the opened Part."""
        final = os.path.join(self.path, name)
        faultinject.fire("migrate:pre_publish")
        fslib.rename_durable(final + ".tmp", final)
        p = Part(final, trusted=True)  # checksums verified at staging
        with self._lock:
            self._file_parts.append(p)
            self._write_parts_json_locked()
        return p

    def adopt_part(self, files: list[tuple[str, bytes]]):
        """stage_part + publish_staged in one step (callers with no
        interleaved state to commit)."""
        return self.publish_staged(self.stage_part(files))

    def remove_parts(self, names: list[str]) -> int:
        """Delist + delete finalized parts (the source side of a part
        migration, after the receiver's durable ack).  Parts merged
        away since listing count as already gone.  Unlink only:
        concurrent readers holding the old Part keep valid fds until
        the last reference drops."""
        wanted = set(names)
        with self._flush_mutex:
            with self._lock:
                victims = [p for p in self._file_parts
                           if os.path.basename(p.path) in wanted]
                if victims:
                    self._file_parts = [p for p in self._file_parts
                                        if p not in victims]
                    self._write_parts_json_locked()
            for p in victims:
                shutil.rmtree(p.path, ignore_errors=True)
        return len(victims)

    # -- snapshots ---------------------------------------------------------

    def snapshot_to(self, dst: str):
        """Hardlink immutable parts (MustCreateSnapshotAt analog,
        partition.go:1992). Flush first so RAM state is included."""
        self.flush_to_disk()
        os.makedirs(dst, exist_ok=True)
        with self._lock:
            for p in self._file_parts:
                name = os.path.basename(p.path)
                pdst = os.path.join(dst, name)
                os.makedirs(pdst, exist_ok=True)
                for fn in os.listdir(p.path):
                    os.link(os.path.join(p.path, fn), os.path.join(pdst, fn))
            names = [os.path.basename(p.path) for p in self._file_parts]
        with open(os.path.join(dst, "parts.json"), "w") as f:
            json.dump({"parts": names}, f)
            f.flush()
            os.fsync(f.fileno())
        fslib.fsync_dir(dst)
