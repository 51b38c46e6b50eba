"""Table: monthly partitions + retention (reference lib/storage/table.go:27,
retentionWatcher table.go:428).

The port's copy of ``victoriametrics_tpu/storage/table.py``, whole.
"""

from __future__ import annotations

import datetime
import os
import shutil
import numpy as np

from ..devtools.locktrace import make_rlock
from ..devtools.racetrace import traced_fields
from ..utils import flightrec, logger
from .partition import Partition


def partition_name_for_ts(ts_ms: int) -> str:
    d = datetime.datetime.fromtimestamp(ts_ms / 1e3, tz=datetime.timezone.utc)
    return f"{d.year:04d}_{d.month:02d}"


def _partition_bounds(name: str) -> tuple[int, int]:
    y, m = int(name[:4]), int(name[5:7])
    start = datetime.datetime(y, m, 1, tzinfo=datetime.timezone.utc)
    end = (datetime.datetime(y + 1, 1, 1, tzinfo=datetime.timezone.utc)
           if m == 12 else
           datetime.datetime(y, m + 1, 1, tzinfo=datetime.timezone.utc))
    return int(start.timestamp() * 1e3), int(end.timestamp() * 1e3) - 1


@traced_fields("_partitions", "_day_to_partition")
class Table:
    def __init__(self, path: str, dedup_interval_ms: int = 0):
        self.path = path
        self.dedup_interval_ms = dedup_interval_ms
        self._lock = make_rlock("storage.Table._lock")
        self._partitions: dict[str, Partition] = {}
        self._day_to_partition: dict[int, str] = {}
        os.makedirs(path, exist_ok=True)
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            if os.path.isdir(full) and len(name) == 7 and name[4] == "_":
                self._partitions[name] = Partition(full, name,
                                                   dedup_interval_ms)

    def close(self):
        with self._lock:
            for p in self._partitions.values():
                p.close()
            self._partitions.clear()

    def partition_for_ts(self, ts_ms: int) -> Partition:
        name = partition_name_for_ts(ts_ms)
        with self._lock:
            p = self._partitions.get(name)
            if p is None:
                p = Partition(os.path.join(self.path, name), name,
                              self.dedup_interval_ms)
                self._partitions[name] = p
            return p

    def add_rows(self, rows) -> None:
        """rows: [(TSID, ts_ms, float)] — routed to monthly partitions
        (MustAddRows, table.go:300). Day->name memo avoids a datetime
        conversion per row."""
        day_names = self._day_to_partition
        by_part: dict[str, list] = {}
        for r in rows:
            day = r[1] // 86_400_000
            name = day_names.get(day)
            if name is None:
                name = partition_name_for_ts(r[1])
                if len(day_names) > 4096:
                    day_names.clear()
                day_names[day] = name
            by_part.setdefault(name, []).append(r)
        for name, rs in by_part.items():
            self.partition_for_ts(rs[0][1]).add_rows(rs)

    def add_rows_columnar(self, space, ids, tss, vals) -> None:
        """Columnar batch -> monthly partitions. The common case (whole
        batch inside one month) routes with two scalar checks; straddling
        batches split by partition name over the distinct days."""
        from .partition import PendingChunk
        n = int(ids.size)
        if n == 0:
            return
        t_lo = int(tss.min())
        t_hi = int(tss.max())
        lo_name = partition_name_for_ts(t_lo)
        if partition_name_for_ts(t_hi) == lo_name:
            self.partition_for_ts(t_lo).add_rows_columnar(
                PendingChunk(space, ids, tss, vals))
            return
        days = tss // 86_400_000
        by_name: dict[str, list[int]] = {}
        for d in np.unique(days):
            by_name.setdefault(
                partition_name_for_ts(int(d) * 86_400_000), []).append(int(d))
        for name, ds in by_name.items():
            mask = np.isin(days, ds)
            self.partition_for_ts(int(ds[0]) * 86_400_000).add_rows_columnar(
                PendingChunk(space, ids[mask], tss[mask], vals[mask]))

    def partitions_for_range(self, min_ts: int, max_ts: int) -> list[Partition]:
        with self._lock:
            out = []
            for name, p in sorted(self._partitions.items()):
                lo, hi = _partition_bounds(name)
                if hi >= min_ts and lo <= max_ts:
                    out.append(p)
            return out

    def iter_blocks(self, tsid_set=None, min_ts=None, max_ts=None,
                    tsid_lo=None, tsid_hi=None):
        parts = (self.partitions_for_range(min_ts if min_ts is not None else -(1 << 62),
                                           max_ts if max_ts is not None else 1 << 62))
        for p in parts:
            yield from p.iter_blocks(tsid_set, min_ts, max_ts,
                                     tsid_lo, tsid_hi)

    def collect_columns(self, tsid_set=None, min_ts=None, max_ts=None,
                        tsid_lo=None, tsid_hi=None, mids_sorted=None,
                        as_float=False, check=None, ds=None, note=None):
        """Batched per-partition block collection (see
        Partition.collect_units); returns a flat list of pieces —
        mantissa 5-tuples, or float 4-tuples under ``as_float`` (the
        VM_NATIVE_ASSEMBLE fused kernel).

        ``check`` (optional zero-arg callable, the storage-side deadline
        budget) runs before each fetch unit: an expired query aborts
        between part decodes instead of fetching every remaining part
        for a dead caller (the exception propagates through the pool).

        The per-partition/per-part units fan across the shared work pool
        (utils/workpool — the netstorage unpack-worker role): the fused
        kernel / zstd + native decode release the GIL, so a cold
        multi-part fetch scales with cores.  The pool returns unit
        results in submit order, so the flattened piece list is
        bit-identical to sequential collection; VM_SEARCH_WORKERS=1 runs
        the exact sequential path."""
        parts = self.partitions_for_range(
            min_ts if min_ts is not None else -(1 << 62),
            max_ts if max_ts is not None else 1 << 62)
        if mids_sorted is None and tsid_set is not None:
            mids_sorted = np.fromiter(tsid_set, np.int64, len(tsid_set))
            mids_sorted.sort()
        units = []
        for p in parts:
            units.extend(p.collect_units(tsid_set, min_ts, max_ts,
                                         tsid_lo, tsid_hi, mids_sorted,
                                         as_float, ds, note))
        if check is not None:
            units = [(lambda u=u: (check(), u())[1]) for u in units]
        from ..utils import workpool
        return [piece for pieces in workpool.POOL.run(units)
                for piece in pieces]

    def enforce_retention(self, min_valid_ts: int,
                          tier_deadlines=None) -> int:
        """Drop data older than retention, PER TIER (retentionWatcher
        analog).  ``tier_deadlines`` is ``[(resolution_ms, tier_min_ts)]``
        with ``tier_min_ts=None`` meaning "keep forever".  A partition dir
        is removed whole only once EVERY tier (and raw) has expired;
        partitions past the raw deadline but inside a tier deadline lose
        only their raw parts, and each tier is dropped at its own
        deadline.  Returns the number of drop actions."""
        dropped = 0
        deadlines = list(tier_deadlines or ())
        full_drop_before = min_valid_ts
        for _, d in deadlines:
            if d is None:
                full_drop_before = None
                break
            full_drop_before = min(full_drop_before, d)
        with self._lock:
            items = list(self._partitions.items())
        for name, p in items:
            _, hi = _partition_bounds(name)
            if full_drop_before is not None and hi < full_drop_before:
                with self._lock:
                    p = self._partitions.pop(name, None)
                if p is None:
                    continue
                p.close()
                shutil.rmtree(p.path, ignore_errors=True)
                logger.infof("table: dropped partition %s (retention)",
                             name)
                dropped += 1
                continue
            if hi < min_valid_ts and deadlines:
                if p.drop_raw_parts():
                    logger.infof("table: dropped raw parts of %s "
                                 "(raw retention; tiers kept)", name)
                    dropped += 1
            for res, d in deadlines:
                if d is not None and hi < d and p.drop_tier(res):
                    logger.infof("table: dropped tier ds_%d of %s "
                                 "(tier retention)", res, name)
                    dropped += 1
        return dropped

    def run_downsample(self, tiers, deleted_ids=None,
                       now_ms=None) -> int:
        """One downsampling cycle across every partition (see
        Partition.run_downsample); returns aggregated rows written."""
        with self._lock:
            parts = list(self._partitions.values())
        written = 0
        with flightrec.span("downsample:table", arg=len(parts)):
            for p in parts:
                written += p.run_downsample(tiers, deleted_ids, now_ms)
        return written

    @staticmethod
    def _fan_partitions(parts, fn):
        """Run fn(partition) for every partition — across the shared
        work pool when the sharded write path is on and several
        partitions exist (flush/merge of different months are
        independent; the MERGE_GATE inside each bounds total disk
        concurrency at VM_MERGE_WORKERS).  Callers hold NO locks here,
        so the pool-helping wait is safe."""
        from ..utils import workpool
        if len(parts) > 1 and workpool.ingest_parallel_enabled():
            from functools import partial
            workpool.POOL.run([partial(fn, p) for p in parts])
        else:
            for p in parts:
                fn(p)

    def flush_pending(self):
        with self._lock:
            parts = list(self._partitions.values())
        self._fan_partitions(parts, lambda p: p.flush_pending())

    def flush_to_disk(self):
        with self._lock:
            parts = list(self._partitions.values())
        # the fan span shows the WHOLE flush window on the flight
        # timeline (per-partition flush:part spans nest inside it on
        # whichever threads the pool ran them)
        with flightrec.span("flush:table", arg=len(parts)):
            self._fan_partitions(parts, lambda p: p.flush_to_disk())

    def force_merge(self, deleted_ids=None, min_valid_ts=None):
        with self._lock:
            parts = list(self._partitions.values())
        with flightrec.span("merge:table", arg=len(parts)):
            self._fan_partitions(
                parts, lambda p: p.force_merge(deleted_ids, min_valid_ts))

    def snapshot_to(self, dst: str):
        os.makedirs(dst, exist_ok=True)
        with self._lock:
            parts = list(self._partitions.values())
        for p in parts:
            p.snapshot_to(os.path.join(dst, p.name))

    # -- live resharding (part migration) ----------------------------------

    def list_file_parts(self) -> list[dict]:
        """Migration inventory across every partition:
        ``{partition, part, rows, bytes, min_ts, max_ts}`` rows."""
        with self._lock:
            parts = list(self._partitions.items())
        out = []
        for name, p in sorted(parts):
            for row in p.list_file_parts():
                out.append(dict(row, partition=name))
        return out

    @staticmethod
    def is_partition_name(name: str) -> bool:
        """Strictly YYYY_MM — the form partition_name_for_ts emits.
        Anything else (in particular path-traversal bytes arriving in
        a migratePart_v1 partition field) is rejected."""
        return (len(name) == 7 and name[4] == "_" and
                name[:4].isdigit() and name[5:7].isdigit())

    def partition_by_name(self, name: str, create: bool = False):
        """Partition lookup by month name (adoption targets use
        create=True — the receiving node may not have the month yet).
        Non-YYYY_MM names never create (and never resolve) a
        partition: the name may come off the wire."""
        if not self.is_partition_name(name):
            return None
        with self._lock:
            p = self._partitions.get(name)
            if p is None and create:
                p = Partition(os.path.join(self.path, name), name,
                              self.dedup_interval_ms)
                self._partitions[name] = p
            return p

    def quarantined(self) -> list[dict]:
        """Open-time integrity quarantines across every partition (the
        loud replacement for silently dropping unopenable parts)."""
        with self._lock:
            parts = list(self._partitions.values())
        return [q for p in parts for q in p.quarantined]

    @property
    def rows(self) -> int:
        with self._lock:
            return sum(p.rows for p in self._partitions.values())

    @property
    def partition_names(self) -> list[str]:
        with self._lock:
            return sorted(self._partitions)
